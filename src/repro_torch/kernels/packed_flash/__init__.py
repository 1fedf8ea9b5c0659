"""Packed-flash attention kernels.  This slice ports the serving one:
``ops.ragged_decode_attention`` (CUDA kernel ``csrc/ragged_decode.cu``)."""
