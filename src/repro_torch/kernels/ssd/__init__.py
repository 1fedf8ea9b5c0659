"""Mamba-2 SSD intra-chunk kernels: ``ops`` holds the CUDA kernels'
wrappers (source in ``csrc/``) beside their plain PyTorch versions."""
