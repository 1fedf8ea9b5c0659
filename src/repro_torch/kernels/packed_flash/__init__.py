"""Packed-flash attention kernels: ``ops`` holds each CUDA kernel's wrapper
(sources in ``csrc/``) beside its plain PyTorch version."""
