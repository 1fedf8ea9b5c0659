"""RG-LRU linear-recurrence kernels: ``ops`` holds the CUDA kernels'
wrappers (source in ``csrc/``) beside their plain PyTorch versions."""
