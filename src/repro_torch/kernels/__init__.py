"""Hand-written Hopper kernels, each beside its plain PyTorch version.
``build`` compiles a CUDA source at first use."""
