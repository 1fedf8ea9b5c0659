"""PyTorch/CUDA port of the DistCA reproduction, beside the JAX package
``repro`` that it is tested against.

This slice ports the serving path: configs, the dense decoder with the
ragged serving cache, the continuous-batching scheduler and engine, the
HTTP daemon, and the ragged cache-attention kernel hand-written in CUDA
for Hopper.  The package imports torch, numpy and the standard library,
never ``jax`` and never ``repro``.  Entry points run on the card unless the
caller asks for ``device="cpu"``.
"""
