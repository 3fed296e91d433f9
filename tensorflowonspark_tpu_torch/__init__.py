"""PyTorch/CUDA port of the JAX/TPU package for NVIDIA Hopper.

The JAX package beside this one is the reference; this package mirrors
its module names (``models/transformer.py``, ``ops/paged_attention.py``,
``serving.py``, ...) so each port module has an obvious counterpart.
It imports ``torch`` and never JAX, Flax or the JAX package; host-side
helpers it needs from there (the page allocator, the engine's request
bookkeeping) are kept as its own copies.

Importing the package is light: no CUDA initialisation and no kernel
build happen here.  Kernels are compiled with ``nvcc`` on first use
(:mod:`.ops._build`).  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``, and raise when no GPU is present.
"""
