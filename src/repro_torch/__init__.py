"""PyTorch/CUDA port of the co-execution engine in ``repro``.

Module paths and public names follow the JAX package, so each counterpart
sits at the same relative path.  The package imports ``torch`` and never
``jax`` nor ``repro``; its kernels are hand-written CUDA for Hopper
(``csrc/``), built at first use.  Entry points run on the card unless the
caller asks for the CPU (``device="cpu"``).
"""
