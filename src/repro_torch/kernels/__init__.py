"""Kernel suite: per benchmark a plain PyTorch version (``ref.py``), the
wrapper of its hand-written CUDA kernel with a launch counter
(``kernel.py``) and the range-partitionable co-execution entry
(``ops.py``).  The tensor's device picks the path: a CUDA tensor launches
the kernel or raises, a CPU tensor takes the plain version.  Ray has no
kernel on either device (the JAX package has no Pallas kernel for it):
its ``ops.py`` renders with the plain version, in bands of rows."""
