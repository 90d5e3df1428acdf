"""PyTorch/CUDA port of the NAND-PIM serving system.

The package mirrors ``src/repro``'s module names so each counterpart is easy
to find, but imports neither JAX nor the JAX package.  Entry points run on
the CUDA card unless the caller passes ``device="cpu"``; on CPU tensors every
hand-written kernel is replaced by its plain PyTorch version, on CUDA tensors
the kernel launches (or the call raises).
"""
