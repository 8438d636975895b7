"""B⊕LD on PyTorch and CUDA: the port of the JAX package ``repro``.

Subpackages mirror the reference's module names (``configs``, ``core``,
``kernels``, ``models``, ``serve``); ``bridge`` takes the reference's
parameter trees as numpy arrays. The port imports torch, numpy and the
standard library only — never ``jax`` or ``repro``.
"""
