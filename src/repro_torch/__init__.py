"""PyTorch/CUDA port of the JAX package ``repro``, for one NVIDIA H100.

It imports ``torch`` and never ``jax``, and nothing of ``repro``: what it
needs of the JAX package it keeps as its own copy.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; on the CPU every kernel
wrapper computes its plain PyTorch version.
"""
