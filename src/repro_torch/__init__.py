"""PyTorch + CUDA port of the FL client selection and scheduling
service (arXiv 2312.14941).

Mirrors the JAX package's layout (``core``, ``data``, ``fl``,
``kernels``, ``models``, ``optim``) module for module. It imports torch
and numpy and never the JAX package: host-side numpy modules are kept
as copies of their own.
"""
