"""PyTorch/CUDA port of the DyDD + DD-KF assimilation system.

Mirrors the layout of the JAX package ``repro`` (``core/``, ``kernels/``,
``assim/``, ``obs/``, ``data/``, ``runtime/``) so each module's
counterpart is easy to find; imports ``torch``, numpy and the standard
library only.  The TPU Pallas kernels on the DD-KF path are CUDA C++
kernels for Hopper under ``kernels/csrc``.
"""
