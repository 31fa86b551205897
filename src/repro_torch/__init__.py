"""Rateless IBLT on PyTorch and CUDA — a port of the ``repro`` package.

The layout mirrors ``repro`` module for module (``core/``, ``kernels/``,
``protocol/``), so each ported file has its reference at the same path
under ``src/repro``.  This package imports torch and numpy, never JAX and
nothing of ``repro``; only the tests import both.
"""
