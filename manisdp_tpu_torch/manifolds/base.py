"""Manifold helpers for the RTR core (PyTorch port of
manisdp_tpu/manifolds/base.py).

A manifold is a namespace of plain functions on a factor ``Y`` of shape
``(p_pad, n)``; rank padding rows are zero and every operation maps zero
rows to zero rows.
"""

from __future__ import annotations

from typing import Protocol

import torch


class Manifold(Protocol):
    """Static-method protocol of the manifolds (Oblique, Sphere,
    Euclidean) on tensors; implementations are plain classes."""

    @staticmethod
    def inner(x, u, v): ...

    @staticmethod
    def norm(x, u): ...

    @staticmethod
    def proj(x, u): ...

    @staticmethod
    def retr(x, u): ...

    @staticmethod
    def zerovec(x): ...

    @staticmethod
    def typicaldist(p, n): ...


def frob_inner(x, u, v):
    """Ambient Frobenius metric; the point x is unused but kept for the
    uniform Manopt-style (x, u, v) signature.  Returns a 0-d tensor."""
    return torch.sum(u * v)


def frob_norm(x, u):
    return torch.sqrt(torch.sum(u * u))
