"""Flat Euclidean manifold of (p, n) matrices (PyTorch port of
manisdp_tpu/manifolds/euclidean.py; Manopt's ``euclideanfactory``).

Used by the general primal driver.  ``typicaldist`` depends on the
ACTIVE dimension n * p, so it takes the active rank.
"""

from __future__ import annotations

import math

import torch

from .base import frob_inner, frob_norm


class Euclidean:
    name = "euclidean"

    inner = staticmethod(frob_inner)
    norm = staticmethod(frob_norm)

    @staticmethod
    def proj(x, u):
        return u

    tangent = proj

    @staticmethod
    def transp(x1, x2, d):
        return d

    @staticmethod
    def retr(x, d):
        return x + d

    @staticmethod
    def zerovec(x):
        return torch.zeros_like(x)

    @staticmethod
    def typicaldist(p, n):
        # sqrt(n*p) with the ACTIVE rank (euclideanfactory.m:57)
        return math.sqrt(float(p) * n)

    @staticmethod
    def rand(gen: torch.Generator, p, n, p_pad=None, dtype=torch.float64):
        """Gaussian point on ``gen``'s device, zero-padded to p_pad
        rows."""
        p_pad = p if p_pad is None else p_pad
        y = torch.randn((p, n), generator=gen, dtype=dtype,
                        device=gen.device)
        if p_pad > p:
            y = torch.cat([y, torch.zeros((p_pad - p, n), dtype=dtype,
                                          device=gen.device)])
        return y

    @staticmethod
    def renormalize(y):
        return y
