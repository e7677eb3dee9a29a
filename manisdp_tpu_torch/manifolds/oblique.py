"""Oblique manifold in transposed (p, n) layout: unit-norm columns
(PyTorch port of manisdp_tpu/manifolds/oblique.py).

The column ops go through kernel K2 (``kernels.oblique_cols``) on CUDA
tensors and through its plain twin on CPU tensors.  Zero padding rows
are preserved by every op.  A (B, p, n) stack is B points of the batched
MaxCut driver: the column ops take it in one launch, and ``inner`` /
``norm`` return one value per point (the last two axes are summed).
"""

from __future__ import annotations

import math

import torch

from ..kernels import oblique_cols


class Oblique:
    name = "oblique"

    @staticmethod
    def inner(x, u, v):
        return torch.sum(u * v, dim=(-2, -1))

    @staticmethod
    def norm(x, u):
        return torch.sqrt(torch.sum(u * u, dim=(-2, -1)))

    @staticmethod
    def proj(x, u):
        # U - X .* sum(X .* U) columnwise
        return oblique_cols(x, u, "proj")

    tangent = proj

    @staticmethod
    def tangent_cols(x):
        """The tangent map is K2's column projection with no column mask
        (so the tCG's vector step, K11, applies it itself)."""
        return None

    @staticmethod
    def transp(x1, x2, d):
        return oblique_cols(x2, d, "proj")

    @staticmethod
    def retr(x, d):
        # metric-projection retraction: column-normalize x + d
        return oblique_cols(x, d, "retr")

    @staticmethod
    def zerovec(x):
        return torch.zeros_like(x)

    @staticmethod
    def typicaldist(p, n):
        # pi * sqrt(n), independent of rank
        return math.pi * math.sqrt(float(n))

    @staticmethod
    def rand(gen: torch.Generator, p, n, p_pad=None, dtype=torch.float64):
        """Column-normalized Gaussian point on ``gen``'s device,
        zero-padded to p_pad rows."""
        p_pad = p if p_pad is None else p_pad
        y = torch.randn((p, n), generator=gen, dtype=dtype,
                        device=gen.device)
        y = oblique_cols(y, None, "renormalize")
        if p_pad > p:
            y = torch.cat([y, torch.zeros((p_pad - p, n), dtype=dtype,
                                          device=gen.device)])
        return y

    @staticmethod
    def renormalize(y):
        """Project a (possibly padded) factor back onto the manifold."""
        return oblique_cols(y.contiguous(), None, "renormalize")
