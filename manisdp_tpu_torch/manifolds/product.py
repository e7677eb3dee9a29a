"""Masked product manifold: the multiblock geometry (PyTorch port of
manisdp_tpu/manifolds/product.py).

The reference's ``multiblockmanifold`` holds a cell array of per-block
factors, the first ``nob`` on oblique manifolds (unit columns) and the rest
Euclidean.  Here the product is ONE flat factor Y of shape (p_max, N),
N = sum n_i, whose column groups are the blocks (each zero-padded below
its active rank).  Every operation of the product is column-local, so it
reduces to masked column ops with mask[j] = 1 on oblique columns:

    proj(Y, U) = U - Y * (colsum(Y*U) * mask)
    retr(Y, D) = (Y+D) / where(mask, colnorm(Y+D), 1)

which is kernel K2 (``kernels.oblique_cols``) with its column mask on CUDA
tensors, and its plain twin on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import oblique_cols
from .base import frob_inner, frob_norm


class MaskedProduct:
    """Instance-based manifold; ``mask`` is an (N,) 0/1 array, held on
    ``device`` in float64 (and cast once to float32 for the f32 tCG)."""

    name = "masked_product"

    inner = staticmethod(frob_inner)
    norm = staticmethod(frob_norm)

    def __init__(self, mask, device):
        self.mask = torch.as_tensor(np.asarray(mask, dtype=np.float64),
                                    device=device)
        self._cast = {torch.float64: self.mask}

    def mask_as(self, like):
        """The mask in ``like``'s dtype (the same instance serves the f64
        path and the f32 tCG)."""
        m = self._cast.get(like.dtype)
        if m is None:
            m = self._cast[like.dtype] = self.mask.to(like.dtype)
        return m

    def proj(self, x, u):
        return oblique_cols(x, u, "proj", mask=self.mask_as(x))

    def tangent(self, x, u):
        return self.proj(x, u)

    def tangent_cols(self, x):
        """The tangent map is K2's column projection with this column mask
        in x's dtype (so the tCG's vector step, K11, applies it itself)."""
        return self.mask_as(x)

    def transp(self, x1, x2, d):
        return self.proj(x2, d)

    def retr(self, x, d):
        return oblique_cols(x, d, "retr", mask=self.mask_as(x))

    @staticmethod
    def zerovec(x):
        return torch.zeros_like(x)

    def renormalize(self, y):
        return oblique_cols(y.contiguous(), None, "renormalize",
                            mask=self.mask_as(y))

    @staticmethod
    def typicaldist(ns, ps, nob):
        """sqrt(pi * sum n_oblique + sum p_e * n_e)
        (multiblockmanifold.m:12-15); depends on the current Euclidean
        block ranks, so recomputed per outer iteration on host."""
        ns = np.asarray(ns)
        ps = np.asarray(ps)
        return float(np.sqrt(np.pi * ns[:nob].sum()
                             + float(ps[nob:] @ ns[nob:])))
