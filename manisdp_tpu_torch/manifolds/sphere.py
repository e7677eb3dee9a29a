"""Unit-Frobenius-norm sphere of (p, n) matrices (PyTorch port of
manisdp_tpu/manifolds/sphere.py; Manopt's ``spherefactory``).

The norm is global over the whole factor, so every op is a plain tensor
expression (one reduction and one elementwise pass).  Zero padding rows
stay zero.
"""

from __future__ import annotations

import math

import torch

from .base import frob_inner, frob_norm


class Sphere:
    name = "sphere"

    inner = staticmethod(frob_inner)
    norm = staticmethod(frob_norm)

    @staticmethod
    def proj(x, u):
        # d - x * <x, d>  (spherefactory.m:113)
        return u - x * torch.sum(x * u)

    tangent = proj

    @staticmethod
    def transp(x1, x2, d):
        return d - x2 * torch.sum(x2 * d)

    @staticmethod
    def retr(x, d):
        xtd = x + d
        return xtd / torch.sqrt(torch.sum(xtd * xtd))

    @staticmethod
    def zerovec(x):
        return torch.zeros_like(x)

    @staticmethod
    def typicaldist(p, n):
        return math.pi

    @staticmethod
    def rand(gen: torch.Generator, p, n, p_pad=None, dtype=torch.float64):
        """Gaussian point of unit Frobenius norm on ``gen``'s device,
        zero-padded to p_pad rows."""
        p_pad = p if p_pad is None else p_pad
        y = torch.randn((p, n), generator=gen, dtype=dtype,
                        device=gen.device)
        y = y / torch.sqrt(torch.sum(y * y))
        if p_pad > p:
            y = torch.cat([y, torch.zeros((p_pad - p, n), dtype=dtype,
                                          device=gen.device)])
        return y

    @staticmethod
    def renormalize(y):
        return y / torch.sqrt(torch.sum(y * y))
