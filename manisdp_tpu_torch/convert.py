"""Carry JAX-package state across to the port.

The tests feed both packages from the same numpy data through these:
the arrays of a JAX ``SymCOO`` or ``ConstraintOp`` (``np.asarray`` of
their fields), the ``dataclasses.asdict`` of a JAX ``SolverOptions``, and
a factor Y.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import SolverOptions
from .ops.sparse import ConstraintOp, SymCOO
from .solvers.common import pad_rows


def symcoo_from_arrays(i, j, v, n: int, device) -> SymCOO:
    """The port's SymCOO (with ``colptr``) from the numpy arrays of a JAX
    SymCOO, which are already sorted by (column, row)."""
    return SymCOO.from_arrays(i, j, v, n, device)


def constraint_op_from_jax(arrays: dict, device) -> ConstraintOp:
    """The port's ConstraintOp from a JAX ConstraintOp's arrays as numpy:
    keys k, i, j, v, a2p, pat.i, pat.j, pat.v, b, kp, vp, a2p_sorted, m, n.
    The same arrays plus the derived colptr, krow_ptr and pat_ptr."""
    a = {key.replace("pat.", "pat_"): val for key, val in arrays.items()}
    return ConstraintOp.from_arrays(a, device)


def options_from_dict(d: dict) -> SolverOptions:
    """SolverOptions from ``dataclasses.asdict`` of the JAX options;
    raises on a field the port does not know."""
    names = {f.name for f in dataclasses.fields(SolverOptions)}
    unknown = sorted(set(d) - names)
    if unknown:
        raise ValueError(f"unknown SolverOptions fields: {unknown}")
    return SolverOptions(**d)


def factor_from_numpy(Y, p_pad: int, device) -> torch.Tensor:
    """A (p, n) host factor zero-padded to (p_pad, n), float64 on
    ``device``."""
    Y = np.asarray(Y, dtype=np.float64)
    return torch.as_tensor(pad_rows(Y, p_pad), dtype=torch.float64,
                           device=device)
