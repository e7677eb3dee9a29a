"""Carry JAX-package state across to the port.

The tests feed both packages from the same numpy data through these:
the arrays of a JAX ``SymCOO``, ``ConstraintOp``, ``DenseConstraintOp``,
``EntrywiseConstraintOp``, ``SparseMat``, ``DualOp``, ``SymDualOp``,
``SymMomOp`` or ``ShardedConstraintOp`` (``np.asarray`` of their fields),
the
``dataclasses.asdict`` of a JAX ``SolverOptions``, and a factor Y.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import SolverOptions
from .ops.dualops import DualOp, SparseMat, _ptr
from .ops.symdual import SymDualOp
from .ops.symmom import SymMomOp
from .ops.sparse import (ConstraintOp, DenseConstraintOp,
                         EntrywiseConstraintOp, SymCOO)
from .parallel.sharded_ops import ShardedConstraintOp
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


def sharded_op_from_jax(sharded: dict, arrays: dict, rank: int, device,
                        group=None) -> ShardedConstraintOp:
    """Rank ``rank``'s shard from the arrays of the JAX
    ``ShardedConstraintOp.build(op, D)`` as numpy (keys pat_i, pat_j,
    pat_c, kp, vp, locp, ks, vs, locps, each (D, L) and padded) and of
    the JAX ConstraintOp ``op`` (as constraint_op_from_jax takes them):
    the padding is cut off at the slice lengths ``op``'s pattern size and
    a2p_sorted give, which the padded arrays do not record."""
    world = sharded["pat_i"].shape[0]
    nnzP = np.asarray(arrays["pat.i"]).shape[0]
    Lp = -(-nnzP // world)
    lo, hi = rank * Lp, min((rank + 1) * Lp, nnzP)
    a2ps = np.asarray(arrays["a2p_sorted"])
    s, e = np.searchsorted(a2ps, [lo, lo + Lp])
    npat, nent = max(hi - lo, 0), int(e - s)
    at = lambda key, cnt: np.asarray(sharded[key])[rank, :cnt]  # noqa: E731
    piece = dict(lo=lo, pat_i=at("pat_i", npat), pat_j=at("pat_j", npat),
                 pat_v=at("pat_c", npat),
                 **{key: at(key, nent) for key in ("kp", "vp", "locp", "ks",
                                                   "vs", "locps")})
    glob = dict(pat_i=arrays["pat.i"], pat_j=arrays["pat.j"],
                b=arrays["b"], m=arrays["m"], n=arrays["n"])
    return ShardedConstraintOp.from_piece(piece, glob, rank, world, device,
                                          group)


def dense_op_from_jax(arrays: dict, device) -> DenseConstraintOp:
    """The port's DenseConstraintOp from a JAX DenseConstraintOp's fields as
    numpy: keys k, i, j, v, C, b, m, n.  The port derives the flat
    positions and the CSR pointers of its gather and scatter."""
    return DenseConstraintOp.from_arrays(arrays, device)


def entrywise_op_from_jax(arrays: dict, device) -> EntrywiseConstraintOp:
    """The port's EntrywiseConstraintOp from a JAX EntrywiseConstraintOp's
    fields as numpy: keys aval, C, b, minv, dfac, ki, kj, m, n."""
    return EntrywiseConstraintOp.from_arrays(arrays, device)


def sparse_mat_from_jax(arrays: dict, device) -> SparseMat:
    """The port's SparseMat from a JAX SparseMat's fields as numpy: keys
    row_r, col_r, val_r, row_c, col_c, val_c, nrows, ncols.  The port
    derives the CSR pointers of both orderings."""
    a = arrays
    i32 = lambda k: torch.tensor(  # noqa: E731
        np.asarray(a[k], dtype=np.int32), device=device)
    f64 = lambda k: torch.tensor(  # noqa: E731
        np.asarray(a[k], dtype=np.float64), device=device)
    nrows, ncols = int(a["nrows"]), int(a["ncols"])
    return SparseMat(
        row_r=i32("row_r"), col_r=i32("col_r"), val_r=f64("val_r"),
        row_c=i32("row_c"), col_c=i32("col_c"), val_c=f64("val_c"),
        row_ptr=torch.as_tensor(_ptr(np.asarray(a["row_r"]), nrows),
                                device=device),
        col_ptr=torch.as_tensor(_ptr(np.asarray(a["col_c"]), ncols),
                                device=device),
        nrows=nrows, ncols=ncols)


def dual_op_from_jax(arrays: dict, device) -> DualOp:
    """The port's DualOp from a JAX DualOp's fields as numpy: keys k_r,
    lin_r, v_r, k_c, lin_c, v_c, b, cf, C, idAAt, bA, Ac, m, n, f, and
    ``B`` (the SparseMat's dict, as sparse_mat_from_jax takes it).  The
    port derives krow_ptr and the distinct positions with their pointer."""
    a = arrays
    m, n = int(a["m"]), int(a["n"])
    i32 = lambda k: torch.tensor(  # noqa: E731
        np.asarray(a[k], dtype=np.int32), device=device)
    f64 = lambda k: torch.tensor(  # noqa: E731
        np.asarray(a[k], dtype=np.float64), device=device)
    pos, seg = np.unique(np.asarray(a["lin_c"]), return_inverse=True)
    as32 = lambda x: torch.as_tensor(x.astype(np.int32),  # noqa: E731
                                     device=device)
    return DualOp(
        k_r=i32("k_r"), lin_r=i32("lin_r"), v_r=f64("v_r"),
        k_c=i32("k_c"), lin_c=i32("lin_c"), v_c=f64("v_c"),
        B=sparse_mat_from_jax(a["B"], device), b=f64("b"), cf=f64("cf"),
        C=f64("C"), idAAt=f64("idAAt"), bA=f64("bA"), Ac=f64("Ac"),
        krow_ptr=as32(_ptr(np.asarray(a["k_r"]), m)), pos=as32(pos),
        pos_ptr=as32(_ptr(seg, pos.shape[0])), m=m, n=n, f=int(a["f"]))


def symdual_op_from_jax(arrays: dict, device) -> SymDualOp:
    """The port's SymDualOp from a JAX SymDualOp's fields as numpy: keys
    b, cf, C, idAAt, bA, Ac, dup0, dup1, q, m, n, f, m_true, n_orig (the
    free block is empty and not carried)."""
    a = arrays
    f64 = lambda k: torch.tensor(  # noqa: E731
        np.asarray(a[k], dtype=np.float64), device=device)
    i32 = lambda k: torch.tensor(  # noqa: E731
        np.asarray(a[k], dtype=np.int32), device=device)
    return SymDualOp(
        b=f64("b"), cf=f64("cf"), C=f64("C"), idAAt=f64("idAAt"),
        bA=f64("bA"), Ac=f64("Ac"), dup0=i32("dup0"), dup1=i32("dup1"),
        **{k: int(a[k]) for k in ("q", "m", "n", "f", "m_true", "n_orig")})


def symmom_op_from_jax(arrays: dict, device) -> SymMomOp:
    """The port's SymMomOp from a JAX SymMomOp's fields as numpy: keys C,
    dup0, dup1, q, m, n, m_true, n_orig.  The port holds b (1 at slot 0)
    as an array where the JAX package builds it on each read."""
    a = arrays
    m = int(a["m"])
    b = torch.zeros(m, dtype=torch.float64, device=device)
    b[0] = 1.0
    return SymMomOp(
        C=torch.tensor(np.asarray(a["C"], dtype=np.float64), device=device),
        b=b,
        dup0=torch.tensor(np.asarray(a["dup0"], dtype=np.int32),
                          device=device),
        dup1=torch.tensor(np.asarray(a["dup1"], dtype=np.int32),
                          device=device),
        m=m, **{k: int(a[k]) for k in ("q", "n", "m_true", "n_orig")})


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
