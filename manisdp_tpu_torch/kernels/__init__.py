"""Hand-written Hopper kernels of the port, their plain twins and launch
counters.

K1 ``symcoo_spmm`` (csrc/symcoo_spmm.cu): A·M for a symmetric COO matrix
   sorted by column, with the epilogues ``plain``, ``shift``, ``cost`` and
   ``hess`` of the MaxCut problem and the certificate, and ``al_hess``, the
   primal augmented-Lagrangian Hessian.
K2 ``oblique_cols`` (csrc/oblique_cols.cu): the oblique manifold's column
   ops ``proj``, ``retr`` and ``renormalize``.
K3 ``pattern_dots`` (csrc/pattern_dots.cu): the pair dots
   <Y[:, i_e], U[:, j_e]> over a column-sorted pattern (an SDDMM).
K4 ``csr_gather`` (csrc/csr_gather.cu): y_r = base_r + alpha ·
   sum_e val_e · x[col_e] over CSR segments: the constraint operator
   A(·) and its adjoint on the pattern; mode ``scatter_pos`` writes row r
   at a position pos_r of a dense array (the dense carrier's adjoint).
K5 ``masked_sym`` (csrc/masked_sym.cu): the entrywise carrier's dense
   (n, n) algebra, modes ``apply``, ``aat`` and ``axpy``.
K6 ``oa_refine`` (csrc/oa_refine.cu): the elementwise pass of one
   Ogita-Aishima refinement step of the dense eigen-certificate (f64).

A wrapper given CPU tensors runs the plain PyTorch twin beside it; given
CUDA tensors it launches the kernel (building it on first use) or
raises.  It never falls back.  ``LAUNCHES`` counts kernel launches only.
"""

from __future__ import annotations

import torch

from .build import build

LAUNCHES = {"symcoo_spmm": 0, "oblique_cols": 0, "pattern_dots": 0,
            "csr_gather": 0, "masked_sym": 0, "oa_refine": 0}

# "al_hess" is kernel mode 4, or 5 when eG selects the diag epilogue
SPMM_MODES = {"plain": 0, "shift": 1, "cost": 2, "hess": 3, "al_hess": 4}
# K1's launches by mode (their sum is LAUNCHES["symcoo_spmm"])
SPMM_LAUNCHES = {mode: 0 for mode in SPMM_MODES}
OBLIQUE_MODES = {"proj": 0, "retr": 1, "renormalize": 2}
# K4's launches by mode: "gather" (y_r at r) and "scatter_pos" (at pos_r)
CSR_LAUNCHES = {"gather": 0, "scatter_pos": 0}
MASKED_MODES = {"apply": 0, "aat": 1, "axpy": 2}
# K5's launches by mode
MASKED_LAUNCHES = {mode: 0 for mode in MASKED_MODES}
_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}


def reset_launches():
    for counts in (LAUNCHES, SPMM_LAUNCHES, CSR_LAUNCHES, MASKED_LAUNCHES):
        for k in counts:
            counts[k] = 0


def _on_cuda(*tensors) -> bool:
    """True if every given tensor is on a CUDA device, False if all are on
    the CPU; raises on a mix or on any other device."""
    devs = {t.device.type for t in tensors if t is not None}
    if devs == {"cpu"}:
        return False
    if devs == {"cuda"}:
        return True
    raise ValueError(f"tensors on devices {sorted(devs)}; expected all on "
                     "the CPU or all on CUDA")


def _check_dtype(dtype, *tensors):
    if dtype not in _SUFFIX:
        raise TypeError(f"kernel takes float64 or float32, got {dtype}")
    for t in tensors:
        if t is not None and t.dtype != dtype:
            raise TypeError(f"dtype mismatch: {t.dtype} vs {dtype}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


# -------------------------------------------------------------------- K1 --

def symcoo_spmm_plain(A, C, mode="plain", vals=None, z=None, B=None,
                      eG=None, vals2=None, coefs=(1.0, 1.0)):
    """Plain twin of K1: the JAX package's gather / segment-sum formulas
    (ops/sparse.py scatter_cols; solvers/maxcut.py cost and hess;
    solvers/primal_al.py hess)."""
    from ..ops.sparse import scatter_cols
    v = C.v if vals is None else vals
    AM = scatter_cols(v, C.i, C.j, A, C.n)
    if mode == "al_hess":
        H = coefs[0] * AM + coefs[1] * scatter_cols(vals2, C.i, C.j, B, C.n)
        if eG is None:
            return H
        return H - B * torch.sum(B * H, dim=0, keepdim=True) \
            - A * eG[None, :]
    if mode == "plain":
        return AM
    if mode == "shift":
        return AM - z[None, :] * A
    if mode == "cost":
        return AM, torch.sum(AM * A, dim=0)
    if mode == "hess":
        return AM - B * torch.sum(B * AM, dim=0, keepdim=True) \
            - A * eG[None, :]
    raise ValueError(f"unknown symcoo_spmm mode {mode!r}")


def symcoo_spmm(A, C, mode="plain", vals=None, z=None, B=None, eG=None,
                vals2=None, coefs=(1.0, 1.0)):
    """K1.  ``A`` (p, n) with any strides; ``C`` a SymCOO (fields i, j, v,
    colptr, n).  Returns the (p, n) product with the ``mode`` epilogue;
    ``cost`` returns (A·C, colsum(A·C ∘ A)).

    ``shift`` needs ``z`` (n,); ``hess`` needs ``B`` (p, n) and ``eG``
    (n,).  ``vals`` replaces C's values (same pattern).  ``al_hess``
    returns H = coefs[0]·A·M + coefs[1]·B·M2, M2 with C's pattern and the
    values ``vals2``; given ``eG`` it returns the unit-diagonal epilogue
    H − B ∘ colsum(B ∘ H) − A ∘ eG."""
    if mode not in SPMM_MODES:
        raise ValueError(f"unknown symcoo_spmm mode {mode!r}")
    v = C.v if vals is None else vals
    need = {"shift": (z,), "hess": (B, eG),
            "al_hess": (B, vals2)}.get(mode, ())
    if any(t is None for t in need):
        raise ValueError(f"mode {mode!r} is missing an operand")
    if not _on_cuda(A, v, C.i, C.colptr, z, B, eG, vals2):
        return symcoo_spmm_plain(A, C, mode, vals, z, B, eG, vals2, coefs)

    if A.dim() != 2:
        raise ValueError(f"A must be (p, n), got {tuple(A.shape)}")
    p, n = A.shape
    if n != C.n or v.shape != C.i.shape or C.colptr.shape != (n + 1,):
        raise ValueError(f"A is {tuple(A.shape)}, C is n={C.n}, "
                         f"vals {tuple(v.shape)} vs nnz {C.i.shape[0]}")
    _check_dtype(A.dtype, A, v, z, B, eG, vals2)
    if C.colptr.dtype != torch.int32 or C.i.dtype != torch.int32:
        raise TypeError("C.colptr and C.i must be int32")
    if not (C.colptr.is_contiguous() and C.i.is_contiguous()
            and v.is_contiguous()):
        raise ValueError("C's index and value arrays must be contiguous")
    if vals2 is not None and (vals2.shape != v.shape or
                              not vals2.is_contiguous()):
        raise ValueError(f"vals2 must be contiguous of shape "
                         f"{tuple(v.shape)}")
    for name, t, shape in (("z", z, (n,)), ("eG", eG, (n,)),
                           ("B", B, (p, n))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    if z is not None and not z.is_contiguous():
        raise ValueError("z must be contiguous")
    if eG is not None and not eG.is_contiguous():
        raise ValueError("eG must be contiguous")
    out = torch.empty((p, n), dtype=A.dtype, device=A.device)
    w = torch.empty((n,), dtype=A.dtype, device=A.device) \
        if mode == "cost" else None
    sbr, sbc = B.stride() if B is not None else (0, 0)
    fn = getattr(build(), f"symcoo_spmm_{_SUFFIX[A.dtype]}")
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    code = SPMM_MODES[mode] + (mode == "al_hess" and eG is not None)
    err = fn(A.data_ptr(), A.stride(0), A.stride(1), C.colptr.data_ptr(),
             C.i.data_ptr(), v.data_ptr(), p, n, code, ptr(z), ptr(B), sbr,
             sbc, ptr(eG), ptr(vals2), float(coefs[0]), float(coefs[1]),
             out.data_ptr(), ptr(w), _stream(A))
    if err != 0:
        raise RuntimeError(f"symcoo_spmm launch failed: CUDA error {err}")
    LAUNCHES["symcoo_spmm"] += 1
    SPMM_LAUNCHES[mode] += 1
    return (out, w) if mode == "cost" else out


# -------------------------------------------------------------------- K2 --

def oblique_cols_plain(x, u=None, mode="proj"):
    """Plain twin of K2: manifolds/oblique.py of the JAX package."""
    if mode == "proj":
        return u - x * torch.sum(x * u, dim=0, keepdim=True)
    if mode == "retr":
        xtd = x + u
        return xtd / torch.sqrt(torch.sum(xtd * xtd, dim=0, keepdim=True))
    if mode == "renormalize":
        return x / torch.sqrt(torch.sum(x * x, dim=0, keepdim=True))
    raise ValueError(f"unknown oblique_cols mode {mode!r}")


def oblique_cols(x, u=None, mode="proj"):
    """K2 on contiguous (p, n) ``x`` (and ``u`` for proj / retr)."""
    if mode not in OBLIQUE_MODES:
        raise ValueError(f"unknown oblique_cols mode {mode!r}")
    if (u is None) != (mode == "renormalize"):
        raise ValueError(f"mode {mode!r} takes "
                         f"{'no' if mode == 'renormalize' else 'a'} u")
    if not _on_cuda(x, u):
        return oblique_cols_plain(x, u, mode)
    _check_dtype(x.dtype, x, u)
    if x.dim() != 2 or (u is not None and u.shape != x.shape):
        raise ValueError("x and u must be the same (p, n) shape")
    if not x.is_contiguous() or (u is not None and not u.is_contiguous()):
        raise ValueError("oblique_cols takes contiguous row-major tensors")
    p, n = x.shape
    out = torch.empty_like(x)
    fn = getattr(build(), f"oblique_cols_{_SUFFIX[x.dtype]}")
    err = fn(x.data_ptr(), u.data_ptr() if u is not None else None, p, n,
             OBLIQUE_MODES[mode], out.data_ptr(), _stream(x))
    if err != 0:
        raise RuntimeError(f"oblique_cols launch failed: CUDA error {err}")
    LAUNCHES["oblique_cols"] += 1
    return out


# -------------------------------------------------------------------- K3 --

def pattern_dots_plain(Y, U, P):
    """Plain twin of K3: the JAX package's pair_dots over the pattern
    (ops/sparse.py pair_dots / ConstraintOp.pattern_pair_dots)."""
    from ..ops.sparse import pair_dots
    return pair_dots(Y, U, P.i, P.j)


def pattern_dots(Y, U, P):
    """K3.  ``Y``, ``U`` (p, n) with any strides; ``P`` a column-sorted
    SymCOO pattern (fields i, j, colptr, n).  Returns e (nnz,) with
    e_k = <Y[:, i_k], U[:, j_k]>."""
    if not _on_cuda(Y, U, P.i, P.colptr):
        return pattern_dots_plain(Y, U, P)
    _check_dtype(Y.dtype, Y, U)
    if Y.dim() != 2 or U.shape != Y.shape or Y.shape[1] != P.n:
        raise ValueError(f"Y {tuple(Y.shape)} and U {tuple(U.shape)} must "
                         f"be the same (p, {P.n})")
    if P.colptr.dtype != torch.int32 or P.i.dtype != torch.int32:
        raise TypeError("P.colptr and P.i must be int32")
    if not (P.colptr.is_contiguous() and P.i.is_contiguous()) or \
            P.colptr.shape != (P.n + 1,):
        raise ValueError("P's colptr (n+1,) and rows must be contiguous")
    p, n = Y.shape
    out = torch.empty((P.i.shape[0],), dtype=Y.dtype, device=Y.device)
    fn = getattr(build(), f"pattern_dots_{_SUFFIX[Y.dtype]}")
    err = fn(Y.data_ptr(), Y.stride(0), Y.stride(1), U.data_ptr(),
             U.stride(0), U.stride(1), P.colptr.data_ptr(), P.i.data_ptr(),
             p, n, out.data_ptr(), _stream(Y))
    if err != 0:
        raise RuntimeError(f"pattern_dots launch failed: CUDA error {err}")
    LAUNCHES["pattern_dots"] += 1
    return out


# -------------------------------------------------------------------- K4 --

def csr_gather_plain(x, ptr, col, val, base=None, alpha=1.0, pos=None,
                     size=None):
    """Plain twin of K4: the JAX package's scalar gather + segment-sum
    (ops/sparse.py apply_from_e, adjoint_on_pattern, es_vals, s_vals) and,
    with ``pos``, the dense carrier's scatter-add (DenseConstraintOp
    adjoint_on_pattern, es_vals, s_vals)."""
    nrows = ptr.shape[0] - 1
    seg = torch.repeat_interleave(
        torch.arange(nrows, device=ptr.device),
        (ptr[1:] - ptr[:-1]).long(), output_size=col.shape[0])
    acc = torch.zeros((nrows,), dtype=x.dtype, device=x.device)
    acc.index_add_(0, seg, val * x[col.long()])
    if pos is None:
        return alpha * acc if base is None else base + alpha * acc
    at = pos.long()
    out = torch.zeros((size,), dtype=x.dtype, device=x.device) \
        if base is None else base.clone()
    out[at] = alpha * acc if base is None else base[at] + alpha * acc
    return out


def csr_gather(x, ptr, col, val, base=None, alpha=1.0, pos=None,
               size=None):
    """K4.  ``ptr`` (R+1,) int32 delimits R segments of the entries
    (``col`` int32, ``val``); returns y (R,) with
    y_r = base_r + alpha · sum_e val_e · x[col_e] (no ``base``: 0).
    ``alpha`` is a Python number.

    Mode ``scatter_pos`` (``pos`` (R,) int32 distinct positions and the
    output length ``size``): returns out (size,) with out[pos_r] =
    base[pos_r] + alpha · sum_e ..., and out = base (or 0) elsewhere;
    ``base`` then has length ``size``."""
    scatter = pos is not None
    if scatter and size is None:
        raise ValueError("scatter_pos needs the output size")
    if not _on_cuda(x, ptr, col, val, base, pos):
        return csr_gather_plain(x, ptr, col, val, base, alpha, pos, size)
    _check_dtype(x.dtype, x, val, base)
    nrows = ptr.shape[0] - 1
    if ptr.dtype != torch.int32 or col.dtype != torch.int32 or \
            (scatter and pos.dtype != torch.int32):
        raise TypeError("ptr, col and pos must be int32")
    nout = size if scatter else nrows
    if col.shape != val.shape or x.dim() != 1 or \
            (base is not None and base.shape != (nout,)) or \
            (scatter and pos.shape != (nrows,)):
        raise ValueError(f"col {tuple(col.shape)}, val {tuple(val.shape)}, "
                         f"x {tuple(x.shape)}, {nrows} rows, output {nout}")
    if not all(t.is_contiguous() for t in (x, ptr, col, val, base, pos)
               if t is not None):
        raise ValueError("csr_gather takes contiguous tensors")
    if not scatter:
        out = torch.empty((nrows,), dtype=x.dtype, device=x.device)
    elif base is None:
        out = torch.zeros((size,), dtype=x.dtype, device=x.device)
    else:
        out = base.clone()
    fn = getattr(build(), f"csr_gather_{_SUFFIX[x.dtype]}")
    err = fn(x.data_ptr(), ptr.data_ptr(), col.data_ptr(), val.data_ptr(),
             base.data_ptr() if base is not None else None, float(alpha),
             pos.data_ptr() if scatter else None, nrows, out.data_ptr(),
             _stream(x))
    if err != 0:
        raise RuntimeError(f"csr_gather launch failed: CUDA error {err}")
    LAUNCHES["csr_gather"] += 1
    CSR_LAUNCHES["scatter_pos" if scatter else "gather"] += 1
    return out


# -------------------------------------------------------------------- K5 --

def masked_sym_plain(E, aval, dfac=None, mode="apply", C=None, alpha=1.0):
    """Plain twin of K5: the JAX package's EntrywiseConstraintOp formulas
    (ops/sparse.py apply_from_e, adjoint_on_pattern of apply_from_e,
    es_vals / s_vals / adjoint_on_pattern)."""
    if mode == "axpy":
        out = alpha * (aval * E)
        return out if C is None else C + out
    R = aval * E
    out = dfac * (R + R.T)
    if mode == "apply":
        return out
    if mode == "aat":
        return aval * out
    raise ValueError(f"unknown masked_sym mode {mode!r}")


def masked_sym(E, aval, dfac=None, mode="apply", C=None, alpha=1.0):
    """K5 on contiguous (n, n) arrays.  ``apply``: dfac ∘ (aval ∘ E +
    (aval ∘ E)ᵀ); ``aat``: aval ∘ apply; ``axpy``: C + alpha · aval ∘ E
    (no ``C``: 0).  ``alpha`` is a Python number."""
    if mode not in MASKED_MODES:
        raise ValueError(f"unknown masked_sym mode {mode!r}")
    if (dfac is None) != (mode == "axpy"):
        raise ValueError(f"mode {mode!r} takes "
                         f"{'no' if mode == 'axpy' else 'a'} dfac")
    if C is not None and mode != "axpy":
        raise ValueError(f"mode {mode!r} takes no C")
    if not _on_cuda(E, aval, dfac, C):
        return masked_sym_plain(E, aval, dfac, mode, C, alpha)
    _check_dtype(E.dtype, E, aval, dfac, C)
    n = E.shape[0]
    if E.dim() != 2 or any(t.shape != (n, n) for t in (E, aval, dfac, C)
                           if t is not None):
        raise ValueError("masked_sym takes square arrays of one shape")
    if not all(t.is_contiguous() for t in (E, aval, dfac, C)
               if t is not None):
        raise ValueError("masked_sym takes contiguous row-major tensors")
    out = torch.empty_like(E)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    fn = getattr(build(), f"masked_sym_{_SUFFIX[E.dtype]}")
    err = fn(E.data_ptr(), aval.data_ptr(), ptr(dfac), ptr(C), float(alpha),
             n, MASKED_MODES[mode], out.data_ptr(), _stream(E))
    if err != 0:
        raise RuntimeError(f"masked_sym launch failed: CUDA error {err}")
    LAUNCHES["masked_sym"] += 1
    MASKED_LAUNCHES[mode] += 1
    return out


# -------------------------------------------------------------------- K6 --

def oa_refine_plain(S, B, mu, mu_min, mu_max):
    """Plain twin of K6: the JAX package's _oa_refine elementwise algebra
    (ops/dense_cert.py:92-126).  Returns (E, bsum, g1, g2)."""
    n = S.shape[0]
    eye = torch.eye(n, dtype=S.dtype, device=S.device)
    dB = torch.abs(torch.diagonal(B) - 1.0)
    bsum = (torch.sum(torch.abs(B - eye), dim=1) - dB) + dB
    G = S - mu_min * B
    gd = torch.diagonal(G)
    g1 = gd - (torch.sum(torch.abs(G), dim=1) - torch.abs(gd))
    G2 = mu_max * B - S
    g2d = torch.diagonal(G2)
    g2 = g2d - (torch.sum(torch.abs(G2), dim=1) - torch.abs(g2d))
    R = eye - B
    scale = torch.maximum(torch.abs(mu_min), torch.abs(mu_max)) + 1e-30
    d = mu[None, :] - mu[:, None]
    safe = torch.abs(d) > 1e-3 * scale
    E_rot = (S + mu[None, :] * R) / torch.where(safe, d, 1.0)
    return torch.where(safe, E_rot, 0.5 * R), bsum, g1, g2


def oa_refine(S, B, mu, mu_min, mu_max):
    """K6 on contiguous f64 (n, n) ``S`` (symmetrized VᵀXV) and ``B``
    (VᵀV), ``mu`` (n,) and the 0-d ``mu_min`` / ``mu_max``.  Returns E
    (n, n) and the row quantities bsum, g1, g2 (n,) (csrc/oa_refine.cu)."""
    if not _on_cuda(S, B, mu, mu_min, mu_max):
        return oa_refine_plain(S, B, mu, mu_min, mu_max)
    if S.dtype != torch.float64:
        raise TypeError(f"oa_refine takes float64, got {S.dtype}")
    _check_dtype(S.dtype, S, B, mu, mu_min, mu_max)
    n = S.shape[0]
    if S.shape != (n, n) or B.shape != (n, n) or mu.shape != (n,):
        raise ValueError(f"S {tuple(S.shape)}, B {tuple(B.shape)}, "
                         f"mu {tuple(mu.shape)}")
    if not (S.is_contiguous() and B.is_contiguous() and mu.is_contiguous()):
        raise ValueError("oa_refine takes contiguous tensors")
    mm = torch.stack([mu_min, mu_max])
    E = torch.empty_like(S)
    bsum, g1, g2 = (torch.empty((n,), dtype=S.dtype, device=S.device)
                    for _ in range(3))
    err = build().oa_refine_f64(S.data_ptr(), B.data_ptr(), mu.data_ptr(),
                                mm.data_ptr(), n, E.data_ptr(),
                                bsum.data_ptr(), g1.data_ptr(),
                                g2.data_ptr(), _stream(S))
    if err != 0:
        raise RuntimeError(f"oa_refine launch failed: CUDA error {err}")
    LAUNCHES["oa_refine"] += 1
    return E, bsum, g1, g2


__all__ = ["LAUNCHES", "SPMM_LAUNCHES", "CSR_LAUNCHES", "MASKED_LAUNCHES",
           "reset_launches", "symcoo_spmm", "symcoo_spmm_plain",
           "oblique_cols", "oblique_cols_plain", "pattern_dots",
           "pattern_dots_plain", "csr_gather", "csr_gather_plain",
           "masked_sym", "masked_sym_plain", "oa_refine", "oa_refine_plain",
           "build"]
