"""Hand-written Hopper kernels of the port, their plain twins and launch
counters.

K1 ``symcoo_spmm`` (csrc/symcoo_spmm.cu): A·M for a symmetric COO matrix
   sorted by column, with the epilogues ``plain``, ``shift``, ``cost`` and
   ``hess`` of the MaxCut problem and the certificate, and ``al_hess``, the
   primal augmented-Lagrangian Hessian.
K2 ``oblique_cols`` (csrc/oblique_cols.cu): the oblique manifold's column
   ops ``proj``, ``retr`` and ``renormalize``; with a 0/1 column mask, the
   masked product manifold of the multiblock drivers.
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
K7 ``symdual_apply`` (csrc/symdual_apply.cu): the SOS-dual tensor
   operator's class sums of an (n~, n~) matrix, every degree (y0 .. Y4);
   in row-block mode (``symdual_apply_rows``) on one rank's rows of the
   matrix sharded over ranks, around two all-to-alls and one all-reduce.
K8 ``symdual_adjoint`` (csrc/symdual_adjoint.cu): its adjoint (mode
   ``adjoint``; row-block mode ``symdual_adjoint_rows``) and the
   duplicate-copy projections of a factor (``sym_factor``) and of a matrix
   (``sym_mat``).
K9 ``symmom_apply`` (csrc/symmom_apply.cu): the BQP moment operator's rows
   A(M) of an (n~, n~) matrix in the flat layout, don't-care slots 0.
K10 ``symmom_adjoint`` (csrc/symmom_adjoint.cu): its exact adjoint A'(y),
   with the fused epilogue base + alpha * A'(y).
K11 ``tcg_step`` (csrc/tcg_step.cu): the truncated-CG vector step around
   one Hessian-vector product, one scalar set per instance, in one
   cooperative launch; on the oblique and masked-product manifolds it
   also applies K2's tangent projection to the next direction.  Over
   ranks (the column-sharded MaxCut): peer mode, still one launch, the
   sums over the ranks made on the device through IPC-mapped peer
   memory; split mode, three launches with a sum over ranks between
   them.
K1 and K2 also take a batch of B instances of one padded size in one
launch (instance mode): a BatchedSymCOO and (B, p, n) factors.

A wrapper given CPU tensors runs the plain PyTorch twin beside it; given
CUDA tensors it launches the kernel (building it on first use) or
raises.  It never falls back.  ``LAUNCHES`` counts kernel launches only.
"""

from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from .build import build

LAUNCHES = {"symcoo_spmm": 0, "oblique_cols": 0, "pattern_dots": 0,
            "csr_gather": 0, "masked_sym": 0, "oa_refine": 0,
            "symdual_apply": 0, "symdual_adjoint": 0, "symmom_apply": 0,
            "symmom_adjoint": 0, "tcg_step": 0}

# "al_hess" is kernel mode 4, or 5 when eG selects the diag epilogue
SPMM_MODES = {"plain": 0, "shift": 1, "cost": 2, "hess": 3, "al_hess": 4}
# K1's launches by mode (their sum is LAUNCHES["symcoo_spmm"])
SPMM_LAUNCHES = {mode: 0 for mode in SPMM_MODES}
OBLIQUE_MODES = {"proj": 0, "retr": 1, "renormalize": 2}
# K2's launches by mode; "proj_eG" is proj with the Hessian's - v o g term;
# "masked" counts the launches of any mode that were given a column mask
OBLIQUE_LAUNCHES = {"proj": 0, "proj_eG": 0, "retr": 0, "renormalize": 0,
                    "masked": 0}
# K4's launches by mode: "gather" (y_r at r) and "scatter_pos" (at pos_r)
CSR_LAUNCHES = {"gather": 0, "scatter_pos": 0}
MASKED_MODES = {"apply": 0, "aat": 1, "axpy": 2}
# K5's launches by mode
MASKED_LAUNCHES = {mode: 0 for mode in MASKED_MODES}
# K8's launches by mode (their sum is LAUNCHES["symdual_adjoint"]);
# "residual" is the adjoint given B1 or B2
SYMDUAL_LAUNCHES = {"adjoint": 0, "residual": 0, "sym_factor": 0,
                    "sym_mat": 0, "adjoint_rows": 0}
# K7's calls in row-block mode (also counted in LAUNCHES["symdual_apply"])
SYMDUAL_APPLY_LAUNCHES = {"rows": 0}
# K1's and K2's launches in instance mode (also counted above)
INSTANCE_LAUNCHES = {"symcoo_spmm": 0, "oblique_cols": 0}
# K11's launches (LAUNCHES["tcg_step"]) that also projected the next
# direction onto the tangent space, its steps in split mode (three
# launches each, the partials summed over the ranks between them) and in
# peer mode (one launch, the sums over the ranks on the device)
TCG_LAUNCHES = {"projected": 0, "split": 0, "peer": 0}
# the stop code K11's peer mode writes on every instance when a peer's
# flag did not come in time (tcg_step.cu kTimeoutStop; no other path
# writes it)
TCG_TIMEOUT_STOP = 8
# the K1 / K3 launches on a pattern's span narrower than the whole n x n
# (a sharded operator's shard, its column range)
SPAN_LAUNCHES = {"symcoo_spmm": 0, "pattern_dots": 0}
_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}


# each kernel's float32 launches (also counted in LAUNCHES)
F32_LAUNCHES = dict.fromkeys(LAUNCHES, 0)
# the collectives of the sharded paths (parallel/distributed.py): calls
# and bytes of this rank's tensors (not kernels; reset with them)
# ("host_staged": the all_to_all / all_gather calls that gloo ran on CUDA
# tensors through host copies made by parallel/distributed.py)
COLLECTIVES = {"all_reduce": 0, "all_reduce_bytes": 0, "broadcast": 0,
               "broadcast_bytes": 0, "all_to_all": 0, "all_to_all_bytes": 0,
               "all_gather": 0, "all_gather_bytes": 0, "host_staged": 0}


def reset_launches():
    for counts in (LAUNCHES, F32_LAUNCHES, SPMM_LAUNCHES, CSR_LAUNCHES,
                   MASKED_LAUNCHES, OBLIQUE_LAUNCHES, SYMDUAL_LAUNCHES,
                   SYMDUAL_APPLY_LAUNCHES, INSTANCE_LAUNCHES, TCG_LAUNCHES,
                   SPAN_LAUNCHES, COLLECTIVES):
        for k in counts:
            counts[k] = 0


def _launched(name: str, dtype):
    """Count one launch of kernel ``name`` in ``dtype``."""
    LAUNCHES[name] += 1
    F32_LAUNCHES[name] += dtype == torch.float32


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

def _stack_like(ts):
    """Stack equal-shaped tensors, each keeping its memory layout (so each
    instance's sums run in the order of the single-instance twin's)."""
    out = torch.empty_strided((len(ts),) + tuple(ts[0].shape),
                              (ts[0].numel(),) + ts[0].stride(),
                              dtype=ts[0].dtype, device=ts[0].device)
    for o, t in zip(out, ts):
        o.copy_(t)
    return out


def symcoo_spmm_plain(A, C, mode="plain", vals=None, z=None, B=None,
                      eG=None, vals2=None, coefs=(1.0, 1.0)):
    """Plain twin of K1: the JAX package's gather / segment-sum formulas
    (ops/sparse.py scatter_cols; solvers/maxcut.py cost and hess;
    solvers/primal_al.py hess); for a BatchedSymCOO, the single-instance
    twin on each instance."""
    from ..ops.sparse import scatter_cols
    if C.colptr.dim() == 2:
        at = lambda t, b: None if t is None else t[b]  # noqa: E731
        outs = [symcoo_spmm_plain(A[b], C.instance(b), mode,
                                  C.entries(vals, b), at(z, b), at(B, b),
                                  at(eG, b), C.entries(vals2, b), coefs)
                for b in range(C.nb)]
        if mode == "cost":
            return tuple(_stack_like(o) for o in zip(*outs))
        return _stack_like(outs)
    v = C.v if vals is None else vals
    if C.span is not None:
        # the column block of the whole-width product
        c0, c1 = C.span[:2]
        full = symcoo_spmm_plain(A, dataclasses.replace(C, span=None), mode,
                                 vals, z, B, eG, vals2, coefs)
        if mode == "cost":
            return full[0][:, c0:c1], full[1][c0:c1]
        return full[:, c0:c1]
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


def pattern_span(P):
    """(c0, c1, r0, r1) of a pattern: its ``span``, or the whole n x n."""
    return P.span if getattr(P, "span", None) is not None else \
        (0, P.n, 0, P.n)


# K1 walks columns of more than this many entries on average with its
# deep variant (the next entries' indices and values loaded ahead),
# shorter ones with the shallow one (its one-factor walk at 64 registers,
# two blocks an SM)
SPMM_DEEP_MEAN = 8


def symcoo_spmm_layout(p, dtype, views):
    """K1's gather layout for a (p, n) product: ``views`` holds, for each
    gathered factor (A, and B in ``al_hess``), its (stride along p, stride
    along n, instance stride, data_ptr).  Returns (vw, pp, copy): the
    scalars per load (1 or one 16-B vector), the gathered rows' length pp
    (p rounded up to vw) and, per factor, whether the kernel transposes it
    into an (n, pp) scratch first (True) or gathers it where it lies: a
    factor with stride 1 along p (or p = 1) is N-major already, read with
    16-B loads when its rows and instances are 16-B aligned and p fills
    whole vectors, else with scalar loads if every factor is N-major."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    nmajor = [(sr == 1 or p == 1) and sc >= p for sr, sc, _, _ in views]
    aligned = [ok and p % vec == 0 and sc % vec == 0 and sb % vec == 0 and
               ptr % 16 == 0
               for ok, (_, sc, sb, ptr) in zip(nmajor, views)]
    if all(aligned):
        return vec, p, [False] * len(views)
    if all(nmajor):
        return 1, p, [False] * len(views)
    return vec, -(-p // vec) * vec, [not a for a in aligned]


def symcoo_spmm(A, C, mode="plain", vals=None, z=None, B=None, eG=None,
                vals2=None, coefs=(1.0, 1.0)):
    """K1.  ``A`` (p, n) with any strides; ``C`` a SymCOO (fields i, j, v,
    colptr, n).  Returns the (p, n) product with the ``mode`` epilogue;
    ``cost`` returns (A·C, colsum(A·C ∘ A)).

    ``shift`` needs ``z`` (n,); ``hess`` needs ``B`` (p, n) and ``eG``
    (n,).  ``vals`` replaces C's values (same pattern).  ``al_hess``
    returns H = coefs[0]·A·M + coefs[1]·B·M2, M2 with C's pattern and the
    values ``vals2``; given ``eG`` it returns the unit-diagonal epilogue
    H − B ∘ colsum(B ∘ H) − A ∘ eG.

    A C with a ``span`` (c0, c1, r0, r1) (a shard of a pattern): the
    (p, c1 − c0) block of columns c0 .. c1-1 (``cost``'s w (c1 − c0,)); the
    grid covers those columns and the N-major copies the rows r0 .. r1-1
    their entries read; z and eG stay (n,).

    Instance mode: ``C`` a BatchedSymCOO of nb instances, ``A`` and ``B``
    (nb, p, n) with any strides, ``z`` and ``eG`` (nb, n); every mode but
    ``al_hess``, one launch sequence for all instances.

    On the card a call is a transpose of each gathered factor that is not
    N-major into scratch (symcoo_spmm_layout), then the product."""
    if mode not in SPMM_MODES:
        raise ValueError(f"unknown symcoo_spmm mode {mode!r}")
    v = C.v if vals is None else vals
    need = {"shift": (z,), "hess": (B, eG),
            "al_hess": (B, vals2)}.get(mode, ())
    if any(t is None for t in need):
        raise ValueError(f"mode {mode!r} is missing an operand")
    batched = C.colptr.dim() == 2
    if batched and mode == "al_hess":
        raise ValueError("instance mode takes plain, shift, cost or hess")
    if not _on_cuda(A, v, C.i, C.colptr, z, B, eG, vals2):
        return symcoo_spmm_plain(A, C, mode, vals, z, B, eG, vals2, coefs)

    lead = (C.nb,) if batched else ()
    if A.dim() != len(lead) + 2 or tuple(A.shape[:-2]) != lead:
        raise ValueError(f"A must be {'(nb, p, n)' if batched else '(p, n)'}"
                         f" for this C, got {tuple(A.shape)}")
    p, n = A.shape[-2:]
    if n != C.n or v.shape != C.i.shape or \
            tuple(C.colptr.shape) != lead + (n + 1,):
        raise ValueError(f"A is {tuple(A.shape)}, C is n={C.n}, "
                         f"vals {tuple(v.shape)} vs nnz {C.i.shape[0]}")
    _check_dtype(A.dtype, A, v, z, B, eG, vals2)
    if C.colptr.dtype != torch.int32 or C.i.dtype != torch.int32:
        raise TypeError("C.colptr and C.i must be int32")
    if not (C.colptr.is_contiguous() and C.i.is_contiguous()
            and v.is_contiguous()):
        raise ValueError("C's index and value arrays must be contiguous")
    if batched and (C.eoff.dtype != torch.int64 or
                    C.eoff.shape != (C.nb,) or not C.eoff.is_contiguous()):
        raise ValueError("C.eoff must be contiguous int64 (nb,)")
    if vals2 is not None and (vals2.shape != v.shape or
                              not vals2.is_contiguous()):
        raise ValueError(f"vals2 must be contiguous of shape "
                         f"{tuple(v.shape)}")
    for name, t, shape in (("z", z, lead + (n,)), ("eG", eG, lead + (n,)),
                           ("B", B, tuple(A.shape))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    if z is not None and not z.is_contiguous():
        raise ValueError("z must be contiguous")
    if eG is not None and not eG.is_contiguous():
        raise ValueError("eG must be contiguous")
    c0, c1, r0, r1 = pattern_span(C)
    if batched and (c0, c1, r0, r1) != (0, n, 0, n):
        raise ValueError("instance mode takes whole patterns, no span")
    if not 0 <= c0 <= c1 <= n or not 0 <= r0 <= r1 <= n:
        raise ValueError(f"span {(c0, c1, r0, r1)} outside n={n}")
    out = torch.empty(lead + (p, c1 - c0), dtype=A.dtype, device=A.device)
    w = torch.empty(lead + (c1 - c0,), dtype=A.dtype, device=A.device) \
        if mode == "cost" else None
    sab, sar, sac = (0,) * (not batched) + tuple(A.stride())
    sbb, sbr, sbc = ((0,) * (not batched) + tuple(B.stride())
                     if B is not None else (0, 0, 0))
    gathered = [(sar, sac, sab, A.data_ptr())]
    if mode == "al_hess":
        gathered.append((sbr, sbc, sbb, B.data_ptr()))
    vw, pp, copy = symcoo_spmm_layout(p, A.dtype, gathered)
    # the N-major copies the kernel transposes into (None: gathered in
    # place): the rows r0 .. r1-1 the entries read
    scratch = lambda: torch.empty(lead + (r1 - r0, pp),  # noqa: E731
                                  dtype=A.dtype, device=A.device)
    At = scratch() if copy[0] else None
    Bt = scratch() if mode == "al_hess" and copy[1] else None
    deep = v.shape[0] > SPMM_DEEP_MEAN * (c1 - c0) * (C.nb if batched
                                                       else 1)
    fn = getattr(build(), f"symcoo_spmm_{_SUFFIX[A.dtype]}")
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    code = SPMM_MODES[mode] + (mode == "al_hess" and eG is not None)
    err = fn(A.data_ptr(), sab, sar, sac, C.colptr.data_ptr(),
             C.eoff.data_ptr() if batched else None, C.i.data_ptr(),
             v.data_ptr(), p, n, C.nb if batched else 1, code, ptr(z),
             ptr(B), sbb, sbr, sbc, ptr(eG), ptr(vals2), float(coefs[0]),
             float(coefs[1]), out.data_ptr(), ptr(w), ptr(At), ptr(Bt), pp,
             vw, int(deep), c0, c1 - c0, r0, r1 - r0, _stream(A))
    if err != 0:
        raise RuntimeError(f"symcoo_spmm launch failed: CUDA error {err}")
    _launched("symcoo_spmm", A.dtype)
    SPMM_LAUNCHES[mode] += 1
    SPAN_LAUNCHES["symcoo_spmm"] += (c0, c1, r0, r1) != (0, n, 0, n)
    if batched:
        INSTANCE_LAUNCHES["symcoo_spmm"] += 1
    return (out, w) if mode == "cost" else out


# -------------------------------------------------------------------- K2 --

def oblique_cols_plain(x, u=None, mode="proj", v=None, g=None, mask=None):
    """Plain twin of K2: manifolds/oblique.py of the JAX package, with
    ``v``, ``g`` the oblique Hessian epilogue of solvers/dual_al.py, and
    with ``mask`` manifolds/product.py's MaskedProduct (columns with mask 0
    are neither projected nor normalized).  Columns are the last axis, so a
    (B, p, n) stack is B instances."""
    if mode == "proj":
        s = torch.sum(x * u, dim=-2, keepdim=True)
        out = u - x * (s if mask is None else s * mask[None, :])
        return out if v is None else out - v * g[..., None, :]
    if mode not in ("retr", "renormalize"):
        raise ValueError(f"unknown oblique_cols mode {mode!r}")
    xtd = x + u if mode == "retr" else x
    nrm = torch.sqrt(torch.sum(xtd * xtd, dim=-2, keepdim=True))
    if mask is not None:
        nrm = torch.where(mask[None, :] > 0, nrm, torch.ones_like(nrm))
    return xtd / nrm


def oblique_cols(x, u=None, mode="proj", v=None, g=None, mask=None):
    """K2 on contiguous (p, n) ``x`` (and ``u`` for proj / retr).  proj
    with ``v`` (p, n) and ``g`` (n,) returns u - x ∘ colsum(x ∘ u) - v ∘ g.
    ``mask`` (n,) 0/1 in x's dtype: columns with mask 0 skip the projection
    (colsum ∘ mask) and the normalization (divided by 1).  Instance mode:
    x, u, v (B, p, n) and g (B, n), one launch; the mask is shared."""
    if mode not in OBLIQUE_MODES:
        raise ValueError(f"unknown oblique_cols mode {mode!r}")
    if (u is None) != (mode == "renormalize"):
        raise ValueError(f"mode {mode!r} takes "
                         f"{'no' if mode == 'renormalize' else 'a'} u")
    if (v is None) != (g is None) or (v is not None and mode != "proj"):
        raise ValueError("v and g go together, in mode 'proj' only")
    if not _on_cuda(x, u, v, g, mask):
        return oblique_cols_plain(x, u, mode, v, g, mask)
    _check_dtype(x.dtype, x, u, v, g, mask)
    if x.dim() not in (2, 3) or any(t is not None and t.shape != x.shape
                                    for t in (u, v)):
        raise ValueError("x, u and v must be the same (p, n) or (B, p, n) "
                         "shape")
    p, n = x.shape[-2:]
    nb = x.shape[0] if x.dim() == 3 else 1
    for name, t, shape in (("g", g, x.shape[:-2] + (n,)),
                           ("mask", mask, (n,))):
        if t is not None and t.shape != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
    if not all(t.is_contiguous() for t in (x, u, v, g, mask)
               if t is not None):
        raise ValueError("oblique_cols takes contiguous row-major tensors")
    out = torch.empty_like(x)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    fn = getattr(build(), f"oblique_cols_{_SUFFIX[x.dtype]}")
    err = fn(x.data_ptr(), ptr(u), ptr(v), ptr(g), ptr(mask), p, n, nb,
             OBLIQUE_MODES[mode], out.data_ptr(), _stream(x))
    if err != 0:
        raise RuntimeError(f"oblique_cols launch failed: CUDA error {err}")
    _launched("oblique_cols", x.dtype)
    OBLIQUE_LAUNCHES["proj_eG" if v is not None else mode] += 1
    if mask is not None:
        OBLIQUE_LAUNCHES["masked"] += 1
    if x.dim() == 3:
        INSTANCE_LAUNCHES["oblique_cols"] += 1
    return out


# -------------------------------------------------------------------- K3 --

def pattern_dots_plain(Y, U, P):
    """Plain twin of K3: the JAX package's pair_dots over the pattern
    (ops/sparse.py pair_dots / ConstraintOp.pattern_pair_dots)."""
    from ..ops.sparse import pair_dots
    return pair_dots(Y, U, P.i, P.j)


def pattern_dots_layout(p, dtype):
    """K3's scratch row length and group size for a (p, n) factor of
    ``dtype``: pp = p rounded up to one 16-B vector, G = the lanes that
    share one entry, the largest power of two that leaves each lane at
    least two of the row's pp / vec vectors (at most 32; the kernel walks
    a row in chunks of 2G vectors, several chunks per pass)."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    pp = -(-p // vec) * vec
    group = 1
    while group < 32 and 4 * group <= pp // vec:
        group *= 2
    return pp, group


def pattern_dots(Y, U, P):
    """K3.  ``Y``, ``U`` (p, n) with any strides (``U`` may be ``Y``);
    ``P`` a column-sorted SymCOO pattern (fields i, j, colptr, n).
    Returns e (nnz,) with e_k = <Y[:, i_k], U[:, j_k]>.  A pattern with a
    ``span`` (c0, c1, r0, r1): warps over its columns only, U's N-major copy
    of columns c0 .. c1-1 and Y's of rows r0 .. r1-1 (one copy over both
    ranges when U is Y)."""
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
    pp, group = pattern_dots_layout(p, Y.dtype)
    same = U.data_ptr() == Y.data_ptr() and U.stride() == Y.stride()
    c0, c1, r0, r1 = pattern_span(P)
    if not 0 <= c0 <= c1 <= n or not 0 <= r0 <= r1 <= n:
        raise ValueError(f"span {(c0, c1, r0, r1)} outside n={n}")
    # the N-major copies the kernel gathers from: Y's rows r0 .. r1-1 and
    # U's columns c0 .. c1-1, or (U is Y) one copy over both ranges
    if same:
        ny = (max(r1, c1) - min(r0, c0)) if r1 > r0 else c1 - c0
    else:
        ny = r1 - r0
    Yt = torch.empty((ny, pp), dtype=Y.dtype, device=Y.device)
    Ut = None if same else torch.empty((c1 - c0, pp), dtype=Y.dtype,
                                       device=Y.device)
    out = torch.empty((P.i.shape[0],), dtype=Y.dtype, device=Y.device)
    fn = getattr(build(), f"pattern_dots_{_SUFFIX[Y.dtype]}")
    err = fn(Y.data_ptr(), Y.stride(0), Y.stride(1),
             None if same else U.data_ptr(), U.stride(0), U.stride(1),
             P.colptr.data_ptr(), P.i.data_ptr(), p, n, pp, group,
             Yt.data_ptr(), None if same else Ut.data_ptr(), out.data_ptr(),
             c0, c1 - c0, r0, r1 - r0, _stream(Y))
    if err != 0:
        raise RuntimeError(f"pattern_dots launch failed: CUDA error {err}")
    _launched("pattern_dots", Y.dtype)
    SPAN_LAUNCHES["pattern_dots"] += (c0, c1, r0, r1) != (0, n, 0, n)
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


# K4's row length above which the thread-per-row plans leave a row to a
# warp of its own (a launch argument of csrc/csr_gather.cu)
CSR_LONG_ROW = 32

# id(ptr) -> (ptr._version, csr_long_rows(ptr)), dropped with the tensor
_LONG_ROWS = {}


def csr_gather_plan(nnz, nrows):
    """K4's mapping from the mean row length nnz / nrows: 0, a thread per
    row taking two rows with 2 loads per row at a time (mean <= 2); 1, a
    thread per row with 4 loads at a time (mean <= 16); 2, a warp per row.
    Both counts are tensor shapes, so the choice needs no read of
    ``ptr``."""
    mean = nnz / max(nrows, 1)
    return 0 if mean <= 2 else 1 if mean <= 16 else 2


def csr_long_rows(ptr):
    """The rows of the CSR pointer ``ptr`` longer than CSR_LONG_ROW,
    ascending, int32 on ``ptr``'s device (empty when there are none): the
    rows K4's thread-per-row plans hand to a warp each.  Host numpy, so it
    reads ``ptr`` back once."""
    lens = np.diff(ptr.cpu().numpy().astype(np.int64))
    rows = np.flatnonzero(lens > CSR_LONG_ROW).astype(np.int32)
    return torch.as_tensor(rows, device=ptr.device)


def cached_long_rows(ptr):
    """csr_long_rows(ptr), built on the first call with this tensor and
    kept while it lives and is not written in place (its version
    counter): an operator's pointers are read back once, not per call."""
    key = id(ptr)
    # an inference tensor keeps no version counter (and is read-only
    # outside inference mode)
    version = -1 if ptr.is_inference() else ptr._version
    hit = _LONG_ROWS.get(key)
    if hit is None:
        weakref.finalize(ptr, _LONG_ROWS.pop, key, None)
    elif hit[0] == version:
        return hit[1]
    rows = csr_long_rows(ptr)
    _LONG_ROWS[key] = (version, rows)
    return rows


def csr_gather(x, ptr, col, val, base=None, alpha=1.0, pos=None,
               size=None):
    """K4.  ``ptr`` (R+1,) int32 delimits R segments of the entries
    (``col`` int32, ``val``); returns y (R,) with
    y_r = base_r + alpha · sum_e val_e · x[col_e] (no ``base``: 0), each
    sum taken in entry order.  ``alpha`` is a Python number.  The rows
    longer than CSR_LONG_ROW go to a warp each (cached_long_rows: the
    first call with a ``ptr`` tensor reads it back on the host).

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
    plan = csr_gather_plan(col.shape[0], nrows)
    long_rows = cached_long_rows(ptr) if plan < 2 and nrows > 0 else None
    if not scatter:
        out = torch.empty((nrows,), dtype=x.dtype, device=x.device)
    elif base is None:
        out = torch.zeros((size,), dtype=x.dtype, device=x.device)
    else:
        out = base.clone()
    fn = getattr(build(), f"csr_gather_{_SUFFIX[x.dtype]}")
    err = fn(x.data_ptr(), ptr.data_ptr(), col.data_ptr(), val.data_ptr(),
             base.data_ptr() if base is not None else None, float(alpha),
             pos.data_ptr() if scatter else None, nrows, plan, CSR_LONG_ROW,
             long_rows.data_ptr() if long_rows is not None else None,
             long_rows.numel() if long_rows is not None else 0,
             out.data_ptr(), _stream(x))
    if err != 0:
        raise RuntimeError(f"csr_gather launch failed: CUDA error {err}")
    _launched("csr_gather", x.dtype)
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
    _launched("masked_sym", E.dtype)
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
    _launched("oa_refine", S.dtype)
    return E, bsum, g1, g2


# -------------------------------------------------------------------- K7 --

def _qn(q: int) -> int:
    return 2 + q + q * q


def _check_slab(q: int, t):
    """K7, K9 and K10 stage a q x q slab (padded to q x (q + 1)) in shared
    memory (K9's border tiles, (2 + 2q) x 33, are smaller wherever the slab
    is near the limit)."""
    if q * (q + 1) * t.element_size() > 227 * 1024:
        raise ValueError(f"q = {q}: the q x q slab exceeds shared memory")


def symdual_apply_plain(M, q: int, scale=None, shift=None):
    """Plain twin of K7: the JAX package's _apply_tensor einsums
    (ops/symdual.py), repeated-index slots set to 0, then y0 - shift and
    the per-degree scale (SymDualOp.y_step)."""
    from ..ops.symdual import _apply_tensor, zero_dontcare
    y = zero_dontcare(_apply_tensor(M, q), q)
    if shift is not None:
        y = (y[0] - shift,) + y[1:]
    if scale is not None:
        y = tuple(t * scale[d] for d, t in enumerate(y))
    return y


def symdual_apply(M, q: int, scale=None, shift=None):
    """K7 on a contiguous (n~, n~) ``M``, n~ = 2 + q + q^2.  Returns the
    per-degree class sums (y0 0-d, y1 (q,), Y2 (q,q), Y3 (q,q,q),
    Y4 (q,q,q,q)) as views of one flat (1+q+q^2+q^3+q^4,) buffer, 0 at
    every repeated-index slot; ``shift`` (0-d) is subtracted from y0 and
    ``scale`` (5,) multiplies degree d by scale[d]."""
    if not _on_cuda(M, scale, shift):
        return symdual_apply_plain(M, q, scale, shift)
    _check_dtype(M.dtype, M, scale, shift)
    n = _qn(q)
    if M.shape != (n, n) or not M.is_contiguous():
        raise ValueError(f"M must be contiguous ({n}, {n}) for q = {q}, got "
                         f"{tuple(M.shape)}")
    if (scale is not None and (scale.shape != (5,) or
                               not scale.is_contiguous())) or \
            (shift is not None and shift.numel() != 1):
        raise ValueError("scale must be contiguous (5,) and shift 0-d")
    _check_slab(q, M)
    sizes = [1, q, q * q, q ** 3, q ** 4]
    y = torch.empty((sum(sizes),), dtype=M.dtype, device=M.device)
    # P2 / P3 (q^4), S3 (q^3) and y0's partial rows (q)
    ws = torch.empty((q ** 4 + q ** 3 + q,), dtype=M.dtype, device=M.device)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    fn = getattr(build(), f"symdual_apply_{_SUFFIX[M.dtype]}")
    err = fn(M.data_ptr(), q, ptr(scale), ptr(shift), y.data_ptr(),
             ws.data_ptr(), _stream(M))
    if err != 0:
        raise RuntimeError(f"symdual_apply launch failed: CUDA error {err}")
    _launched("symdual_apply", M.dtype)
    parts = torch.split(y, sizes)
    return (parts[0].reshape(()), parts[1], parts[2].view(q, q),
            parts[3].view(q, q, q), parts[4].view(q, q, q, q))


def _rows_shape(q: int, ql: int, off: int):
    if ql <= 0 or q % ql or off % ql or not 0 <= off <= q - ql:
        raise ValueError(f"a row block of {ql} rows at offset {off} does not "
                         f"split q = {q} evenly")


def symdual_apply_rows_plain(top, rows, q: int, off: int, a2a, reduce):
    """Plain twin of K7's row-block mode: ops/symdual.py's torch port of
    the JAX apply_sharded, with the same collectives."""
    from ..ops.symdual import _apply_sharded_tensor
    return _apply_sharded_tensor(top, rows, q, off, a2a, reduce)


def symdual_apply_rows(top, rows, q: int, off: int, a2a, reduce):
    """K7's row-block mode (the row-sharded operator of
    parallel/symdual_sharded.py): this rank's ``top`` (2 + q, n~), the
    expanded matrix's first rows (replicated), and ``rows`` (ql, q, n~),
    its Q-grid rows (i, j) for off <= i < off + ql.  ``a2a(send, recv)``
    is the equal-split all-to-all over the D = q / ql ranks (block g of
    dim 0 to rank g) and ``reduce(t)`` the sum over them in place.
    Returns (y0, y1, Y2, Y3, Y4_local): y0 .. Y3 whole on every rank (views
    of one flat buffer), Y4's rows [off, off + ql) (ql, q, q, q); every
    repeated-index slot 0.  One all-reduce (of the flat 1 + q + q^2 + q^3
    partial) and, at D > 1, two all-to-alls (``a2a`` is never called at
    D = 1); the rank with off = 0 adds the replicated rows' terms.  No
    shared memory depends on q, so q has no ceiling.  Workspace: q^3 + q +
    q^4 entries at D = 1, q^3 + q + 2 q^4 / D at D > 1."""
    ql = rows.shape[0]
    _rows_shape(q, ql, off)
    if not _on_cuda(top, rows):
        return symdual_apply_rows_plain(top, rows, q, off, a2a, reduce)
    _check_dtype(top.dtype, top, rows)
    n = _qn(q)
    if top.shape != (2 + q, n) or rows.shape != (ql, q, n) or \
            not (top.is_contiguous() and rows.is_contiguous()):
        raise ValueError(f"top must be contiguous ({2 + q}, {n}) and rows "
                         f"({ql}, {q}, {n}), got {tuple(top.shape)}, "
                         f"{tuple(rows.shape)}")
    D, dev, dt = q // ql, top.device, top.dtype
    flat = torch.empty((1 + q + q * q + q ** 3,), dtype=dt, device=dev)
    y4 = torch.empty((ql, q, q, q), dtype=dt, device=dev)
    blk = ql * q ** 3
    # S3, y0's partial rows, P2 (send1 / send2 at D > 1) and, at D > 1,
    # recv1 / recv2
    nbuf = 1 if D == 1 else 2
    ws = torch.empty((q ** 3 + q + nbuf * blk,), dtype=dt, device=dev)
    bufs = [ws[q ** 3 + q + k * blk:q ** 3 + q + (k + 1) * blk].view(D, -1)
            for k in range(nbuf)]
    fn = getattr(build(), f"symdual_apply_rows_{_SUFFIX[dt]}")
    # one rank: the pair pass and the final pass, no exchange; several:
    # the pack, then an all-to-all after it and after the pair pass
    for stage in ((1, 2) if D == 1 else (0, 1, 2)):
        err = fn(top.data_ptr(), rows.data_ptr(), q, off, ql, int(off == 0),
                 stage, flat.data_ptr(), y4.data_ptr(), ws.data_ptr(),
                 _stream(top))
        if err != 0:
            raise RuntimeError(f"symdual_apply launch failed: CUDA error "
                               f"{err}")
        if D > 1 and stage < 2:
            a2a(*bufs)
    reduce(flat)
    _launched("symdual_apply", dt)
    SYMDUAL_APPLY_LAUNCHES["rows"] += 1
    parts = torch.split(flat, [1, q, q * q, q ** 3])
    return (parts[0].reshape(()), parts[1], parts[2].view(q, q),
            parts[3].view(q, q, q), y4)


# -------------------------------------------------------------------- K8 --

def symdual_adjoint_plain(y, q: int, scale=None, B1=None, c1=0.0, B2=None,
                          c2=0.0):
    """Plain twin of K8 ``adjoint``: the JAX package's _adjoint_tensor
    where-chain of the per-degree tuple ``y`` (scaled by ``scale`` first),
    plus c1 · B1 + c2 · B2."""
    from ..ops.symdual import _adjoint_tensor
    if scale is not None:
        y = tuple(t * scale[d] for d, t in enumerate(y))
    W = _adjoint_tensor(*y, q)
    if B1 is not None:
        W = W + c1 * B1
    if B2 is not None:
        W = W + c2 * B2
    return W


def symdual_adjoint(y, q: int, scale=None, B1=None, c1=0.0, B2=None,
                    c2=0.0):
    """K8 ``adjoint``: the (n~, n~) matrix whose entry (u, v) is the class
    value of (u, v) from the tuple ``y`` = (y0, y1, Y2, Y3, Y4) (degree d
    times scale[d] when ``scale`` (5,) is given), plus c1 · B1 + c2 · B2
    for the optional (n~, n~) ``B1``, ``B2``; c1, c2 are Python numbers.
    Repeated-index slots of Y2..Y4 are never read."""
    if len(y) != 5:
        raise ValueError("y must be the 5-tuple (y0, y1, Y2, Y3, Y4)")
    if not _on_cuda(*y, scale, B1, B2):
        return symdual_adjoint_plain(y, q, scale, B1, c1, B2, c2)
    dt = y[4].dtype
    _check_dtype(dt, *y, scale, B1, B2)
    n = _qn(q)
    shapes = [(), (q,), (q, q), (q, q, q), (q, q, q, q)]
    if any(t.numel() != max(1, q ** d) or (d and tuple(t.shape) != s)
           for d, (t, s) in enumerate(zip(y, shapes))):
        raise ValueError(f"y's shapes do not match q = {q}")
    if any(t is not None and (t.shape != (n, n) or not t.is_contiguous())
           for t in (B1, B2)) or \
            (scale is not None and scale.shape != (5,)):
        raise ValueError(f"B1 / B2 must be contiguous ({n}, {n}) and scale "
                         "(5,)")
    y = [t.contiguous() for t in y]
    scale = scale.contiguous() if scale is not None else None
    out = torch.empty((n, n), dtype=dt, device=y[4].device)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    fn = getattr(build(), f"symdual_adjoint_{_SUFFIX[dt]}")
    err = fn(*(t.data_ptr() for t in y), q, ptr(scale), ptr(B1), float(c1),
             ptr(B2), float(c2), out.data_ptr(), _stream(out))
    if err != 0:
        raise RuntimeError(f"symdual_adjoint launch failed: CUDA error {err}")
    _launched("symdual_adjoint", dt)
    SYMDUAL_LAUNCHES["adjoint" if B1 is None and B2 is None
                     else "residual"] += 1
    return out


def symdual_adjoint_rows_plain(y, q: int, off: int):
    """Plain twin of K8's row-block mode: ops/symdual.py's torch port of
    the JAX adjoint_sharded."""
    from ..ops.symdual import _adjoint_sharded_tensor
    return _adjoint_sharded_tensor(*y, q, off)


def symdual_adjoint_rows(y, q: int, off: int):
    """K8 ``adjoint`` in row-block mode: y = (y0, y1, Y2, Y3, Y4_local) with
    y0 .. Y3 whole and Y4_local the rows [off, off + ql) (ql, q, q, q).
    Returns (top (2 + q, n~), rows (ql q, n~)): the adjoint's first rows
    and its Q rows (i, j) for off <= i < off + ql.  No communication."""
    if len(y) != 5:
        raise ValueError("y must be the 5-tuple (y0, y1, Y2, Y3, Y4_local)")
    ql = y[4].shape[0]
    _rows_shape(q, ql, off)
    if not _on_cuda(*y):
        return symdual_adjoint_rows_plain(y, q, off)
    dt = y[4].dtype
    _check_dtype(dt, *y)
    shapes = [(), (q,), (q, q), (q, q, q), (ql, q, q, q)]
    if y[0].numel() != 1 or any(tuple(t.shape) != sh for t, sh in
                                zip(y[1:], shapes[1:])):
        raise ValueError(f"y's shapes do not match q = {q}, {ql} rows")
    y = [t.contiguous() for t in y]
    n = _qn(q)
    top = torch.empty((2 + q, n), dtype=dt, device=y[4].device)
    rows = torch.empty((ql * q, n), dtype=dt, device=y[4].device)
    fn = getattr(build(), f"symdual_adjoint_rows_{_SUFFIX[dt]}")
    err = fn(*(t.data_ptr() for t in y), q, off, ql, top.data_ptr(),
             rows.data_ptr(), _stream(top))
    if err != 0:
        raise RuntimeError(f"symdual_adjoint launch failed: CUDA error {err}")
    _launched("symdual_adjoint", dt)
    SYMDUAL_LAUNCHES["adjoint_rows"] += 1
    return top, rows


def symdual_sym_factor_plain(Y, q: int, renorm: bool = True):
    """Plain twin of K8 ``sym_factor``: the JAX package's _symmetrize_jit."""
    from ..ops.symdual import _symmetrize
    return _symmetrize(Y, q, renorm)


def symdual_sym_factor(Y, q: int, renorm: bool = True):
    """K8 ``sym_factor`` on a contiguous (p, n~) factor: every column
    averaged with its duplicate partner, then (``renorm``) divided by
    max(its norm, 1e-30)."""
    if not _on_cuda(Y):
        return symdual_sym_factor_plain(Y, q, renorm)
    _check_dtype(Y.dtype, Y)
    if Y.dim() != 2 or Y.shape[1] != _qn(q) or not Y.is_contiguous():
        raise ValueError(f"Y must be contiguous (p, {_qn(q)}), got "
                         f"{tuple(Y.shape)}")
    out = torch.empty_like(Y)
    fn = getattr(build(), f"symdual_sym_factor_{_SUFFIX[Y.dtype]}")
    err = fn(Y.data_ptr(), Y.shape[0], q, int(bool(renorm)), out.data_ptr(),
             _stream(Y))
    if err != 0:
        raise RuntimeError(f"symdual_adjoint launch failed: CUDA error {err}")
    _launched("symdual_adjoint", Y.dtype)
    SYMDUAL_LAUNCHES["sym_factor"] += 1
    return out


def symdual_sym_mat_plain(M, q: int):
    """Plain twin of K8 ``sym_mat``: SymDualOp.symmetrize_mat of the JAX
    package (the column projector along both axes)."""
    from ..ops.symdual import _symmetrize
    return _symmetrize(_symmetrize(M, q, False).T, q, False).T


def symdual_sym_mat(M, q: int):
    """K8 ``sym_mat`` on a contiguous (n~, n~) ``M``: every entry averaged
    over its 4-element copy orbit."""
    if not _on_cuda(M):
        return symdual_sym_mat_plain(M, q)
    _check_dtype(M.dtype, M)
    n = _qn(q)
    if M.shape != (n, n) or not M.is_contiguous():
        raise ValueError(f"M must be contiguous ({n}, {n}), got "
                         f"{tuple(M.shape)}")
    out = torch.empty_like(M)
    fn = getattr(build(), f"symdual_sym_mat_{_SUFFIX[M.dtype]}")
    err = fn(M.data_ptr(), q, out.data_ptr(), _stream(M))
    if err != 0:
        raise RuntimeError(f"symdual_adjoint launch failed: CUDA error {err}")
    _launched("symdual_adjoint", M.dtype)
    SYMDUAL_LAUNCHES["sym_mat"] += 1
    return out


# ------------------------------------------------------------------- K9 --

def symmom_flat_length(q: int) -> int:
    """Length of K9's flat layout, 1 + q + 3q^2 + 2q^3 + q^4."""
    return 1 + q + 3 * q * q + 2 * q ** 3 + q ** 4


def symmom_apply_plain(M, q: int):
    """Plain twin of K9: the JAX package's _apply_jit (ops/symmom.py)."""
    from ..ops.symmom import apply_plain
    return apply_plain(M, q)


def symmom_apply_workspace(q: int) -> int:
    """Entries of K9's workspace: V, then cT, over the unordered pairs
    (P^2, P = q(q - 1)/2), and the border rows of Ms ((2 + 2q) n~)."""
    P = q * (q - 1) // 2
    return P * P + (2 + 2 * q) * _qn(q)


def symmom_apply(M, q: int):
    """K9 on a contiguous (n~, n~) ``M``, n~ = 2 + q + q^2: the bqpmom rows
    of Sym(M) in the flat (1 + q + 3q^2 + 2q^3 + q^4,) layout, every
    don't-care slot 0."""
    if not _on_cuda(M):
        return symmom_apply_plain(M, q)
    _check_dtype(M.dtype, M)
    n = _qn(q)
    if M.shape != (n, n) or not M.is_contiguous():
        raise ValueError(f"M must be contiguous ({n}, {n}) for q = {q}, got "
                         f"{tuple(M.shape)}")
    m = symmom_flat_length(q)
    if m >= 2 ** 31:
        raise ValueError(f"q = {q}: the flat length {m} exceeds int32")
    _check_slab(q, M)
    ws = torch.empty((symmom_apply_workspace(q),), dtype=M.dtype,
                     device=M.device)
    out = torch.empty((m,), dtype=M.dtype, device=M.device)
    fn = getattr(build(), f"symmom_apply_{_SUFFIX[M.dtype]}")
    err = fn(M.data_ptr(), q, ws.data_ptr(), out.data_ptr(), _stream(M))
    if err != 0:
        raise RuntimeError(f"symmom_apply launch failed: CUDA error {err}")
    _launched("symmom_apply", M.dtype)
    return out


# ------------------------------------------------------------------- K10 --

def symmom_adjoint_plain(y, q: int, base=None, alpha=1.0):
    """Plain twin of K10: the JAX package's _adjoint_jit (ops/symmom.py),
    then base + alpha * A'(y)."""
    from ..ops.symmom import adjoint_plain
    W = adjoint_plain(y, q)
    return alpha * W if base is None else base + alpha * W


def symmom_adjoint(y, q: int, base=None, alpha=1.0):
    """K10 on a contiguous flat (m,) ``y``: the (n~, n~) matrix
    base + alpha * A'(y) (no ``base``: alpha * A'(y)); ``alpha`` is a
    Python number.  Don't-care slots of y are never read."""
    if not _on_cuda(y, base):
        return symmom_adjoint_plain(y, q, base, alpha)
    _check_dtype(y.dtype, y, base)
    n = _qn(q)
    m = symmom_flat_length(q)
    if y.shape != (m,) or not y.is_contiguous():
        raise ValueError(f"y must be contiguous ({m},) for q = {q}, got "
                         f"{tuple(y.shape)}")
    if base is not None and (base.shape != (n, n) or
                             not base.is_contiguous()):
        raise ValueError(f"base must be contiguous ({n}, {n})")
    _check_slab(q, y)
    # the small coefficient vectors (1 + 2q + 2q^2), then Tacc (q^4)
    ws = torch.empty((1 + 2 * q + 2 * q * q + q ** 4,), dtype=y.dtype,
                     device=y.device)
    out = torch.empty((n, n), dtype=y.dtype, device=y.device)
    fn = getattr(build(), f"symmom_adjoint_{_SUFFIX[y.dtype]}")
    err = fn(y.data_ptr(), q, base.data_ptr() if base is not None else None,
             float(alpha), ws.data_ptr(), out.data_ptr(), _stream(y))
    if err != 0:
        raise RuntimeError(f"symmom_adjoint launch failed: CUDA error {err}")
    _launched("symmom_adjoint", y.dtype)
    return out


# ------------------------------------------------------------------- K11 --
# The tCG scalar state of each instance: sc (B, 8) in the vectors' dtype,
# columns e_Pe, e_Pd, d_Pd, z_r = <r, r>, model value, Delta^2, kappa
# target, linear (1.0: a met target is stop code 3, else 4); st (B, 2)
# int32, columns j (completed iterations) and stop (0 = active).  An
# instance whose stop is not 0 is left as it is.  The vectors are
# (B, ...) tensors, instance b at index b.  The kernel updates its vector
# arguments in place and returns them; the twins return new tensors.
# Callers use what is returned.  The twins of the step's three phases
# (dots, update, finish) keep the earlier three-pass split, so each can be
# held to the JAX tCG body on its own.

def tcg_blocks(L: int) -> int:
    """Blocks per instance of K11's three passes (a function of L only,
    so the order of every sum is fixed)."""
    return max(1, min(-(-L // 1024), 512))


def _per(s, like):
    """A (B,) scalar shaped to broadcast against the (B, ...) ``like``."""
    return s.view((-1,) + (1,) * (like.dim() - 1))


def _inst_sum(t):
    return torch.sum(t, dim=tuple(range(1, t.dim())))


def tcg_dots_plain(d, Hd, r, st):
    """Plain twin of K11 ``dots``: (<d, Hd>, <d, r>) per instance, the
    JAX package's inner products in _make_tcg, 0 for a stopped instance,
    as one partial (B, 1, 2)."""
    dots = torch.stack([_inst_sum(d * Hd), _inst_sum(d * r)], dim=1)
    act = (st[:, 1] == 0)[:, None]
    return torch.where(act, dots, torch.zeros_like(dots))[:, None, :]


def tcg_update_plain(part, sc, st, d, Hd, eta, Heta, r):
    """Plain twin of K11 ``update``: the step of the JAX package's tCG body
    (core/trustregions.py:102-139) with the scalars of each instance.
    Returns (eta, Heta, r, part2 (B, 1) = ||r||^2, xs (B, 4) = alpha, next
    e_Pe, next model value, stop code)."""
    dots = torch.sum(part, dim=1)
    d_Hd, d_r = dots[:, 0], dots[:, 1]
    e_Pe, e_Pd, d_Pd, z_r, mv, DD = sc[:, :6].unbind(1)
    alpha = z_r / d_Hd
    e_Pe_new = e_Pe + 2.0 * alpha * e_Pd + alpha * alpha * d_Pd
    boundary = (d_Hd <= 0.0) | (e_Pe_new >= DD)
    # exact boundary solve (tCG.m:188)
    tau = (-e_Pd + torch.sqrt(e_Pd * e_Pd + d_Pd * (DD - e_Pe))) / d_Pd
    step = torch.where(boundary, tau, alpha)
    # incremental model value m(eta - t d) = m(eta) - t<d, r>
    # + t^2/2 <d, Hd>
    new_mv = mv - step * d_r + 0.5 * step * step * d_Hd
    model_inc = (~boundary) & (new_mv >= mv)
    code = lambda c: torch.full_like(alpha, c)  # noqa: E731
    stop_n = torch.where(boundary,
                         torch.where(d_Hd <= 0.0, code(1), code(2)),
                         torch.where(model_inc, code(6), code(0)))
    act = st[:, 1] == 0
    # on model increase (stop 6) keep the PREVIOUS iterate
    keep = _per(model_inc | ~act, d)
    eta = torch.where(keep, eta, eta - _per(step, d) * d)
    Heta = torch.where(keep, Heta, Heta - _per(step, d) * Hd)
    r_n = r - _per(alpha, d) * Hd
    r_r = _inst_sum(r_n * r_n)
    xs = torch.stack([alpha, torch.where(boundary, e_Pe, e_Pe_new),
                      torch.where(model_inc, mv, new_mv), stop_n], dim=1)
    return (eta, Heta, torch.where(_per(act, d), r_n, r),
            torch.where(act, r_r, torch.zeros_like(r_r))[:, None], xs)


def tcg_finish_plain(part2, sc, st, xs, r, d, mininner: int):
    """Plain twin of K11 ``finish``: the stop codes 3 / 4, beta and the
    e_Pd / d_Pd recurrences of the JAX package's tCG body
    (core/trustregions.py:141-160).  Returns (r + beta d, to be
    re-projected onto the tangent space, and the next sc, st)."""
    r_r = torch.sum(part2, dim=1)
    alpha, e_Pe_n, mv_n, stop_f = xs.unbind(1)
    j, stop = st.unbind(1)
    stop_n = stop_f.to(torch.int32)
    hit_kappa = (stop_n == 0) & (j + 1 >= mininner) & \
        (torch.sqrt(r_r) <= sc[:, 6])
    stop_n = torch.where(hit_kappa,
                         torch.where(sc[:, 7] > 0, 3, 4).to(torch.int32),
                         stop_n)
    beta = r_r / sc[:, 3]
    act = (stop == 0)[:, None]
    e_Pd_n = beta * (sc[:, 1] + alpha * sc[:, 2])
    d_Pd_n = r_r + beta * beta * sc[:, 2]
    sc_n = torch.stack([e_Pe_n, e_Pd_n, d_Pd_n, r_r, mv_n, sc[:, 5],
                        sc[:, 6], sc[:, 7]], dim=1)
    st_n = torch.stack([j + 1, stop_n], dim=1).to(torch.int32)
    # a stopped instance's direction is never read again
    return (r + _per(beta, d) * d, torch.where(act, sc_n, sc),
            torch.where(act, st_n, st))


def tcg_step_plain(d, Hd, eta, Heta, r, sc, st, mininner: int, Y=None,
                   mask=None, reduce=None):
    """Plain twin of K11: the three phases' twins, then with ``Y`` the
    oblique tangent projection of the next direction (K2's
    oblique_cols_plain proj, with ``mask`` the masked product's); with
    ``reduce`` (split mode) each phase's partial goes through it first.
    Returns (eta, Heta, r, d, sc_next, st_next)."""
    part = tcg_dots_plain(d, Hd, r, st)
    if reduce is not None:
        part = reduce(part)
    eta, Heta, r, part2, xs = tcg_update_plain(part, sc, st, d, Hd, eta,
                                               Heta, r)
    if reduce is not None:
        part2 = reduce(part2)
    d, sc, st = tcg_finish_plain(part2, sc, st, xs, r, d, mininner)
    if Y is not None:
        d = oblique_cols_plain(Y, d, "proj", mask=mask)
    return eta, Heta, r, d, sc, st


def tcg_step(d, Hd, eta, Heta, r, sc, st, mininner: int, Y=None,
             mask=None, reduce=None, peer=None):
    """K11: one tCG iteration's vector step in one cooperative launch.
    From d, Hd = H[d] and the scalar state: the step of every active
    instance (eta, Heta unless the model increased, r <- r - alpha Hd),
    the stop codes, and the next direction d <- r + beta d, or with ``Y``
    (the (B, p, n) point; ``mask`` (n,) the masked product's column mask)
    d <- proj_Y(r + beta d), the oblique tangent projection of K2.
    eta, Heta, r and d ((B, ...) tensors of one shape and dtype) are
    updated in place (a contiguous copy of one that is not) and returned:
    (eta, Heta, r, d, sc_next, st_next).

    Split mode (``reduce`` given: the vectors are this rank's block of
    vectors sharded over several ranks): three launches, the dots, the
    update and the finish, with ``reduce(t)`` (the sum of ``t`` over the
    ranks, in place; returns it) on the partials between them, (B, nblk,
    2) and (B, nblk).  Every rank must hold blocks of one size.  At one
    rank it gives the one launch's bits.

    Peer mode (``peer`` given, ``parallel.peer.PeerSums`` of the ranks'
    group): the one launch, its partials written into every rank's
    receive buffer and summed there in rank order after a barrier across
    the ranks on the device (csrc/tcg_step.cu).  Every rank must make the
    same calls.  On CPU tensors the twin sums through ``peer.plain``
    (``parallel.distributed.ordered_sum``: the same order)."""
    if reduce is not None and peer is not None:
        raise ValueError("K11 takes reduce (split mode) or peer, not both")
    if not _on_cuda(d, Hd, eta, Heta, r, sc, st, Y, mask):
        return tcg_step_plain(d, Hd, eta, Heta, r, sc, st, mininner, Y,
                              mask, reduce if peer is None else peer.plain)
    dt, shape = d.dtype, d.shape
    B = shape[0]
    d, Hd, eta, Heta, r = (t.contiguous() for t in (d, Hd, eta, Heta, r))
    for t in (Hd, eta, Heta, r):
        if t.dtype != dt or t.shape != shape:
            raise ValueError(f"K11 takes {dt} vectors of shape "
                             f"{tuple(shape)}, got {tuple(t.shape)} "
                             f"{t.dtype}")
    if dt not in _SUFFIX or len(shape) < 2:
        raise ValueError(f"K11 takes (B, ...) float64 or float32 vectors, "
                         f"got {tuple(shape)} {dt}")
    if sc.dtype != dt or sc.shape != (B, 8) or not sc.is_contiguous():
        raise ValueError(f"sc must be contiguous ({B}, 8) {dt}")
    if st.dtype != torch.int32 or st.shape != (B, 2) or \
            not st.is_contiguous():
        raise ValueError(f"st must be contiguous ({B}, 2) int32")
    L = d.numel() // B
    p = n = 0
    if Y is not None:
        if len(shape) != 3 or Y.shape != shape or Y.dtype != dt:
            raise ValueError(f"Y must be {tuple(shape)} {dt}, like the "
                             f"(B, p, n) vectors")
        Y = Y.contiguous()
        p, n = shape[1], shape[2]
        if mask is not None and (mask.shape != (n,) or mask.dtype != dt or
                                 not mask.is_contiguous()):
            raise ValueError(f"mask must be contiguous ({n},) {dt}")
    elif mask is not None:
        raise ValueError("a mask goes with Y")
    nblk = tcg_blocks(L)
    # partials (B, nblk, 2), (B, nblk), step scalars (B, 4), next sc (B, 8)
    ws = torch.empty((B * (3 * nblk + 12),), dtype=dt, device=d.device)
    part2 = ws[2 * B * nblk:]
    xs = part2[B * nblk:]
    sc_n = xs[4 * B:].view(B, 8)
    st_n = torch.empty_like(st)
    # peer mode: the partials go to the receive buffers, not to ws
    bufs = None if peer is None else peer.buffers(B, nblk, dt, d.device)
    args = (d.data_ptr(), Hd.data_ptr(), eta.data_ptr(), Heta.data_ptr(),
            r.data_ptr(), sc.data_ptr(), st.data_ptr(),
            Y.data_ptr() if Y is not None else None,
            mask.data_ptr() if mask is not None else None, L, B, nblk, p, n,
            int(mininner),
            ws.data_ptr() if bufs is None else bufs.part,
            part2.data_ptr() if bufs is None else bufs.part2,
            xs.data_ptr(), sc_n.data_ptr(), st_n.data_ptr())
    step = getattr(build(), f"tcg_step_{_SUFFIX[dt]}")
    if bufs is not None:
        err = step(*args, -1, bufs.ptrs.data_ptr(), bufs.me, bufs.world,
                   bufs.next_epoch(), _stream(d))
    elif reduce is None:
        err = step(*args, -1, None, 0, 1, 0, _stream(d))
    else:
        sums = (ws[:2 * B * nblk].view(B, nblk, 2),
                part2[:B * nblk].view(B, nblk))
        for phase in range(3):
            err = step(*args, phase, None, 0, 1, 0, _stream(d))
            if err != 0:
                break
            if phase < 2:
                reduce(sums[phase])
    if err != 0:
        raise RuntimeError(f"tcg_step launch failed: CUDA error {err}")
    _launched("tcg_step", dt)
    if Y is not None:
        TCG_LAUNCHES["projected"] += 1
    if reduce is not None:
        TCG_LAUNCHES["split"] += 1
    if bufs is not None:
        TCG_LAUNCHES["peer"] += 1
    return eta, Heta, r, d, sc_n, st_n


__all__ = ["LAUNCHES", "SPMM_LAUNCHES", "CSR_LAUNCHES", "MASKED_LAUNCHES",
           "OBLIQUE_LAUNCHES", "SYMDUAL_LAUNCHES", "reset_launches", "symcoo_spmm", "symcoo_spmm_plain",
           "oblique_cols", "oblique_cols_plain", "pattern_dots",
           "pattern_dots_plain", "csr_gather", "csr_gather_plain",
           "masked_sym", "masked_sym_plain", "oa_refine", "oa_refine_plain",
           "symdual_apply", "symdual_apply_plain", "symdual_apply_rows",
           "symdual_apply_rows_plain", "SYMDUAL_APPLY_LAUNCHES",
           "symdual_adjoint", "symdual_adjoint_plain",
           "symdual_adjoint_rows", "symdual_adjoint_rows_plain",
           "symdual_sym_factor",
           "symdual_sym_factor_plain", "symdual_sym_mat",
           "symdual_sym_mat_plain", "symmom_apply", "symmom_apply_plain",
           "symmom_flat_length",
           "symmom_adjoint", "symmom_adjoint_plain", "INSTANCE_LAUNCHES",
           "TCG_LAUNCHES", "TCG_TIMEOUT_STOP", "tcg_blocks", "tcg_dots_plain",
           "tcg_update_plain", "tcg_finish_plain", "tcg_step",
           "tcg_step_plain", "build"]
