"""Primal augmented-Lagrangian drivers for SDPs with affine constraints
(PyTorch port of manisdp_tpu/solvers/primal_al.py).

One outer loop covers three reference drivers that differ only in
manifold, dual shift and bookkeeping:

  - unitdiag   (oblique):   min <C,X> s.t. A(X)=b, diag(X)=1, X>=0
                (src/primal/ManiSDP_unitdiag.m)
  - unittrace  (sphere):    min <C,X> s.t. A(X)=b, tr(X)=1, X>=0
                (src/primal/ManiSDP_unittrace.m)
  - general    (euclidean): min <C,X> s.t. A(X)=b, X>=0
                (src/primal/ManiSDP.m)

The constraint operator is picked by the JAX package's ladder
(``config.al_op_mode``): the entrywise carrier (matrix-completion class,
n <= entrywise_al_max_n), the dense carrier (n <= dense_al_max_n), else
the factored ``ConstraintOp``.  On the factored operator every
per-iteration quantity lives on the union pattern P of {C} U {A_k}: the
pair dots e_P = <Y[:,i], Y[:,j]> (kernel K3), A(YYᵀ) and the adjoint
mat(c + sigma Aᵀw) on P (kernel K4), and the pattern products
Y·mat(vals) with the AL Hessian's epilogue (kernel K1); X is never formed
on the device.  On a carrier the pattern values are dense (n, n) arrays:
the Gram YᵀU and the products are GEMMs, A and its adjoint K4 gathers /
scatters or kernel K5.  The dual certificate is a device eigh of the
dense S at small n, the device LOBPCG class otherwise, or on a carrier
with cert_method="dense_eigh" the f32-eigh + refinement certificate
(``ops/dense_cert.py``, kernel K6).  An operator over a redundant basis
(``ops/symmom.SymMomOp``, the BQP moment relaxation on kernels K9 and
K10) is taken as it is: the solver projects its factor onto the
duplicate-symmetric subspace at the JAX package's three sites and
certifies in the compressed original basis.

The constraint matrices A_k and C are assumed symmetric (SeDuMi
semantics), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import SolverOptions, merged_options
from ..core import Problem, TROptions, make_trustregions
from ..manifolds import Euclidean, Oblique, Sphere
from ..ops.dense_cert import DenseEighCert
from ..ops.eigs import lobpcg_certificate
from ..ops.eigs_rr import DeviceCertSolver
from ..ops.sparse import ConstraintOp, EntrywiseConstraintOp
from ..parallel.distributed import broadcast
from ..parallel.mesh import mesh_axis
from ..parallel.sharded_ops import (ShardedConstraintOp, build_on_mesh,
                                    model_axis)
from .common import (RankController, SDPResult, SlowProgress, bucketed,
                     current, log_iter, make_line_search, mixed_prestage,
                     pad_rows, recorded, resolve_device)


@dataclasses.dataclass(frozen=True)
class ALVariant:
    name: str                  # key into VARIANT_DEFAULTS
    manifold: type
    shift: str                 # "diag" | "trace" | "none"
    nne_floor: bool
    slow_period: int
    slow_warmup: int


VARIANTS = {
    "unitdiag": ALVariant("unitdiag", Oblique, "diag", True, 50, 100),
    "unittrace": ALVariant("unittrace", Sphere, "trace", False, 20, 50),
    "general": ALVariant("general", Euclidean, "none", False, 20, 50),
}

# the factored operators: one card's, and its shards over a mesh axis
FACTORED = (ConstraintOp, ShardedConstraintOp)


def _make_problem(variant: ALVariant):
    """cost/grad/hess with explicit aux flow.

    params = dict(op=operator, y=residual-space repr, sigma=Python float).
    aux    = (Axb, e_P): AL residual and pattern pair-dots.
    gaux   = (es, extra): eS on P and the variant's shift byproduct.
    """
    M = variant.manifold

    def cost(Y, params):
        op, y, sigma = params["op"], params["y"], params["sigma"]
        e = op.pattern_pair_dots(Y)
        cx = op.dot_pattern(op.c_pattern, e)
        Axb = op.apply_from_e(e) - op.b - y / sigma
        f = cx + 0.5 * sigma * op.dot_res(Axb, Axb)
        return f, (Axb, e)

    def grad(Y, params, aux):
        op, sigma = params["op"], params["sigma"]
        Axb, e = aux
        es = op.es_vals(Axb, sigma)
        eG = 2.0 * op.matmat_pattern(Y, es)
        if variant.shift == "diag":
            YeG = torch.sum(Y * eG, dim=0)
            return eG - Y * YeG[None, :], (es, YeG)
        if variant.shift == "trace":
            z = op.dot_pattern(es, e)
            return eG - 2.0 * z * Y, (es, z)
        return eG, (es, None)

    def hess(Y, U, params, aux, gaux):
        # eH = 2 U mat(es) + 4 sigma Y mat(A'A vec(Y'U)), then the shift
        # epilogue.  On the factored operator K1's al_hess mode fuses both
        # products (and, on one card, the diag epilogue; sharded, the
        # epilogue follows the sum of the shards); on a carrier they are
        # two GEMMs.  The trace epilogue's global sum stays in torch.
        op, sigma = params["op"], params["sigma"]
        es, extra = gaux
        ayu = op.normal_factored(Y, U)
        coefs = (2.0, 4.0 * sigma)
        diag = variant.shift == "diag"
        if isinstance(op, FACTORED):
            eH = op.al_hess(U, Y, es, ayu, coefs, eG=extra if diag else None)
            if diag:
                return eH
        else:
            eH = torch.addmm(U @ es, Y, ayu, beta=coefs[0], alpha=coefs[1])
            if diag:
                return eH - Y * torch.sum(Y * eH, dim=0, keepdim=True) \
                    - U * extra[None, :]
        if variant.shift == "trace":
            return eH - torch.sum(eH * Y) * Y - 2.0 * extra * U
        return eH

    def cost_only(Y, params):
        return cost(Y, params)[0]

    return Problem(manifold=M, cost=cost, grad=grad, hess=hess), cost_only


def _make_stats(variant: ALVariant):
    """Post-RTR residuals, multiplier update and dual values."""

    def stats(Y, op, y, sigma):
        e = op.pattern_pair_dots(Y)
        obj = op.dot_pattern(op.c_pattern, e)
        Axb = op.apply_from_e(e) - op.b
        normb = 1.0 + op.norm_res(op.b)
        pinf = op.norm_res(Axb) / normb
        y_new = y - sigma * Axb
        sv = op.s_vals(y_new)                        # c - A'y on P
        by = op.dot_res(op.b, y_new)
        if variant.shift == "diag":
            # colsum_pattern(sv * e); on the factored operator that is
            # colsum(Y o Y mat(sv)), K1's cost epilogue
            z = op.quad_cols(Y, sv) if isinstance(op, FACTORED) else \
                op.colsum_pattern(sv * e)
            by = by + torch.sum(z)
        elif variant.shift == "trace":
            z = op.dot_pattern(sv, e)
            by = by + z
        else:
            z = torch.zeros((), dtype=Y.dtype, device=Y.device)
        gap = torch.abs(obj - by) / (torch.abs(by) + torch.abs(obj) + 1.0)
        return obj, pinf, y_new, sv, z, by, gap

    return stats


def _dense_s(variant: ALVariant, op, sv, z):
    """The dense S = mat(sv) - shift(z) as a new (n, n) array (on a carrier
    sv already is mat(sv))."""
    S = op.pattern_dense(sv) if isinstance(op, FACTORED) else sv.clone()
    if variant.shift != "none":
        S.diagonal().sub_(z)
    return S


def _make_certificate(variant: ALVariant, op, n: int, k: int,
                      use_eigh: bool, opt: SolverOptions,
                      gen: torch.Generator):
    """Eigen-certificate of S = mat(sv) - shift(z).  Returns
    cert(Y, sv, z, gap, pinf) -> (lam_min, lam_max, num_neg,
    neg_vecs (n, k) on the device, neg_vals).

    On a ShardedConstraintOp (``mesh=``): at ``use_eigh`` the dense S of
    the all-reduced sv, eigh'd on the axis's first rank and broadcast;
    otherwise ``cert_method``'s certificate as on one card, on the
    all-reduced matvec, ``gen`` seeded alike on every rank (the JAX
    sharded path always takes the lobpcg certificate, which does not
    certify matrix completion: ROADMAP Queue C)."""
    factored = isinstance(op, FACTORED)
    sharded = isinstance(op, ShardedConstraintOp)
    if getattr(op, "compress_coef", None) is not None:
        # expanded-basis operator (SymMomOp): certify the original-basis
        # S = mat(c - A'y) - diag(z), z = colsum(S o X) (the reference's
        # ManiSDP_unitdiag.m:65-69) with the dense f32-eigh + refinement
        # engine; checked before use_eigh, since n~ < eig_switch_n at small q
        dc = DenseEighCert(op.n_orig, k)
        s2 = float(np.sqrt(2.0))

        def cert(Y, sv, z, gap=np.inf, pinf=np.inf):
            Yo = Y.index_select(1, op.dup0)
            Xo = Yo.T @ Yo
            So = op.compress_coef(sv)
            Mo = So - torch.diag(torch.sum(So * Xo, dim=0))
            Mo = 0.5 * (Mo + Mo.T)
            far = max(gap, pinf) > max(opt.cert_cheap_eta, opt.tol)
            res = dc.certify(Mo, far, opt.tol)
            # a unit original eigenvector lifts to norm sqrt(2) on the
            # duplicated basis: scale the unit lift back up, so the escape
            # step matches the reference trajectory
            vecs = s2 * op.lift_vecs(res.neg_vecs[:, :k])
            vals = torch.full((k,), np.nan, dtype=vecs.dtype,
                              device=vecs.device)
            vals[0] = res.lam_min
            return res.lam_min, res.lam_max, res.num_neg, vecs, vals
        return cert

    if (not factored and not use_eigh and opt.eig_method == "auto" and
            n <= opt.dense_cert_max_n and opt.cert_method == "dense_eigh"):
        # the dense carrier's sv is the dense dual slack: one f32 eigh (and
        # an f64-refined bound near convergence) replaces LOBPCG
        dc = DenseEighCert(n, k)

        def cert(Y, sv, z, gap=np.inf, pinf=np.inf):
            S = _dense_s(variant, op, sv, z)
            S = 0.5 * (S + S.T)
            far = max(gap, pinf) > max(opt.cert_cheap_eta, opt.tol)
            res = dc.certify(S, far, opt.tol)
            vals = torch.full((k,), np.nan, dtype=S.dtype, device=S.device)
            vals[0] = res.lam_min
            return (res.lam_min, res.lam_max, res.num_neg, res.neg_vecs,
                    vals)
        return cert

    if use_eigh and sharded:
        kk = min(k, n)

        def cert(Y, sv, z, gap=np.inf, pinf=np.inf):
            S = _dense_s(variant, op, sv, z)
            vals = torch.empty((n,), dtype=S.dtype, device=S.device)
            vecs = torch.empty((n, kk), dtype=S.dtype, device=S.device)
            if op.rank == 0:
                w, V = torch.linalg.eigh(S)
                vals.copy_(w)
                vecs.copy_(V[:, :kk])
            broadcast(vals, op.group)
            broadcast(vecs, op.group)
            return (float(vals[0]), float(vals[-1]),
                    int(torch.sum(vals < 0)), vecs, vals[:k])
        return cert

    if use_eigh:
        def cert(Y, sv, z, gap=np.inf, pinf=np.inf):
            vals, vecs = torch.linalg.eigh(_dense_s(variant, op, sv, z))
            return (float(vals[0]), float(vals[-1]),
                    int(torch.sum(vals < 0)), vecs[:, :k], vals[:k])
        return cert

    def mvr_for(sv, z, dtype=torch.float64):
        """V -> V S for (rows, n) V in ``dtype`` (sv and z cast to it): K1
        with S's values on P (sharded: the all-reduced K1 ``plain``, then
        the shift), or a GEMM with the dense S on a carrier."""
        sv = sv.to(dtype)
        if variant.shift == "none":
            return lambda V: op.matmat_pattern(V, sv)
        zv = (z if variant.shift == "diag" else
              z.reshape(1).expand(n).contiguous()).to(dtype)
        return lambda V: op.matmat_shift(V, sv, zv)

    # the f32 LOBPCG stage: at cert_pre_dtype "auto" or "float32" on the
    # rowrr path (and devrr at small n), at "float32" on the lobpcg path
    rowrr = opt.cert_method in ("devrr", "rowrr")
    cert32 = opt.cert_pre_dtype == "float32" or (
        rowrr and opt.cert_pre_dtype == "auto")

    def mvr32_for(sv, z):
        return mvr_for(sv, z, torch.float32) if cert32 else None

    def decides(res):
        """The conservative bound fails tol while the optimistic Ritz
        value passes: accuracy decides convergence."""
        lam_max = float(res.lam_max)
        cons = max(0.0, -float(res.lam_min)) / (1.0 + lam_max)
        optm = max(0.0, -float(res.neg_vals[0])) / (1.0 + lam_max)
        return cons >= opt.tol and optm < opt.tol

    def finish(res):
        warm["X0"] = res.neg_vecs
        return (float(res.lam_min), float(res.lam_max), int(res.num_neg),
                res.neg_vecs, res.neg_vals)

    warm = {"X0": None}
    b_cert = max(k, min((n - 1) // 5, 24))
    if opt.cert_method == "devrr" and n > 3 * b_cert:
        # warm-started Kato-Temple solve with the deflation factor padded
        # to cert_p_bucket rows; the cheap budget while far from
        # convergence; when accuracy decides, the same solver again with
        # the full budget
        solvers = {}

        def cert(Y, sv, z, gap=np.inf, pinf=np.inf):
            mvr = mvr_for(sv, z)
            dr = bucketed(Y.shape[0], opt.cert_p_bucket)
            if dr not in solvers:
                solvers[dr] = DeviceCertSolver(n, k, deflate_rows=dr)
            Ypad = Y if Y.shape[0] == dr else torch.cat(
                [Y, torch.zeros((dr - Y.shape[0], n), dtype=Y.dtype,
                                device=Y.device)])
            far = max(gap, pinf) > max(opt.cert_cheap_eta, opt.tol)
            res = solvers[dr].solve(
                mvr, gen, X0=warm["X0"], Ydefl=Ypad,
                maxiter=(opt.lobpcg_maxiter_cheap if far
                         else opt.lobpcg_maxiter_warm),
                tol=opt.cert_inner_tol)
            if not far and decides(res):
                res = solvers[dr].solve(mvr, gen, X0=res.neg_vecs,
                                        Ydefl=Ypad,
                                        maxiter=opt.lobpcg_maxiter,
                                        tol=opt.cert_inner_tol)
            return finish(res)

        return cert

    if rowrr:
        # small n (devrr needs n > 3 * block) or cert_method="rowrr": the
        # same class with the linear bound, the whole factor as deflation
        # rows and the f32 stage; the first call pays the full budget
        def cert(Y, sv, z, gap=np.inf, pinf=np.inf):
            mvr, mvr32 = mvr_for(sv, z), mvr32_for(sv, z)
            solver = DeviceCertSolver(n, k, deflate_rows=Y.shape[0],
                                      bound="linear")
            first = warm["X0"] is None
            res = solver.solve(mvr, gen, X0=warm["X0"], Ydefl=Y,
                               maxiter=(opt.lobpcg_maxiter if first
                                        else opt.lobpcg_maxiter_warm),
                               tol=opt.cert_inner_tol, matvec32_rows=mvr32)
            if not first and decides(res):
                res = solver.solve(mvr, gen, X0=res.neg_vecs, Ydefl=Y,
                                   maxiter=opt.lobpcg_maxiter,
                                   tol=opt.cert_inner_tol,
                                   matvec32_rows=mvr32)
            return finish(res)

        return cert

    # any other cert_method (dense_eigh where its carrier conditions fail
    # included): the lobpcg certificate (ops/eigs.py); full budget on the
    # first call, warm after, full again when accuracy decides
    def lob(Y, mvr, mvr32, X0, maxiter):
        return lobpcg_certificate(mvr, n, k, gen, maxiter=maxiter, deflate=Y,
                                  X0=X0, matvec32=mvr32,
                                  refine_iters=opt.lobpcg_refine)

    def cert(Y, sv, z, gap=np.inf, pinf=np.inf):
        mvr, mvr32 = mvr_for(sv, z), mvr32_for(sv, z)
        if warm["X0"] is None:
            res = lob(Y, mvr, mvr32, None, opt.lobpcg_maxiter)
        else:
            res = lob(Y, mvr, mvr32, warm["X0"], opt.lobpcg_maxiter_warm)
            if decides(res):
                res = lob(Y, mvr, mvr32, res.neg_vecs, opt.lobpcg_maxiter)
        return finish(res)

    return cert


def _device_rank_rebuild(variant: ALVariant, opt: SolverOptions, Y, UlT,
                         vsT, r: int, nne: int):
    """Truncate and append escape rows on the device: Y_new = UlT @ Y with
    the nne escape rows vsT[:nne] landed at rows r .. r + nne.  Returns
    (Y_new, escape-direction buffer)."""
    Z = UlT @ Y
    V = torch.zeros_like(Z)
    V[r:r + nne] = vsT[:nne]
    if opt.line_search:
        return Z, V
    Yn = Z + opt.alpha * V
    if variant.manifold is Oblique:
        Yn = Oblique.renormalize(Yn)
    return Yn, V


def _select_operator(opt: SolverOptions, op):
    """The JAX package's operator ladder (config.al_op_mode): the entrywise
    carrier for entrywise constraint sets at n <= entrywise_al_max_n, the
    dense carrier at n <= dense_al_max_n, else the factored operator.  An
    operator that is not a ConstraintOp (SymMomOp) is already specialized
    and is taken as it is."""
    if not isinstance(op, ConstraintOp):
        return op
    mode, n = opt.al_op_mode, op.n
    if mode not in ("auto", "entrywise", "dense", "sparse"):
        raise ValueError(f"unknown al_op_mode {mode!r}")
    if mode in ("auto", "entrywise") and n <= opt.entrywise_al_max_n:
        ew = EntrywiseConstraintOp.detect(op)
        if ew is not None:
            return ew
        if mode == "entrywise":
            raise ValueError(
                "al_op_mode='entrywise' but the constraint set is not "
                "entrywise (single-entry / symmetric-pair)")
    if mode == "dense" or (mode == "auto" and n <= opt.dense_al_max_n):
        return op.to_dense_op()
    return op


def _ranks(group) -> list:
    """The global ranks of ``group`` (None: the default group)."""
    return dist.get_process_group_ranks(group or dist.group.WORLD)


@recorded
def solve_primal_al(variant_name: str, op: ConstraintOp,
                    options: Optional[SolverOptions] = None,
                    Y0: Optional[np.ndarray] = None,
                    y0: Optional[np.ndarray] = None,
                    mesh=None,
                    **overrides) -> SDPResult:
    """The AL outer loop [RTR inner solve -> stats -> certificate -> rank
    update -> sigma schedule] on ``op``'s device, on the operator the
    ladder picks (within the span ``operator``).

    ``mesh`` (a DeviceMesh; this process one of its ranks): the operator
    is sharded by pattern id over the mesh's model axis
    (parallel/sharded_ops.py: ``op`` a ConstraintOp, sharded here, or this
    rank's ShardedConstraintOp) and every rank runs this loop on the
    replicated factor; no ladder and the host rank update, as in the JAX
    package (the certificate: _make_certificate).  Every rank returns the
    same result (all but the wall-clock ``time`` and ``timers``)."""
    timers = current()
    with timers.timed("operator"):
        variant = VARIANTS[variant_name]
        opt = merged_options(variant.name, options, **overrides)
        n, m = op.n, op.m
        device = op.device
        if mesh is None:
            if isinstance(op, ShardedConstraintOp):
                raise ValueError("a ShardedConstraintOp needs the mesh it "
                                 "was built on (mesh=)")
            op = _select_operator(opt, op)
        else:
            if device.type != mesh.device_type:
                raise ValueError(f"the operator lives on {device}, the mesh "
                                 f"on {mesh.device_type}")
            if isinstance(op, ConstraintOp):
                op = build_on_mesh(op.host_arrays(full=True), mesh, device)
            elif not isinstance(op, ShardedConstraintOp):
                raise TypeError("mesh= takes a ConstraintOp or its "
                                "ShardedConstraintOp")
            elif _ranks(op.group) != \
                    _ranks(mesh_axis(mesh, model_axis(mesh))[2]):
                raise ValueError("the ShardedConstraintOp was built on "
                                 "another group of ranks than mesh='s "
                                 "model axis")
            if opt.verbose and dist.get_rank() != 0:
                opt = dataclasses.replace(opt, verbose=False)
        sharded = isinstance(op, ShardedConstraintOp)
        use_eigh = (opt.eig_method == "eigh") or \
            (opt.eig_method == "auto" and n < opt.eig_switch_n)
        k_cert = opt.delta + 1

        if opt.verbose:
            print(f"ManiSDP-TPU ({variant.name}, torch) is starting...",
                  flush=True)
            # expanded operators carry an inflated flat residual length;
            # report the true constraint count
            print(f"SDP size: n = {n}, m = {getattr(op, 'm_true', m)}",
                  flush=True)

        problem, cost_only = _make_problem(variant)
        M = variant.manifold

        def budget(tier, use32):
            kw = dict(tolgradnorm=opt.tolgradnorm,
                      tcg_dtype="float32" if use32 else None)
            if tier == 0:
                return TROptions(maxiter=opt.tr_maxiter,
                                 maxinner=opt.tr_maxinner, **kw)
            return TROptions(maxiter=max(opt.boost_tr_maxiter, opt.tr_maxiter),
                             maxinner=max(opt.boost_tr_maxinner,
                                          opt.tr_maxinner), **kw)

        line_search = make_line_search(
            cost_only, M.renormalize,
            ls_dtype="float32" if opt.inner_dtype == "tcg32" else None)
        # f32 copy of the operator for the tcg32 inner loop and the mixed
        # pre-stage (index arrays shared; only float arrays are cast), built
        # once per solve
        mixed = opt.inner_dtype == "mixed"
        op32 = op.astype(torch.float32) \
            if opt.inner_dtype == "tcg32" or mixed else None
        stats_fn = _make_stats(variant)
        gen = torch.Generator(device=device)
        gen.manual_seed(opt.seed)
        cert_fn = _make_certificate(variant, op, n, k_cert, use_eigh, opt, gen)
        rank = RankController(opt.theta, opt.delta, opt.alpha,
                              nne_floor=variant.nne_floor, bucket=opt.p_bucket)
        slow = SlowProgress(variant.slow_period, variant.slow_warmup)
        as_dev = lambda a: torch.as_tensor(  # noqa: E731
            a, dtype=torch.float64, device=device)

        p = opt.p0 if opt.p0 > 0 else max(int(np.ceil(np.log(max(m, 2)))), 1)
        p_pad = bucketed(p, opt.p_bucket)
        if Y0 is not None:
            Y0 = np.asarray(Y0, dtype=np.float64)
            if Y0.shape[1] != n:      # accept reference (n, p) layout too
                Y0 = Y0.T
            p = Y0.shape[0]
            p_pad = max(p_pad, bucketed(p, opt.p_bucket))
            Y = as_dev(pad_rows(Y0, p_pad))
        else:
            Y = M.rand(gen, p, n, p_pad)
        # operators over a redundant basis (SymMomOp) supply a symmetrize hook:
        # the initial, every inner-solved and every rebuilt factor are
        # projected onto the duplicate-symmetric subspace, where the expanded
        # dynamics reproduce the reference trajectory
        symmetrize = getattr(op, "symmetrize", None)
        if symmetrize is not None:
            Y = symmetrize(Y)
        U_dir = None

        y = op.res_zeros() if y0 is None else op.res_from_mvec(y0)
        sigma = float(opt.sigma0)
        status = 0
        total_tr = total_hess = 0
        fac_size, history = [], []
        obj = gap = pinf = dinf = gradnorm = eta = np.nan
        sv_dev = z_dev = y_dev = None
        it = 0
        tier = 0
        use32 = opt.inner_dtype == "tcg32"
        frozen = 0          # consecutive endgame iterations with frozen sigma

    for it in range(1, opt.max_outer + 1):
        with timers.timed("rtr"):
            fac_size.append(p)
            solve = make_trustregions(problem, budget(tier, use32))
            params = dict(op=op, y=y, sigma=sigma)
            if U_dir is not None:
                Y = line_search(Y, U_dir, params)
            typdist = float(M.typicaldist(p, n))
            # the f32 pre-stage runs in tier 0 only, not in the endgame
            if mixed and tier == 0:
                Y, tr32, hv32 = mixed_prestage(
                    problem, budget(tier, False), opt, gradnorm, Y,
                    dict(op=op32, y=y.to(torch.float32), sigma=sigma),
                    typdist)
                total_tr += tr32
                total_hess += hv32
            params_tcg = dict(op=op32, y=y.to(torch.float32),
                              sigma=sigma) if use32 else None
            res = solve(Y, params, typdist, params_tcg=params_tcg)
            Y = res.Y
            if symmetrize is not None:
                Y = symmetrize(Y)
            gradnorm = float(res.norm_grad)
            total_tr += res.iters
            total_hess += res.inner_iters
            # free the solve's unprojected factor, which would otherwise
            # stay live beside Y until the next inner solve returns
            res = None

        with timers.timed("stats"):
            obj_d, pinf_d, y, sv_dev, z_dev, _, gap_d = stats_fn(
                Y, op, y, sigma)
            obj, pinf, gap = float(obj_d), float(pinf_d), float(gap_d)
            y_dev = y

        with timers.timed("cert"):
            lam_min, lam_max, num_neg, neg_vecs, _ = cert_fn(
                Y, sv_dev, z_dev, gap=gap, pinf=pinf)

        with timers.timed("rank"):
            dinf = max(0.0, -lam_min) / (1.0 + lam_max)
            r, _, Ul = rank.truncation(Y, p)
            log_iter(opt.verbose, it, obj, gap=gap, pinf=pinf, dinf=dinf,
                     gradnorm=gradnorm, r=r, p=p, sigma=sigma,
                     wall=timers.wall())
            history.append(dict(iter=it, obj=obj, gap=gap, pinf=pinf,
                                dinf=dinf, gradnorm=gradnorm, r=r, p=p,
                                sigma=sigma))
            timers.log_delta(opt.verbose)
            eta = max(gap, pinf, dinf)
            if eta < opt.tol:
                if opt.verbose:
                    print("Optimality is reached!", flush=True)
                break
            if slow.check(it, gap, pinf, dinf):
                if use32:
                    # precision fallback: demote the f32 tCG inner loop to f64
                    # and keep going instead of bailing
                    use32 = False
                    slow.prev = None
                    if opt.verbose:
                        print("Slow progress under tcg32 -> f64 inner "
                              "fallback", flush=True)
                else:
                    status = 2
                    if opt.verbose:
                        print("Slow progress!", flush=True)
                    break

            # ---- rank update ----
            # no escape when the certificate already passes: num_neg counts raw
            # negative eigenvalues, so sign noise at a converged point would
            # append junk directions
            nne = rank.num_escape(num_neg) if dinf > opt.tol else 0
            p_new = (r if r <= p - 1 else p) + nne
            if variant.manifold is not Sphere and not sharded:
                p_pad_new = max(p_pad, bucketed(p_new, opt.p_bucket))
                UlT = np.zeros((p_pad_new, p_pad), dtype=np.float64)
                if r <= p - 1:
                    UlT[:r] = Ul[:, :r].T
                    p = r
                else:
                    UlT[:p, :p] = np.eye(p)
                Y, U_dir = _device_rank_rebuild(
                    variant, opt, Y, as_dev(UlT), neg_vecs.T, p, nne)
                if not opt.line_search:
                    U_dir = None
                p = p + nne
                p_pad = p_pad_new
            else:
                # the sphere family keeps the host update: its sigma
                # controller (tau1 = 1e-5) makes the trajectory sensitive
                # to device-vs-numpy rounding, and its instances are small;
                # so does the sharded path, as in the JAX package
                Y_host = Y.cpu().numpy()
                if r <= p - 1:
                    Y_host = Ul[:, :r].T @ Y_host
                    p = r
                else:
                    Y_host = Y_host[:p]
                vs = neg_vecs[:, :nne].cpu().numpy()
                if opt.line_search:
                    U_host = np.vstack([np.zeros((p, n)), vs.T])
                    Y_host = np.vstack([Y_host, np.zeros((nne, n))])
                else:
                    U_host = None
                    Y_host = np.vstack([Y_host, opt.alpha * vs.T])
                    if variant.manifold is Oblique:
                        Y_host = Y_host / np.sqrt(np.sum(Y_host ** 2,
                                                         axis=0))
                    elif variant.manifold is Sphere:
                        Y_host = Y_host / np.linalg.norm(Y_host)
                p = p + nne
                p_pad = max(p_pad, bucketed(p, opt.p_bucket))
                Y = as_dev(pad_rows(Y_host, p_pad))
                U_dir = as_dev(pad_rows(U_host, p_pad)) \
                    if U_host is not None else None
            if symmetrize is not None:
                # renorm=False: the reference renormalizes only the
                # stepped point
                Y = symmetrize(Y, renorm=False)
                if U_dir is not None:
                    U_dir = symmetrize(U_dir, renorm=False)

            # ---- sigma schedule ----
            if pinf < opt.tau1 * gradnorm:
                sigma = max(sigma / opt.gama, opt.sigma_min)
                frozen = 0
            elif pinf > opt.tau2 * gradnorm:
                sigma = min(sigma * opt.gama, opt.sigma_max)
                frozen = 0
            else:
                # endgame boost: sigma frozen with dinf the dominant blocker
                # -> the subproblem is under-resolved; escalate the TR budget
                near = max(gap, pinf) <= max(1e-6, 10 * opt.tol)
                if (opt.endgame_boost and tier == 0 and near and
                        dinf > opt.tol and dinf > 2.0 * max(gap, pinf)):
                    frozen += 1
                    if frozen >= opt.boost_after:
                        tier = 1
                else:
                    frozen = 0

            # checkpoint after the sigma update, so resuming with
            # sigma0=st["sigma"] continues the same trajectory
            if opt.checkpoint_every and opt.checkpoint_path and \
                    it % opt.checkpoint_every == 0 and \
                    not (sharded and dist.get_rank() != 0):
                from ..utils.checkpoint import save_state
                save_state(opt.checkpoint_path, Y=Y.cpu().numpy()[:p],
                           y=op.res_to_mvec(y), sigma=sigma, tier=tier,
                           iteration=it)
    else:
        it = opt.max_outer

    with timers.timed("result"):
        if status == 0 and eta > opt.tol:
            status = 1
            if opt.verbose:
                print("Iteration maximum is reached!", flush=True)

        if opt.verbose:
            print(f"ManiSDP-TPU: optimum = {obj:0.8f}, "
                  f"time = {timers.wall():0.2f}s", flush=True)

        Y_act = Y.cpu().numpy()[:p]
        X = Y_act.T @ Y_act
        S_host = _dense_s(variant, op, sv_dev, z_dev).cpu().numpy() \
            if sv_dev is not None else None
        return SDPResult(
            X=X, obj=obj, Y=Y_act,
            y=op.res_to_mvec(y_dev) if y_dev is not None else None,
            S=S_host,
            z=z_dev.cpu().numpy() if z_dev is not None else None,
            gap=gap, pinf=pinf, dinf=dinf, eta=eta, gradnorm=gradnorm,
            status=status, iterations=it, fac_size=fac_size,
            rtr_iters=total_tr, hess_calls=total_hess, history=history,
            timers=timers.t, sigma=sigma, tier=tier)


@recorded
def solve_sedumi_al(variant_name: str, At, b, c, n: int,
                    options: Optional[SolverOptions], Y0, y0, mesh,
                    resume: Optional[str], device, overrides: dict
                    ) -> SDPResult:
    """The public entry points' shared body: SeDuMi data (or a
    ConstraintOp already on ``device``) and an optional checkpoint to
    resume from -> solve_primal_al.  With ``mesh`` SeDuMi data is
    assembled on the host and only this rank's shard is uploaded."""
    with current().timed("operator"):
        device = resolve_device(device)
        if resume:
            from ..utils.checkpoint import resume_kwargs
            rk = resume_kwargs(resume)
            Y0 = rk.get("Y0", Y0)
            y0 = rk.get("y0", y0)
            if "sigma0" in rk:
                overrides.setdefault("sigma0", rk["sigma0"])
        if isinstance(At, (ConstraintOp, ShardedConstraintOp)):
            op = At
            if op.device.type != device.type:
                raise ValueError(f"the operator lives on {op.device}, the "
                                 f"solve was asked for {device}")
        elif mesh is not None:
            op = build_on_mesh(ConstraintOp.assemble(At, b, c, n), mesh,
                               device)
        else:
            op = ConstraintOp.build(At, b, c, n, device)
    return solve_primal_al(variant_name, op, options, Y0=Y0, y0=y0,
                           mesh=mesh, **overrides)
