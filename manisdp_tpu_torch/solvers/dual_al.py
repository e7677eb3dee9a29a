"""Dual Riemannian-ADMM drivers (PyTorch port of
manisdp_tpu/solvers/dual_al.py).

    sup  <C,X> + <c,w>   s.t.  A(X) + B(w) = b,  X psd,  w free

factored through the dual slack S = Y'Y on the manifold:

  - dual_unitdiag (oblique, diag(S)=1): src/dual/ManiDSDP_unitdiag.m,
    SOS duals of BQPs;
  - dual_general (Euclidean):           src/dual/ManiDSDP.m, SOS with
    general multipliers (the composite x-update through iAB).

Per ADMM iteration: closed-form y-step (AA' diagonal), RTR inner solve on
Y, multiplier updates (X, w), and the primal matrix recovered from the
multipliers drives the certificate and the escape directions
(ManiDSDP_unitdiag.m:80-88).  The multiplier and the gradient matrix are
dense n x n; their products with Y are ``torch.matmul`` GEMMs, as the JAX
package leaves them to XLA.  The operator is a ``DualOp`` (kernel K4) or,
for the BQP SOS dual on the expanded basis, a ``SymDualOp`` (kernels K7
and K8), whose duplicate-copy projections the driver applies at init,
after every RTR, to the multipliers and after every rank rebuild; the
oblique Hessian's epilogue is kernel K2.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import SolverOptions, merged_options
from ..core import Problem, TROptions, make_trustregions
from ..kernels import oblique_cols
from ..manifolds import Euclidean, Oblique
from ..ops.dense_cert import DenseEighCert
from ..ops.dualops import SparseMat
from ..ops.eigs import lobpcg_certificate
from ..ops.eigs_rr import DeviceCertSolver
from .common import (RankController, SDPResult, SlowProgress, bucketed,
                     current, log_iter, make_line_search, mixed_prestage,
                     pad_rows, recorded)


@dataclasses.dataclass(frozen=True)
class DualVariant:
    name: str
    manifold: type
    unitdiag: bool
    nne_floor: bool
    slow_period: int
    slow_warmup: int


DUAL_VARIANTS = {
    "dual_unitdiag": DualVariant("dual_unitdiag", Oblique, True, True,
                                 50, 100),
    "dual_general": DualVariant("dual_general", Euclidean, False, False,
                                20, 50),
}


def _dot_b(op, y):
    """<b, y>; ops with a truncated b (SymDualOp) expose dot_b."""
    f = getattr(op, "dot_b", None)
    return f(y) if f is not None else torch.dot(op.b, y)


def _B_rmatvec(op, y):
    """B' y for the free block; tuple m-space ops (SymDualOp) carry f = 0,
    so the product is empty."""
    if isinstance(y, tuple):
        if op.f == 0:
            return torch.zeros(0, dtype=y[4].dtype, device=y[4].device)
        return op.B.rmatvec(op.flatten_y(y))
    return op.B.rmatvec(y)


def _common_cost(Y, op, Xm, w, sigma):
    S = Y.T @ Y
    y = op.y_step(S)
    As = op.residual(y, S, Xm, sigma)          # adjoint(y) - (S-C) - Xm/sigma
    Af = _B_rmatvec(op, y) - op.cf - w / sigma
    f = _dot_b(op, y) + 0.5 * sigma * \
        (torch.sum(As * As) + torch.dot(Af, Af))
    # aux holds only (As, Af): the gradients never read S or y
    return f, (As, Af)


def _make_problem(variant: DualVariant):
    """cost / grad / hess; params = dict(op, Xm, w, sigma (Python float),
    iAB (dual_general))."""
    M = variant.manifold

    def cost(Y, params):
        return _common_cost(Y, params["op"], params["Xm"], params["w"],
                            params["sigma"])

    if variant.unitdiag:
        # ManiDSDP_unitdiag.m:183-194
        def grad(Y, params, aux):
            op, sigma = params["op"], params["sigma"]
            As, _ = aux
            Xh = op.bA - sigma * As
            eG = 2.0 * Y @ Xh
            YeG = torch.sum(Y * eG, dim=0)
            return eG - Y * YeG[None, :], (Xh, YeG)

        def hess(Y, U, params, aux, gaux):
            op, sigma = params["op"], params["sigma"]
            Xh, YeG = gaux
            YU = Y.T @ U
            yAU = op.adjoint_scaled(op.apply(YU))
            eH = 2.0 * U @ Xh - 4.0 * sigma * (Y @ yAU) \
                + 2.0 * sigma * ((Y @ U.T) @ Y + (Y @ Y.T) @ U)
            # eH - Y o colsum(Y o eH) - U o YeG: kernel K2
            return oblique_cols(Y, eH, "proj", v=U, g=YeG)
    else:
        # ManiDSDP.m:162-177
        def grad(Y, params, aux):
            op, sigma, iAB = params["op"], params["sigma"], params["iAB"]
            As, Af = aux
            Xh = op.bA + sigma * (
                _iab_mat(iAB, op.n, Af)
                + op.adjoint_scaled(op.apply(As)) - As)
            return 2.0 * Y @ Xh, (Xh, None)

        def hess(Y, U, params, aux, gaux):
            op, sigma, iAB = params["op"], params["sigma"], params["iAB"]
            Xh, _ = gaux
            YU = U.T @ Y                       # <U[:,i], Y[:,j]> dense
            yAU = op.adjoint_scaled(op.apply(YU))
            t1 = _iab_mat(iAB, op.n, _iab_rmat(iAB, YU))
            t2 = op.adjoint_scaled(op.apply(yAU))
            return 2.0 * U @ Xh \
                + 2.0 * sigma * ((Y @ Y.T) @ U + (Y @ U.T) @ Y) \
                + 4.0 * sigma * (Y @ (t1 + t2 - 2.0 * yAU))

    def cost_only(Y, params):
        return cost(Y, params)[0]

    return Problem(manifold=M, cost=cost, grad=grad, hess=hess), cost_only


def _iab_mat(iAB: SparseMat, n: int, u):
    """mat(iAB @ u) -> dense (n, n); iAB rows are n^2 row-major (K4
    gather by row)."""
    return iAB.matvec(u).view(n, n)


def _iab_rmat(iAB: SparseMat, M):
    """iAB' @ vec(M) -> (f,) for dense (n, n) M (K4 gather by column)."""
    return iAB.rmatvec(M.contiguous().view(-1))


def _make_stats(variant: DualVariant):

    def stats(Y, op, Xm, w, sigma, normc, iAB=None):
        # S and y are not returned: the driver rebuilds them once at the
        # end from the factor
        S = Y.T @ Y
        y = op.y_step(S)
        As = op.residual(y, S)                 # adjoint(y) - (S - C)
        Af = _B_rmatvec(op, y) - op.cf
        pinf = (torch.sqrt(torch.sum(As * As)) + torch.linalg.norm(Af)) \
            / normc
        by = _dot_b(op, y)
        if variant.unitdiag:
            # ManiDSDP_unitdiag.m:80-88
            Xm_new = Xm - sigma * As
            w_new = w - sigma * Af
            eX = Xm_new + op.bA
            z = torch.sum(S * eX, dim=0)
            Xp = eX - torch.diag(z)
            obj = torch.sum(op.C * eX) + torch.dot(op.cf, w_new) + \
                torch.sum(z)
        else:
            # ManiDSDP.m:73-77
            Xm_new = Xm + sigma * (
                _iab_mat(iAB, op.n, Af - w / sigma)
                + op.adjoint_scaled(op.apply(As - Xm / sigma)) - As)
            w_new = w - sigma * Af
            eX = Xm_new + op.bA
            z = torch.zeros((), dtype=Y.dtype, device=Y.device)
            Xp = eX
            obj = torch.sum(op.C * eX) + torch.dot(op.cf, w_new)
        gap = torch.abs(obj - by) / (1.0 + torch.abs(obj) + torch.abs(by))
        return Xm_new, w_new, Xp, z, obj, pinf, by, gap

    return stats


def _make_certificate(op, n: int, k_cert: int, use_eigh: bool,
                      opt: SolverOptions, gen: torch.Generator):
    """cert(Xp, gap, pinf) -> (lam_min, lam_max, num_neg, neg_vecs (n, k)
    as host numpy)."""
    compress = getattr(op, "compress", None)
    if compress is not None:
        # exact certificate in the compressed original basis of an
        # expanded (duplicated) operator: the expanded X~ has an
        # (n~ - rank)-fold zero cluster no iterative residual bound can
        # certify, while lam(X~) = lam(X_orig)/2 plus zeros
        # (ManiDSDP_unitdiag.m:84).  Far tier: one f32 eigh; near tier:
        # the f64-refined Gershgorin bound, the Ritz shortcut and the
        # exact f64 eigh fallback (ops/dense_cert.py).
        dc = DenseEighCert(op.n_orig, k_cert)

        def cert(Xp, gap, pinf):
            Xo = compress(Xp)
            Xo = 0.5 * (Xo + Xo.T)
            far = max(gap, pinf) > max(opt.cert_cheap_eta, opt.tol)
            res = dc.certify(Xo, far, opt.tol)
            lam_min = min(res.lam_min / 2.0, 0.0)
            lam_max = max(res.lam_max / 2.0, 0.0)
            return lam_min, lam_max, res.num_neg, op.lift_vecs(
                res.neg_vecs[:, :k_cert].cpu().numpy())
        return cert

    if use_eigh:
        # a device f64 eigh (the JAX package takes a host one)
        def cert(Xp, gap, pinf):
            vals, vecs = torch.linalg.eigh(Xp)
            return (float(vals[0]), float(vals[-1]), int(torch.sum(vals < 0)),
                    vecs[:, :k_cert].cpu().numpy())
        return cert

    warm = {"X0": None}

    def decides(res):
        lam_max = abs(float(res.lam_max))
        cons = max(0.0, -float(res.lam_min)) / (1.0 + lam_max)
        optm = max(0.0, -float(res.neg_vals[0])) / (1.0 + lam_max)
        return cons >= opt.tol and optm < opt.tol

    def finish(res):
        warm["X0"] = res.neg_vecs
        return (float(res.lam_min), float(res.lam_max), int(res.num_neg),
                res.neg_vecs.cpu().numpy())

    if opt.cert_method == "devrr" and n > 3 * k_cert:
        # the primal-recovery matrix Xp is dense, so the row matvec is one
        # GEMM V @ Xp (Xp symmetric); the cheap budget while far from
        # convergence, the full one when accuracy decides
        solver = DeviceCertSolver(n, k_cert)

        def cert(Xp, gap, pinf):
            mv = lambda V: V @ Xp  # noqa: E731
            far = max(gap, pinf) > max(opt.cert_cheap_eta, opt.tol)
            res = solver.solve(
                mv, gen, X0=warm["X0"],
                maxiter=(opt.lobpcg_maxiter_cheap if far
                         else opt.lobpcg_maxiter_warm),
                tol=opt.cert_inner_tol)
            if not far and decides(res):
                res = solver.solve(mv, gen, X0=res.neg_vecs,
                                   maxiter=opt.lobpcg_maxiter,
                                   tol=opt.cert_inner_tol)
            return finish(res)
        return cert

    # the f32 LOBPCG stage, V @ Xp in f32: at cert_pre_dtype "auto" or
    # "float32" on the rowrr path (and devrr at n <= 3 k), at "float32" on
    # the lobpcg path
    rowrr = opt.cert_method in ("devrr", "rowrr")
    cert32 = opt.cert_pre_dtype == "float32" or (
        rowrr and opt.cert_pre_dtype == "auto")

    def mv32_for(Xp):
        if not cert32:
            return None
        Xp32 = Xp.to(torch.float32)
        return lambda V: V @ Xp32

    if rowrr:
        # rowrr (and devrr at n <= 3 k): the same class with the linear
        # bound; the first call pays the full budget
        solver = DeviceCertSolver(n, k_cert, bound="linear")

        def cert(Xp, gap, pinf):
            mv, mv32 = (lambda V: V @ Xp), mv32_for(Xp)
            first = warm["X0"] is None
            res = solver.solve(mv, gen, X0=warm["X0"],
                               maxiter=(opt.lobpcg_maxiter if first
                                        else opt.lobpcg_maxiter_warm),
                               tol=opt.cert_inner_tol, matvec32_rows=mv32)
            if not first and decides(res) and gap < opt.tol and \
                    pinf < opt.tol:
                res = solver.solve(mv, gen, X0=res.neg_vecs,
                                   maxiter=opt.lobpcg_maxiter,
                                   tol=opt.cert_inner_tol,
                                   matvec32_rows=mv32)
            return finish(res)
        return cert

    # any other cert_method: the lobpcg certificate (ops/eigs.py), with no
    # deflation factor; the same budgets and retry as rowrr
    def lob(mv, mv32, X0, maxiter):
        return lobpcg_certificate(mv, n, k_cert, gen, maxiter=maxiter,
                                  X0=X0, matvec32=mv32,
                                  refine_iters=opt.lobpcg_refine)

    def cert(Xp, gap, pinf):
        mv, mv32 = (lambda V: V @ Xp), mv32_for(Xp)
        if warm["X0"] is None:
            res = lob(mv, mv32, None, opt.lobpcg_maxiter)
        else:
            res = lob(mv, mv32, warm["X0"], opt.lobpcg_maxiter_warm)
            if decides(res) and gap < opt.tol and pinf < opt.tol:
                res = lob(mv, mv32, res.neg_vecs, opt.lobpcg_maxiter)
        return finish(res)
    return cert


@recorded
def solve_dual_al(variant_name: str, op,
                  options: Optional[SolverOptions] = None,
                  iAB: Optional[SparseMat] = None,
                  Y0: Optional[np.ndarray] = None,
                  Xm0: Optional[np.ndarray] = None,
                  w0: Optional[np.ndarray] = None,
                  **overrides) -> SDPResult:
    """The ADMM outer loop [RTR inner solve -> stats -> certificate ->
    rank update -> sigma schedule] on ``op``'s device (a DualOp or a
    SymDualOp; ``iAB`` for dual_general)."""
    timers = current()
    with timers.timed("operator"):
        variant = DUAL_VARIANTS[variant_name]
        opt = merged_options(variant.name, options, **overrides)
        n, m = op.n, op.m
        device = op.device
        use_eigh = (opt.eig_method == "eigh") or \
            (opt.eig_method == "auto" and n < opt.eig_switch_n)
        k_cert = opt.delta + 1

        if opt.verbose:
            print(f"ManiSDP-TPU ({variant.name}, torch) is starting...",
                  flush=True)
            print(f"SDP size: n = {n}, m = {getattr(op, 'm_true', m)}",
                  flush=True)

        problem, cost_only = _make_problem(variant)

        # two TR budgets: the reference default (tier 0) and the escalated
        # endgame budget (tier 1)
        def budget(tier, use32):
            kw = dict(tolgradnorm=opt.tolgradnorm,
                      tcg_dtype="float32" if use32 else None)
            if tier == 0:
                return TROptions(maxiter=opt.tr_maxiter,
                                 maxinner=opt.tr_maxinner, **kw)
            return TROptions(maxiter=max(opt.boost_tr_maxiter, opt.tr_maxiter),
                             maxinner=max(opt.boost_tr_maxinner,
                                          opt.tr_maxinner), **kw)
        M = variant.manifold
        line_search = make_line_search(
            cost_only, M.renormalize,
            ls_dtype="float32" if opt.inner_dtype == "tcg32" else None)
        # f32 copies for the tcg32 inner loop and the mixed pre-stage, built
        # once per solve (iAB travels in params, so one problem serves both
        # dtypes)
        mixed = opt.inner_dtype == "mixed"
        op32 = iab32 = None
        if opt.inner_dtype == "tcg32" or mixed:
            op32 = op.astype(torch.float32)
            iab32 = iAB.astype(torch.float32) if iAB is not None else None
        stats_fn = _make_stats(variant)
        gen = torch.Generator(device=device)
        gen.manual_seed(opt.seed)
        cert_fn = _make_certificate(op, n, k_cert, use_eigh, opt, gen)

        rank = RankController(opt.theta, opt.delta, opt.alpha,
                              nne_floor=variant.nne_floor, bucket=opt.p_bucket)
        slow = SlowProgress(variant.slow_period, variant.slow_warmup)
        as_dev = lambda a: torch.as_tensor(  # noqa: E731
            a, dtype=torch.float64, device=device)

        normc = float(1.0 + np.sqrt(
            float(torch.sum(op.C * op.C)) + float(torch.dot(op.cf, op.cf))))

        # ManiDSDP_unitdiag.m:11 default p0 = ceil(log(m))
        p = opt.p0 if opt.p0 > 0 else max(int(np.ceil(np.log(max(m, 2)))), 1)
        p_pad = bucketed(p, opt.p_bucket)
        if Y0 is not None:
            Y0 = np.asarray(Y0, dtype=np.float64)
            if Y0.shape[1] != n:
                Y0 = Y0.T
            p = Y0.shape[0]
            p_pad = max(p_pad, bucketed(p, opt.p_bucket))
            Y = as_dev(pad_rows(Y0, p_pad))
        else:
            Y = M.rand(gen, p, n, p_pad)
        # operators over a redundant basis (SymDualOp) supply a symmetrize
        # hook: the init, every rebuilt factor and every escape direction are
        # projected onto the duplicate-symmetric subspace, where the expanded
        # dynamics reproduce the reference trajectory
        symmetrize = getattr(op, "symmetrize", None)
        if symmetrize is not None:
            Y = symmetrize(Y)
        U_dir = None

        Xm = torch.zeros((n, n), dtype=torch.float64, device=device) \
            if Xm0 is None else as_dev(np.asarray(Xm0))
        w = torch.zeros(op.f, dtype=torch.float64, device=device) \
            if w0 is None else as_dev(np.asarray(w0, dtype=np.float64).ravel())
        sigma = float(opt.sigma0)
        status = 0
        total_tr = total_hess = 0
        fac_size, history = [], []
        obj = gap = pinf = dinf = gradnorm = eta = np.nan
        Xp_dev = z_dev = None
        it = 0
        tier = 0
        use32 = opt.inner_dtype == "tcg32"
        frozen = 0          # consecutive endgame iterations with frozen sigma
        best_eta = np.inf
        last_improve = 0
        pinf_anchor = np.inf    # sigma_push state: pinf at last sigma raise
        anchor_it = 0
        hold_boost = -1         # boost held through terminal-escape recovery
        best_pinf = np.inf      # ramp trigger state: best pinf, last halve
        pinf_improve_it = 0
        term_dinf = None        # dinf at the previous terminal gentle escape

    for it in range(1, opt.max_outer + 1):
        with timers.timed("rtr"):
            fac_size.append(p)
            solve = make_trustregions(problem, budget(tier, use32))
            params = dict(op=op, Xm=Xm, w=w, sigma=sigma, iAB=iAB)
            if U_dir is not None:
                Y = line_search(Y, U_dir, params)
            typdist = float(M.typicaldist(p, n))
            params32 = dict(op=op32, Xm=Xm.to(torch.float32),
                            w=w.to(torch.float32), sigma=sigma,
                            iAB=iab32) if use32 or mixed else None
            # the f32 pre-stage runs in tier 0 only; the multiplier
            # updates, the y-step and the certificates stay f64
            if mixed and tier == 0:
                Y, tr32, hv32 = mixed_prestage(
                    problem, budget(tier, False), opt, gradnorm, Y,
                    params32, typdist)
                total_tr += tr32
                total_hess += hv32
            params_tcg = params32 if use32 else None
            res = solve(Y, params, typdist, params_tcg=params_tcg)
            Y = res.Y
            if symmetrize is not None:
                # project the inner solve's output before stats / cert
                # read it (f32 tCG noise leaves the subspace)
                Y = symmetrize(Y)
            gradnorm = float(res.norm_grad)
            total_tr += res.iters
            total_hess += res.inner_iters

        with timers.timed("stats"):
            (Xm, w, Xp_dev, z_dev, obj_d, pinf_d, _,
             gap_d) = stats_fn(Y, op, Xm, w, sigma, normc, iAB)
            if symmetrize is not None:
                # keep the multiplier on the duplicate-symmetric subspace:
                # asymmetric accumulation floors pinf
                Xm = op.symmetrize_mat(Xm)
                Xp_dev = op.symmetrize_mat(Xp_dev)
            obj, pinf, gap = float(obj_d), float(pinf_d), float(gap_d)

        with timers.timed("cert"):
            lam_min, lam_max, num_neg, neg_vecs = cert_fn(Xp_dev, gap, pinf)

        with timers.timed("rank"):
            # note abs() in the denominator (ManiDSDP_unitdiag.m:88)
            dinf = max(0.0, -lam_min) / (1.0 + abs(lam_max))
            r, _, Ul = rank.truncation(Y, p)
            log_iter(opt.verbose, it, obj, gap=gap, pinf=pinf, dinf=dinf,
                     gradnorm=gradnorm, r=r, p=p, sigma=sigma,
                     wall=timers.wall())
            history.append(dict(iter=it, obj=obj, gap=gap, pinf=pinf,
                                dinf=dinf, gradnorm=gradnorm, r=r, p=p,
                                sigma=sigma, tr=res.iters,
                                hv=res.inner_iters))
            timers.log_delta(opt.verbose)
            eta = max(gap, pinf, dinf)
            # eta-stagnation boost trigger: the best eta has not halved for
            # 2 * boost_after iterations with the gap already small
            if eta < 0.5 * best_eta:
                best_eta = eta
                last_improve = it
            if (opt.endgame_boost and tier == 0 and gap <= 1e-3 and
                    eta > opt.tol and
                    it - last_improve >= 2 * opt.boost_after):
                tier = 1
            # ramp-phase trigger (config.ramp_deep_after): the best pinf has
            # stopped halving for ramp_deep_after tier-0 outers
            if tier == 1:
                best_pinf = pinf
                pinf_improve_it = it
            else:
                if pinf < 0.5 * best_pinf:
                    best_pinf = pinf
                    pinf_improve_it = it
                if (opt.endgame_boost and opt.ramp_deep_after and
                        gap <= opt.ramp_deep_gap and pinf > opt.tol and
                        eta > opt.tol and
                        it - pinf_improve_it >= opt.ramp_deep_after):
                    tier = 1
                    pinf_improve_it = it
            if eta < opt.tol:
                if opt.verbose:
                    print("Optimality is reached!", flush=True)
                break
            if slow.check(it, gap, pinf, dinf):
                if use32:
                    # precision fallback: demote the f32 tCG inner loop to f64
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

            Y_host = Y.cpu().numpy()
            if r <= p - 1:
                Y_host = Ul[:, :r].T @ Y_host
                p = r
            else:
                Y_host = Y_host[:p]
            # no escape when the certificate is not the blocker: dinf below
            # max(tol, min(1e-5, 1e-2 pinf)) with pinf the lone blocker
            esc_ls = opt.line_search
            dinf_floor = max(opt.tol, min(1e-5, 1e-2 * pinf))
            pinf_lock = (opt.endgame_boost and gap <= 1e-3 and
                         dinf <= dinf_floor and pinf > opt.tol)
            if pinf_lock:
                # pinf is the lone blocker: hold the deep-solve tier so
                # gradnorm collapses and the tau2 comparison ramps sigma
                tier = 1
            nne = rank.num_escape(num_neg) if dinf > dinf_floor else 0
            if nne and pinf <= opt.tol and gap <= opt.tol:
                # terminal gentle escape: only the most negative direction,
                # and a deep next solve held through the recovery
                nne = 1
                if opt.endgame_boost:
                    tier = 1
                    hold_boost = it + 3
                # terminal limit-cycle breaker: a gentle kick that fails to
                # contract dinf by >= 25% per cycle falls back to the
                # reference's constant alpha-sized append
                if term_dinf is not None and dinf > 0.75 * term_dinf:
                    esc_ls = False
                term_dinf = dinf
            elif pinf > 1e-2 or gap > 1e-4:
                # left the terminal regime -> reset
                term_dinf = None
            vs = neg_vecs[:, :nne]
            if symmetrize is not None:
                # the lift of a unit original eigenvector has expanded norm
                # sqrt(2); the certificate returns unit expanded vectors
                vs = np.sqrt(2.0) * vs
            if nne == 0:
                U_host = None
            elif esc_ls:
                U_host = np.vstack([np.zeros((p, n)), vs.T])
                Y_host = np.vstack([Y_host, np.zeros((nne, n))])
            else:
                U_host = None
                Y_host = np.vstack([Y_host, opt.alpha * vs.T])
                if variant.manifold is Oblique:
                    Y_host = Y_host / np.sqrt(np.sum(Y_host ** 2, axis=0))
            p = p + nne
            # rank buckets grow eagerly but shrink only when the active rank
            # collapses to half a bucket or less
            p_need = bucketed(p, opt.p_bucket)
            if p_need > p_pad or 2 * p_need <= p_pad:
                p_pad = p_need
            Y = as_dev(pad_rows(Y_host, p_pad))
            U_dir = as_dev(pad_rows(U_host, p_pad)) if U_host is not None \
                else None
            if symmetrize is not None:
                # renorm=False: after a truncation the column norms are not
                # unit, and the reference renormalizes only the stepped point
                Y = symmetrize(Y, renorm=False)
                if U_dir is not None:
                    U_dir = symmetrize(U_dir, renorm=False)

            sigma_prev = sigma
            # the boost decays only on progress (eta halved recently)
            boost_decay = (not pinf_lock) and (it - last_improve <= 1) \
                and it > hold_boost
            if pinf < opt.tau1 * gradnorm:
                sigma = max(sigma / opt.gama, opt.sigma_min)
                frozen = 0
                if boost_decay:
                    tier = 0
            elif pinf > opt.tau2 * gradnorm:
                sigma = min(sigma * opt.gama, opt.sigma_max)
                frozen = 0
                if boost_decay:
                    tier = 0
            else:
                # plateau boost: escalate the TR budget after boost_after
                # consecutive frozen iterations once the gap is small
                if (opt.endgame_boost and tier == 0 and
                        gap <= 1e-3 and eta > opt.tol):
                    frozen += 1
                    if frozen >= opt.boost_after:
                        tier = 1
                else:
                    frozen = 0

            # forced sigma escalation on pinf stagnation (config.sigma_push)
            if opt.sigma_push:
                if sigma > sigma_prev or \
                        pinf < opt.sigma_push_ratio * pinf_anchor:
                    pinf_anchor = pinf
                    anchor_it = it
                elif (gap <= opt.sigma_push_gap and pinf > opt.tol and
                      eta > opt.tol and
                      it - anchor_it >= opt.sigma_push_after):
                    sigma = min(sigma * opt.gama, opt.sigma_max)
                    pinf_anchor = pinf
                    anchor_it = it

            # checkpoint after the sigma update, so resuming with
            # sigma0=st["sigma"] continues the same trajectory
            if opt.checkpoint_every and opt.checkpoint_path and \
                    it % opt.checkpoint_every == 0:
                from ..utils.checkpoint import save_state
                save_state(opt.checkpoint_path, Y=Y.cpu().numpy()[:p],
                           w=w.cpu().numpy(), Xm=Xm.cpu().numpy(), sigma=sigma,
                           tier=tier, iteration=it)
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
        # S and y rebuilt from the factor (not held during the loop)
        S_dev = y_dev = None
        if it > 0 and Xp_dev is not None:
            S_dev = Y.T @ Y
            y_dev = op.y_step(S_dev)
            if hasattr(op, "flatten_y"):
                y_dev = op.flatten_y(y_dev)
        host = lambda t: None if t is None else t.cpu().numpy()  # noqa: E731
        return SDPResult(
            X=host(Xp_dev), obj=obj, Y=Y_act, y=host(y_dev), S=host(S_dev),
            z=host(z_dev), gap=gap, pinf=pinf, dinf=dinf, eta=eta,
            gradnorm=gradnorm, status=status, iterations=it,
            fac_size=fac_size, rtr_iters=total_tr, hess_calls=total_hess,
            history=history, timers=timers.t, sigma=sigma, tier=tier)
