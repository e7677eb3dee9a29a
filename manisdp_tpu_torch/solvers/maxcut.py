"""Unit-diagonal SDP without extra affine constraints (MaxCut family),
PyTorch port of manisdp_tpu/solvers/maxcut.py.

    min <C, X>  s.t.  diag(X) = 1,  X >= 0

The unit-diagonal constraint is the oblique manifold, so the outer loop
alternates [RTR inner solve -> dual certificate -> rank update]:
  cost  f  = 0.5 <Y C, Y>
  grad  G  = YC - Y .* colsum(Y .* YC)
  hess  H  = UC - Y .* colsum(Y .* UC) - U .* eG
  dual  S  = C - diag(z),  z = colsum(C .* X)
with Y a zero-padded (p_pad, n) factor.  A sparse C (a SymCOO) runs the
cost, Hessian, z and the certificate matvec through kernel K1; every
oblique column op runs through kernel K2.  A dense C (n <=
``dense_cost_max_n``) uses ``torch.matmul``.  ``inner_dtype="mixed"``
runs an f32 RTR on C's f32 copy before each f64 solve
(``common.mixed_prestage``); the certificate's f32 LOBPCG stage
(``cert_pre_dtype``) applies S = C - diag(z) through that copy.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..config import SolverOptions, merged_options
from ..core import Problem, TROptions, make_trustregions
from ..kernels import symcoo_spmm
from ..manifolds import Oblique
from ..ops.eigs import lobpcg_certificate
from ..ops.eigs_rr import DeviceCertSolver
from ..ops.sparse import SymCOO
from .common import (RankController, SDPResult, SlowProgress, bucketed,
                     current, log_iter, make_line_search, mixed_prestage,
                     pad_rows, recorded, resolve_device)


def make_maxcut_problem(dense: bool = True) -> Problem:
    """cost/grad/hess of the oblique MaxCut subproblem
    (ManiSDP_onlyunitdiag.m:117-130).  ``dense``: C is an (n, n) tensor;
    otherwise a SymCOO and the products are K1's ``cost`` and ``hess``
    modes.  The same problem serves a batch (the JAX package's vmap of it,
    solvers/batch.py:68-98): Y (B, p, n), C (B, n, n) or a BatchedSymCOO
    (K1's instance mode), one cost per instance."""

    def cost(Y, C):
        if dense:
            YC = Y @ C
            eG = torch.sum(YC * Y, dim=-2)
        else:
            YC, eG = symcoo_spmm(Y, C, "cost")
        return 0.5 * torch.sum(eG, dim=-1), (YC, eG)

    def grad(Y, C, aux):
        YC, eG = aux
        return YC - Y * eG[..., None, :], ()

    def hess(Y, U, C, aux, gaux):
        _, eG = aux
        if not dense:
            return symcoo_spmm(U, C, "hess", B=Y, eG=eG)
        UC = U @ C
        return UC - Y * torch.sum(Y * UC, dim=-2, keepdim=True) \
            - U * eG[..., None, :]

    return Problem(manifold=Oblique, cost=cost, grad=grad, hess=hess)


def _z_obj(Y, C, dense: bool):
    """z_j = sum_i C_ij <Y_i, Y_j> (the dual shift) and <C, YᵀY>."""
    z = torch.sum(Y * (Y @ C), dim=0) if dense else C.quad_cols(Y)
    return z, float(torch.sum(z))


def _make_cert(opt: SolverOptions, n: int, k: int, use_eigh: bool,
               dense: bool, gen: torch.Generator):
    """Dual certificate for S = C - diag(z): a dense eigh for moderate n,
    the device LOBPCG class otherwise.  Returns
    cert(Y, C, C32) -> (z, obj, dinf, num_neg, neg_vecs (n, k) host,
    neg_vals); ``cert.reads_f32`` says whether it runs an f32 LOBPCG stage
    on ``C32``, C in float32 (the caller passes None otherwise)."""
    if use_eigh:
        def cert(Y, C, C32=None):
            z, obj = _z_obj(Y, C, dense)
            Cd = C if dense else C.to_dense()
            vals, vecs = torch.linalg.eigh(Cd - torch.diag(z))
            lam_min, lam_max = float(vals[0]), float(vals[-1])
            dinf = max(0.0, -lam_min) / (1.0 + lam_max)
            return (z, obj, dinf, int(torch.sum(vals < 0)),
                    vecs[:, :k].cpu().numpy(), vals[:k].cpu().numpy())
        cert.reads_f32 = False
        return cert

    def mvr_for(C, z):
        if dense:
            return lambda V: V @ C - z[None, :] * V
        return lambda V: symcoo_spmm(V, C, "shift", z=z)

    def mvr32_for(C32, z):
        """The f32 row matvec (K1 ``shift`` on C's f32 values, z in f32);
        None without C32."""
        return None if C32 is None else mvr_for(C32, z.to(torch.float32))

    warm = {"X0": None}

    def finish(z, obj, res):
        warm["X0"] = res.neg_vecs
        lam_min, lam_max = float(res.lam_min), float(res.lam_max)
        dinf = max(0.0, -lam_min) / (1.0 + lam_max)
        return (z, obj, dinf, int(res.num_neg),
                res.neg_vecs.cpu().numpy(), res.neg_vals.cpu().numpy())

    def decides(res):
        """The conservative bound fails tol while the optimistic Ritz
        value passes: accuracy decides convergence."""
        lam_max = float(res.lam_max)
        cons = max(0.0, -float(res.lam_min)) / (1.0 + lam_max)
        optm = max(0.0, -float(res.neg_vals[0])) / (1.0 + lam_max)
        return cons >= opt.tol and optm < opt.tol

    b_cert = max(k, min((n - 1) // 5, 24))
    if opt.cert_method == "devrr" and n > 3 * b_cert:
        # warm call: Kato-Temple bound, deflation factor padded to
        # cert_p_bucket rows; retry: big block, linear bound, the active
        # rows of Y; both f64
        solvers = {}

        def cert(Y, C, C32=None):
            z, obj = _z_obj(Y, C, dense)
            mvr = mvr_for(C, z)
            dr = bucketed(Y.shape[0], opt.cert_p_bucket)
            if dr not in solvers:
                solvers[dr] = DeviceCertSolver(n, k, deflate_rows=dr)
            Ypad = Y if Y.shape[0] == dr else torch.cat(
                [Y, torch.zeros((dr - Y.shape[0], n), dtype=Y.dtype,
                                device=Y.device)])
            res = solvers[dr].solve(mvr, gen, X0=warm["X0"], Ydefl=Ypad,
                                    maxiter=opt.lobpcg_maxiter_warm,
                                    tol=opt.cert_inner_tol)
            if decides(res):
                p_act = int(torch.sum(torch.linalg.norm(Y, dim=1) > 0.0))
                retry = DeviceCertSolver(n, k, deflate_rows=p_act,
                                         block_cap=opt.cert_big_block,
                                         bound="linear")
                res = retry.solve(mvr, gen, X0=res.neg_vecs,
                                  Ydefl=Y[:p_act],
                                  maxiter=opt.lobpcg_maxiter,
                                  tol=opt.cert_inner_tol)
            return finish(z, obj, res)

        cert.reads_f32 = False
        return cert

    # the f32 LOBPCG stage: at cert_pre_dtype "auto" or "float32" on the
    # rowrr path (and devrr at small n), at "float32" on the lobpcg path
    rowrr = opt.cert_method in ("devrr", "rowrr")
    cert32 = opt.cert_pre_dtype == "float32" or (
        rowrr and opt.cert_pre_dtype == "auto")
    if rowrr:
        # small n (devrr needs n > 3 * block) or cert_method="rowrr": the
        # same class with the linear bound, the whole padded factor as
        # deflation rows and, at cert_pre_dtype "auto" / "float32", an f32
        # stage; the first call pays the full budget
        def cert(Y, C, C32=None):
            z, obj = _z_obj(Y, C, dense)
            mvr, mvr32 = mvr_for(C, z), mvr32_for(C32, z)
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
            return finish(z, obj, res)

        cert.reads_f32 = cert32
        return cert

    # any other cert_method: the lobpcg certificate (ops/eigs.py), f32 bulk
    # iterations at cert_pre_dtype="float32"; full budget on the first
    # call, warm budget after, the full one again when accuracy decides
    def lob(Y, mvr, mvr32, X0, maxiter):
        return lobpcg_certificate(mvr, n, k, gen, maxiter=maxiter, deflate=Y,
                                  X0=X0, matvec32=mvr32,
                                  refine_iters=opt.lobpcg_refine)

    def cert(Y, C, C32=None):
        z, obj = _z_obj(Y, C, dense)
        mvr, mvr32 = mvr_for(C, z), mvr32_for(C32, z)
        if warm["X0"] is None:
            res = lob(Y, mvr, mvr32, None, opt.lobpcg_maxiter)
        else:
            res = lob(Y, mvr, mvr32, warm["X0"], opt.lobpcg_maxiter_warm)
            if decides(res):
                res = lob(Y, mvr, mvr32, res.neg_vecs, opt.lobpcg_maxiter)
        return finish(z, obj, res)

    cert.reads_f32 = cert32
    return cert


def _symcoo(C, device) -> SymCOO:
    if isinstance(C, SymCOO):
        return C
    import scipy.sparse as sp
    C = sp.coo_matrix(C)
    # <C, X> depends only on the symmetric part; the RTR cost/grad
    # assume symmetry, so enforce it here
    return SymCOO.from_scipy(0.5 * (C + C.T), device)


@recorded
def solve_maxcut_unitdiag(C, options: Optional[SolverOptions] = None,
                          Y0: Optional[np.ndarray] = None,
                          resume: Optional[str] = None,
                          device="cuda", **overrides) -> SDPResult:
    """Solve min <C,X> s.t. diag(X)=1, X>=0 via Burer-Monteiro RTR.

    ``C``: a scipy sparse matrix, a dense array or a SymCOO.
    ``resume``: path of a ``checkpoint_every`` snapshot (the outer state
    is just the factor Y).  ``device``: where the solve runs; "cuda"
    (the default) raises when no GPU is present — the solver never moves
    to the CPU on its own.
    """
    timers = current()
    with timers.timed("operator"):
        device = resolve_device(device)
        if resume:
            from ..utils.checkpoint import resume_kwargs
            Y0 = resume_kwargs(resume).get("Y0", Y0)
        opt = merged_options("maxcut_unitdiag", options, **overrides)
        C = _symcoo(C, device)
        n = C.n
        use_eigh = (opt.eig_method == "eigh") or \
            (opt.eig_method == "auto" and n < opt.eig_switch_n)
        dense = (n <= opt.dense_cost_max_n or
                 n * n <= opt.dense_cost_nnz_factor * C.nnz)
        C_param = C.to_dense() if dense else C
        k_cert = opt.delta + 1

        if opt.verbose:
            print("ManiSDP-TPU (maxcut/unitdiag, torch) is starting...",
                  flush=True)
            print(f"SDP size: n = {n}, m = {n}", flush=True)

        gen = torch.Generator(device=device)
        gen.manual_seed(opt.seed)
        problem = make_maxcut_problem(dense)
        cost_only = lambda Y, Cp: problem.cost(Y, Cp)[0]  # noqa: E731
        line_search = make_line_search(cost_only, Oblique.renormalize)
        cert_fn = _make_cert(opt, n, k_cert, use_eigh, dense, gen)
        # C in f32, built once per solve where an f32 stage reads it: the
        # sparse path's tcg32 loop, the mixed pre-stage's RTR and the
        # certificate's f32 LOBPCG stage
        mixed = opt.inner_dtype == "mixed"
        C32 = None
        if mixed or cert_fn.reads_f32 or (opt.inner_dtype == "tcg32" and
                                          not dense):
            C32 = C_param.to(torch.float32) if dense else \
                C.astype(torch.float32)
        rank = RankController(opt.theta, opt.delta, opt.alpha,
                              nne_floor=True, bucket=opt.p_bucket)
        slow = SlowProgress(period=20, warmup=50)
        use32 = opt.inner_dtype == "tcg32"

        p = opt.p0
        p_pad = bucketed(p, opt.p_bucket)
        typdist = float(math.pi * math.sqrt(n))
        as_dev = lambda a: torch.as_tensor(  # noqa: E731
            a, dtype=torch.float64, device=device)
        if Y0 is not None:
            Y0 = np.asarray(Y0, dtype=np.float64)
            p = Y0.shape[0]
            p_pad = bucketed(p, opt.p_bucket)
            Y = as_dev(pad_rows(Y0, p_pad))
        else:
            Y = Oblique.rand(gen, p, n, p_pad)
        U_dir = None

        status = 0
        total_tr = total_hess = 0
        fac_size = []
        history = []
        obj = dinf = gradnorm = np.nan
        z_dev = None
        it = 0

    for it in range(1, opt.max_outer + 1):
        with timers.timed("rtr"):
            fac_size.append(p)
            tcg32 = use32 and not dense
            budget = TROptions(maxiter=opt.tr_maxiter,
                               maxinner=opt.tr_maxinner,
                               tolgradnorm=opt.tolgradnorm,
                               tcg_dtype="float32" if tcg32 else None)
            solve = make_trustregions(problem, budget)
            if U_dir is not None:
                Y = line_search(Y, as_dev(U_dir), C_param)
            if mixed:
                Y, tr32, hv32 = mixed_prestage(problem, budget, opt,
                                               gradnorm, Y, C32, typdist)
                total_tr += tr32
                total_hess += hv32
            res = solve(Y, C_param, typdist,
                        params_tcg=C32 if tcg32 else None)
            Y = res.Y
            gradnorm = float(res.norm_grad)
            total_tr += res.iters
            total_hess += res.inner_iters

        with timers.timed("cert"):
            z_dev, obj, dinf, num_neg, neg_vecs, neg_vals = cert_fn(
                Y, C_param, C32 if cert_fn.reads_f32 else None)

        with timers.timed("rank"):
            r, e, Ul = rank.truncation(Y, p)
            log_iter(opt.verbose, it, obj, dinf=dinf, r=r, p=p,
                     wall=timers.wall())
            history.append(dict(iter=it, obj=obj, dinf=dinf, r=r, p=p,
                                gradnorm=gradnorm))
            timers.log_delta(opt.verbose)
            if dinf < opt.tol:
                if opt.verbose:
                    print("Optimality is reached!", flush=True)
                break
            if slow.check(it, dinf):
                if use32:
                    # precision fallback: demote the f32 tCG inner loop to
                    # f64 and keep going instead of bailing with status 2
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

            # ---- rank update (host) ----
            Y_host = Y.cpu().numpy()
            if r <= p - 1:
                Y_host = (Ul[:, :r].T @ Y_host)
                p = r
            else:
                Y_host = Y_host[:p]
            nne = rank.num_escape(int(num_neg))
            vs = neg_vecs[:, :nne]                               # (n, nne)
            if opt.line_search:
                U_host = np.vstack([np.zeros((p, n)), vs.T])
                Y_host = np.vstack([Y_host, np.zeros((nne, n))])
            else:
                U_host = None
                Y_host = np.vstack([Y_host, opt.alpha * vs.T])
                Y_host = Y_host / np.sqrt(np.sum(Y_host ** 2, axis=0))
            p = p + nne
            p_pad = max(p_pad, bucketed(p, opt.p_bucket))
            Y = as_dev(pad_rows(Y_host, p_pad))
            U_dir = pad_rows(U_host, p_pad) if U_host is not None else None

            if opt.checkpoint_every and opt.checkpoint_path and \
                    it % opt.checkpoint_every == 0:
                from ..utils.checkpoint import save_state
                save_state(opt.checkpoint_path, Y=Y_host[:p], iteration=it)

    else:
        it = opt.max_outer

    with timers.timed("result"):
        if status == 0 and dinf > opt.tol:
            status = 1
            if opt.verbose:
                print("Iteration maximum is reached!", flush=True)

        if opt.verbose:
            print(f"ManiSDP-TPU: optimum = {obj:0.8f}, "
                  f"time = {timers.wall():0.2f}s", flush=True)

        Y_act = Y.cpu().numpy()[:p]
        X = Y_act.T @ Y_act
        z = z_dev.cpu().numpy() if z_dev is not None else None
        return SDPResult(X=X, obj=obj, Y=Y_act, z=z, dinf=dinf, eta=dinf,
                         gradnorm=gradnorm, status=status,
                         iterations=it, fac_size=fac_size, rtr_iters=total_tr,
                         hess_calls=total_hess, history=history,
                         timers=timers.t)
