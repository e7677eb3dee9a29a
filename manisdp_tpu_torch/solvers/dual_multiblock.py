"""Dual multiblock Riemannian ADMM (PyTorch port of
manisdp_tpu/solvers/dual_multiblock.py; src/dual/ManiDSDP_multiblock.m):
the first ``nob`` slack blocks unit-diagonal (oblique), the rest
Euclidean.

The flat-factor design of the primal multiblock driver (one (p_max, N)
factor over the concatenated block columns, the masked product geometry
on kernel K2), with the dual family's dense objects restricted to the
block diagonal by a 0/1 (N, N) mask: S = (YᵀY) ∘ BD is the block-diagonal
slack the reference holds as a cell array, and every dense operand
(multiplier, bA, C, adjoints) is block-diagonal by construction, so the
dense products Y·M (``torch.matmul``) stay right.  The operator is the
port's ``DualOp`` on the flat column space (kernel K4), and the composite
x-update's iAB pair runs on K4 as in the general dual driver.  The
certificate is a batched f64 device eigh of Xp's diagonal blocks
(``multiblock.BlockEigh``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import scipy.sparse as sp
import torch

from ..config import SolverOptions, merged_options
from ..core import Problem, make_trustregions
from ..kernels import oblique_cols
from ..manifolds.product import MaskedProduct
from ..ops.dualops import DualOp, SparseMat
from .common import (SDPResult, SlowProgress, bucketed, current, log_iter,
                     make_line_search, mixed_prestage, pad_rows, recorded,
                     resolve_device)
from .dual_al import _B_rmatvec, _iab_mat, _iab_rmat
from .multiblock import (BlockEigh, block_rank_update, budgets, column_mask,
                         initial_factor)


def _make_problem(M: MaskedProduct, BD, pure: bool):
    """cost / grad / hess; params = dict(op, Xm, w, sigma (Python float),
    iAB (None when pure))."""

    cast = {BD.dtype: BD}

    def bd(like):
        """BD in ``like``'s dtype, cast once for the f32 tCG."""
        if like.dtype not in cast:
            cast[like.dtype] = BD.to(like.dtype)
        return cast[like.dtype]

    def cost(Y, params):
        op, Xm, w, sigma = (params["op"], params["Xm"], params["w"],
                            params["sigma"])
        S = (Y.T @ Y) * bd(Y)
        y = op.y_step(S)
        As = op.residual(y, S, Xm, sigma)   # adjoint(y) - (S-C) - Xm/sigma
        Af = _B_rmatvec(op, y) - op.cf - w / sigma
        f = torch.dot(op.b, y) + 0.5 * sigma * \
            (torch.sum(As * As) + torch.dot(Af, Af))
        return f, (As, Af)

    def grad(Y, params, aux):
        op, sigma, iAB = params["op"], params["sigma"], params["iAB"]
        As, Af = aux
        if pure:
            tt = op.bA - sigma * As
        else:
            tt = op.bA + sigma * (
                _iab_mat(iAB, op.n, Af)
                + op.adjoint_scaled(op.apply(As)) - As)
        eG = 2.0 * Y @ tt
        YeG = torch.sum(Y * eG, dim=0) * M.mask_as(Y)
        return eG - Y * YeG[None, :], (tt, YeG)

    def hess(Y, U, params, aux, gaux):
        op, sigma, iAB = params["op"], params["sigma"], params["iAB"]
        tt, YeG = gaux
        T = (U.T @ Y) * bd(Y)                 # blockwise U_i' Y_i
        yAU = op.adjoint_scaled(op.apply(T))
        if pure:
            tYU = -2.0 * yAU
        else:
            tYU = -4.0 * yAU \
                + 2.0 * _iab_mat(iAB, op.n, _iab_rmat(iAB, T)) \
                + 2.0 * op.adjoint_scaled(op.apply(yAU))
        eH = 2.0 * U @ tt + 2.0 * sigma * (Y @ (T + T.T)) \
            + 2.0 * sigma * (Y @ tYU)
        # eH - Y o (colsum(Y o eH) o mask) - U o YeG: K2 with the mask
        return oblique_cols(Y, eH, "proj", v=U, g=YeG, mask=M.mask_as(Y))

    def cost_only(Y, params):
        return cost(Y, params)[0]

    return Problem(manifold=M, cost=cost, grad=grad, hess=hess), cost_only


def _iab_flat(A, ns, f: int, m: int, dAAt, device) -> SparseMat:
    """iAB = A_psd' D^{-1} B with its rows remapped from the stacked
    per-block vecs into the flat (N, N) column space, row-major."""
    N = int(np.sum(ns))
    off = np.concatenate([[0], np.cumsum(ns)]).astype(np.int64)
    Acsr = sp.csr_matrix(A)
    Bm = Acsr[:, :f]
    Ap = Acsr[:, f:].tocoo()
    if dAAt is None:
        dAAt_l = np.zeros(m)
        np.add.at(dAAt_l, Ap.row, Ap.data ** 2)
    else:
        dAAt_l = np.asarray(dAAt, dtype=np.float64).ravel()
    D_inv = sp.diags(1.0 / dAAt_l)
    Mi = (Ap.T @ (D_inv @ Bm)).tocoo()
    nsa = np.asarray(ns, dtype=np.int64)
    off2 = np.concatenate([[0], np.cumsum(nsa ** 2)])
    bl = np.searchsorted(off2, Mi.row, side="right") - 1
    loc = Mi.row - off2[bl]
    gi = loc % nsa[bl] + off[bl]
    gj = loc // nsa[bl] + off[bl]
    return SparseMat.from_scipy(
        sp.coo_matrix((Mi.data, (gi * N + gj, Mi.col)), shape=(N * N, f)),
        device)


@recorded
def solve_dual_multiblock(A, b, c, ns: Sequence[int], nob: int,
                          f: int = 0, dAAt=None,
                          options: Optional[SolverOptions] = None,
                          device="cuda",
                          **overrides) -> SDPResult:
    """SeDuMi dual multiblock input: A (m, f + sum n_i^2), free block
    first; K.s = ns, K.nob = nob.  ``device``: where the solve runs; "cuda"
    (the default) raises when no GPU is present."""
    timers = current()
    with timers.timed("operator"):
        device = resolve_device(device)
        opt = merged_options("dual_multiblock", options, **overrides)
        ns = [int(x) for x in ns]
        nb = len(ns)
        pure = (nob == nb)
        op = DualOp.build(A, b, c, 0, f=f, dAAt=dAAt, ns=ns, device=device)
        N, m = op.n, op.m
        off = np.concatenate([[0], np.cumsum(ns)]).astype(int)
        M = MaskedProduct(column_mask(ns, nob), device)
        BD = torch.zeros((N, N), dtype=torch.float64, device=device)
        for bidx in range(nb):
            BD[off[bidx]:off[bidx + 1], off[bidx]:off[bidx + 1]] = 1.0
        iAB = _iab_flat(A, ns, f, m, dAAt, device) \
            if not pure and f > 0 else None

        if opt.verbose:
            print("ManiSDP-TPU (dual multiblock, torch) is starting...",
                  flush=True)
            print(f"SDP size: n = {max(ns)}, m = {m}", flush=True)

        problem, cost_only = _make_problem(M, BD, pure)
        budget = budgets(opt)
        line_search = make_line_search(
            cost_only, M.renormalize,
            ls_dtype="float32" if opt.inner_dtype == "tcg32" else None)
        mixed = opt.inner_dtype == "mixed"
        op32 = iab32 = None
        if opt.inner_dtype == "tcg32" or mixed:
            op32 = op.astype(torch.float32)
            iab32 = iAB.astype(torch.float32) if iAB is not None else None

        normc = float(1.0 + np.sqrt(
            float(torch.sum(op.C * op.C)) + float(torch.dot(op.cf, op.cf))))

        def stats(Y, Xm, w, sigma):
            S = (Y.T @ Y) * BD
            y = op.y_step(S)
            As = op.residual(y, S)
            Af = _B_rmatvec(op, y) - op.cf
            pinf = (torch.sqrt(torch.sum(As * As)) + torch.linalg.norm(Af)) \
                / normc
            by = torch.dot(op.b, y)
            if pure:
                Xm_new = Xm - sigma * As
            else:
                Xm_new = Xm + sigma * (
                    _iab_mat(iAB, N, Af - w / sigma)
                    + op.adjoint_scaled(op.apply(As - Xm / sigma)) - As)
            w_new = w - sigma * Af
            eX = Xm_new + op.bA
            z = torch.sum(S * eX, dim=0) * M.mask
            Xp = eX - torch.diag(z)
            obj = torch.sum(op.C * eX) + torch.dot(op.cf, w_new) + torch.sum(z)
            gap = torch.abs(obj - by) / (1.0 + torch.abs(obj) + torch.abs(by))
            return S, y, Xm_new, w_new, Xp, z, obj, pinf, gap

        blocks = BlockEigh(ns, opt.delta, device)
        p0 = opt.p0 if np.ndim(opt.p0) else [int(opt.p0)] * nb
        ps = [ns[i] if ns[i] < opt.min_facsize else int(p0[i])
              for i in range(nb)]
        p_pad = bucketed(max(ps), opt.p_bucket)

        gen = torch.Generator(device=device)
        gen.manual_seed(opt.seed)
        as_dev = lambda a: torch.as_tensor(  # noqa: E731
            a, dtype=torch.float64, device=device)
        Y = as_dev(initial_factor(gen, p_pad, ns, off, ps, nob))
        U_dir = None

        Xm = torch.zeros((N, N), dtype=torch.float64, device=device)
        w = torch.zeros(op.f, dtype=torch.float64, device=device)
        sigma = float(opt.sigma0)
        slow = SlowProgress(50, 100)
        status = 0
        total_tr = total_hess = 0
        fac_size, history = [], []
        obj = gap = pinf = dinf = gradnorm = eta = np.nan
        S_dev = y_dev = Xp_dev = z_dev = None
        it = 0
        tier = 0
        use32 = opt.inner_dtype == "tcg32"
        frozen = 0          # consecutive endgame iterations with frozen sigma

    for it in range(1, opt.max_outer + 1):
        with timers.timed("rtr"):
            fac_size.append(max(ps))
            solve = make_trustregions(problem, budget(tier, use32))
            params = dict(op=op, Xm=Xm, w=w, sigma=sigma, iAB=iAB)
            if U_dir is not None:
                Y = line_search(Y, U_dir, params)
            typdist = MaskedProduct.typicaldist(ns, ps, nob)
            params32 = dict(op=op32, Xm=Xm.to(torch.float32),
                            w=w.to(torch.float32), sigma=sigma,
                            iAB=iab32) if use32 or mixed else None
            # the f32 pre-stage runs in tier 0 only, not in the endgame
            if mixed and tier == 0:
                Y, tr32, hv32 = mixed_prestage(
                    problem, budget(tier, False), opt, gradnorm, Y,
                    params32, typdist)
                total_tr += tr32
                total_hess += hv32
            params_tcg = params32 if use32 else None
            res = solve(Y, params, typdist, params_tcg=params_tcg)
            Y = res.Y
            gradnorm = float(res.norm_grad)
            total_tr += res.iters
            total_hess += res.inner_iters

        with timers.timed("stats"):
            (S_dev, y_dev, Xm, w, Xp_dev, z_dev, obj_d, pinf_d,
             gap_d) = stats(Y, Xm, w, sigma)
            obj, pinf, gap = float(obj_d), float(pinf_d), float(gap_d)
        with timers.timed("cert"):
            certs, dinf = blocks.certify(blocks.from_dense(Xp_dev))

        with timers.timed("rank"):
            log_iter(opt.verbose, it, obj, gap=gap, pinf=pinf, dinf=dinf,
                     gradnorm=gradnorm, p=max(ps), sigma=sigma,
                     wall=timers.wall())
            history.append(dict(iter=it, obj=obj, gap=gap, pinf=pinf,
                                dinf=dinf, gradnorm=gradnorm, p=max(ps),
                                sigma=sigma))
            eta = max(gap, pinf, dinf)
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

            # per-block rank update (ManiDSDP_multiblock.m:145-182)
            Y_host, U_host = block_rank_update(
                Y.cpu().numpy().copy(), certs, ns, off, ps, nob, opt,
                strict=True, escape=True)
            p_act = max(max(ps), 1)
            p_pad = max(p_pad, bucketed(p_act, opt.p_bucket))
            Y = as_dev(pad_rows(Y_host[:p_act], p_pad))
            U_dir = as_dev(pad_rows(U_host[:p_act], p_pad)) \
                if U_host is not None else None

            if pinf < opt.tau1 * gradnorm:
                sigma = max(sigma / opt.gama, opt.sigma_min)
                frozen = 0
            elif pinf > opt.tau2 * gradnorm:
                sigma = min(sigma * opt.gama, opt.sigma_max)
                frozen = 0
            else:
                # endgame boost: sigma frozen with only dinf above tol ->
                # escalate the TR budget
                if (opt.endgame_boost and tier == 0 and
                        gap <= 10 * opt.tol and pinf <= 10 * opt.tol and
                        dinf > opt.tol):
                    frozen += 1
                    if frozen >= opt.boost_after:
                        tier = 1
                else:
                    frozen = 0
    else:
        it = opt.max_outer

    with timers.timed("result"):
        if status == 0 and eta > opt.tol:
            status = 1
            if opt.verbose:
                print("Iteration maximum is reached!", flush=True)

        if opt.verbose:
            print(f"ManiDSDP-TPU: optimum = {obj:0.8f}, "
                  f"time = {timers.wall():0.2f}s", flush=True)

        host = lambda t: None if t is None else t.cpu().numpy()  # noqa: E731
        Xp_h = host(Xp_dev)
        X_blocks = [Xp_h[off[i]:off[i + 1], off[i]:off[i + 1]]
                    for i in range(nb)] if Xp_h is not None else None
        return SDPResult(
            X=X_blocks, obj=obj, Y=Y.cpu().numpy(), y=host(y_dev),
            S=host(S_dev), z=host(z_dev), gap=gap, pinf=pinf, dinf=dinf,
            eta=eta, gradnorm=gradnorm, status=status,
            iterations=it, fac_size=fac_size, rtr_iters=total_tr,
            hess_calls=total_hess, history=history, timers=timers.t,
            sigma=sigma, tier=tier)
