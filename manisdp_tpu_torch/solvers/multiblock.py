"""Primal multiblock driver: X in S+^{n_1 x ... x n_t}, the first ``nob``
blocks unit-diagonal (PyTorch port of manisdp_tpu/solvers/multiblock.py;
src/primal/ManiSDP_multiblock.m).

All block factors live in ONE flat (p_max, N) factor over the concatenated
block columns (N = sum n_i):
  - a per-column oblique mask drives the product geometry
    (``manifolds/product.py``: kernel K2 with its column mask);
  - the constraint operator lives on the unified column space
    (``ConstraintOp.build_multiblock``: kernels K3, K4 and K1's ``al_hess``
    as in the primal AL driver), so X stays block-diagonal;
  - the certificate takes each block of S = mat(c - A'y) - diag(z) on the
    device and runs one batched f64 ``torch.linalg.eigh`` per block size
    (the JAX package assembles a dense host S and runs ``np.linalg.eigh``
    per block);
  - per-block rank control runs on the host, as in the JAX package: each
    block occupies rows 0 .. p_i - 1 of its column group, zero below.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import SolverOptions, merged_options
from ..core import Problem, TROptions, make_trustregions
from ..kernels import oblique_cols, symcoo_spmm
from ..manifolds.product import MaskedProduct
from ..ops.sparse import ConstraintOp
from .common import (SDPResult, SlowProgress, bucketed, current, log_iter,
                     make_line_search, mixed_prestage, pad_rows, recorded,
                     resolve_device)


def _make_problem(M: MaskedProduct):
    """Masked variant of the unit-diagonal AL callbacks
    (ManiSDP_multiblock.m:207-249): Euclidean-block columns skip the
    oblique projection and shift through the 0/1 column mask."""

    def cost(Y, params):
        op, y, sigma = params["op"], params["y"], params["sigma"]
        e = op.pattern_pair_dots(Y)
        cx = torch.dot(op.c_pattern, e)
        Axb = op.apply_from_e(e) - op.b - y / sigma
        return cx + 0.5 * sigma * torch.dot(Axb, Axb), (Axb, e)

    def grad(Y, params, aux):
        op, sigma = params["op"], params["sigma"]
        Axb, _ = aux
        es = op.es_vals(Axb, sigma)
        eG = 2.0 * op.matmat_pattern(Y, es)
        YeG = torch.sum(Y * eG, dim=0) * M.mask_as(Y)
        return eG - Y * YeG[None, :], (es, YeG)

    def hess(Y, U, params, aux, gaux):
        # eH = 2 U mat(es) + 4 sigma Y mat(A'A vec(Y'U)) (K1 al_hess), then
        # the masked epilogue eH - Y o (colsum(Y o eH) o mask) - U o YeG
        # (K2 proj with the eG term and the mask)
        op, sigma = params["op"], params["sigma"]
        es, YeG = gaux
        eH = symcoo_spmm(U, op.pat, "al_hess", vals=es, B=Y,
                         vals2=op.normal_factored(Y, U),
                         coefs=(2.0, 4.0 * sigma))
        return oblique_cols(Y, eH, "proj", v=U, g=YeG, mask=M.mask_as(Y))

    def cost_only(Y, params):
        return cost(Y, params)[0]

    return Problem(manifold=M, cost=cost, grad=grad, hess=hess), cost_only


class BlockEigh:
    """The diagonal blocks of an (N, N) block-diagonal matrix, eigen-
    decomposed on the device: one batched f64 ``torch.linalg.eigh`` per
    distinct block size.  ``k`` leading eigenvectors per block come back to
    the host for the escape step."""

    def __init__(self, ns: Sequence[int], k: int, device):
        self.ns = [int(x) for x in ns]
        self.off = np.concatenate([[0], np.cumsum(self.ns)]).astype(int)
        self.k = k
        self.device = device
        sizes = {}
        for b, s in enumerate(self.ns):
            sizes.setdefault(s, []).append(b)
        # (size, block ids, (n_blocks, size) global column indices)
        self.groups = [
            (s, np.asarray(bl), torch.as_tensor(
                self.off[bl][:, None] + np.arange(s)[None, :],
                device=device))
            for s, bl in sorted(sizes.items())]

    def pattern_map(self, pi: np.ndarray, pj: np.ndarray):
        """For pattern entries (pi, pj), all inside diagonal blocks: per
        group the entry ids and their (block in group, local i, local j)."""
        blk = np.searchsorted(self.off, pi, side="right") - 1
        if np.any(np.searchsorted(self.off, pj, side="right") - 1 != blk):
            raise ValueError("a pattern entry couples two blocks")
        out = []
        for s, bl, _ in self.groups:
            pos = np.full(len(self.ns), -1)
            pos[bl] = np.arange(bl.size)
            sel = np.nonzero(pos[blk] >= 0)[0]
            b = blk[sel]
            as_t = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
            out.append((as_t(sel), as_t(pos[b]), as_t(pi[sel] - self.off[b]),
                        as_t(pj[sel] - self.off[b])))
        return out

    def from_pattern(self, pmap, sv, z):
        """Stacked blocks of S = mat(sv) - diag(z), sv on the pattern."""
        mats = []
        for (s, bl, idx), (sel, gp, li, lj) in zip(self.groups, pmap):
            Sg = torch.zeros((bl.size, s, s), dtype=sv.dtype,
                             device=sv.device)
            Sg[gp, li, lj] = sv[sel]
            Sg.diagonal(dim1=1, dim2=2).sub_(z[idx])
            mats.append(Sg)
        return mats

    def from_dense(self, X):
        """Stacked diagonal blocks of a dense (N, N) X."""
        return [X[idx[:, :, None], idx[:, None, :]]
                for _, _, idx in self.groups]

    def certify(self, mats):
        """Per block (ascending eigenvalues, the first k eigenvectors) as
        host arrays, and dinf = max_b max(0, -lam_min) / (1 + |lam_max|)."""
        certs: List = [None] * len(self.ns)
        dinf = 0.0
        for (s, bl, _), Sg in zip(self.groups, mats):
            w, V = torch.linalg.eigh(Sg)
            d = torch.clamp(-w[:, 0], min=0.0) / (1.0 + torch.abs(w[:, -1]))
            dinf = max(dinf, float(torch.max(d)))
            w_h = w.cpu().numpy()
            V_h = V[:, :, :min(self.k, s)].cpu().numpy()
            for g, b in enumerate(bl):
                certs[b] = (w_h[g], V_h[g])
        return certs, dinf


def block_rank_update(Y_host, certs, ns, off, ps, nob: int,
                      opt: SolverOptions, strict: bool, escape: bool):
    """Per-block rank truncation and escape on the host (the JAX package's
    loops, ManiSDP_multiblock.m:112-151 / ManiDSDP_multiblock.m:145-182).
    ``strict``: the dual's e_sv > theta e_sv[0] (else >=, and blocks at
    rank 1 keep it); ``escape`` False: no escape rows (the certificate
    already passes).  Updates ``ps`` in place; returns (Y_host, U_host)."""
    U_host = np.zeros_like(Y_host) if opt.line_search else None
    N = Y_host.shape[1]
    for bidx in range(len(ns)):
        if ns[bidx] < opt.min_facsize:
            continue
        sl = slice(off[bidx], off[bidx + 1])
        pb = ps[bidx]
        if strict or pb > 1:
            Yb = Y_host[:, sl]
            wv, V = np.linalg.eigh(Yb @ Yb.T)
            wv = np.maximum(wv, 0.0)
            ordr = np.argsort(wv)[::-1][:max(pb, 1)]
            e_sv = np.sqrt(wv[ordr])
            keep = e_sv > opt.theta * e_sv[0] if strict else \
                e_sv >= opt.theta * e_sv[0]
            r = max(int(np.sum(keep)), 1)
            if r < pb:
                Ynew = V[:, ordr[:r]].T @ Yb
                Y_host[:, sl] = 0.0
                Y_host[:r, sl] = Ynew
                ps[bidx] = r
                pb = r
        vals, vecs = certs[bidx]
        if not escape:
            nne = 0
        elif bidx < nob:
            nne = max(min(int(np.sum(vals < 0)), opt.delta), 1)
        else:
            nne = min(int(np.sum(vals < 0)), opt.delta)
        if pb + nne > ns[bidx]:
            nne = 0
        if nne > 0:
            vs = vecs[:, :nne]
            grow = max(pb + nne - Y_host.shape[0], 0)
            if grow:
                Y_host = np.vstack([Y_host, np.zeros((grow, N))])
                if U_host is not None:
                    U_host = np.vstack([U_host, np.zeros((grow, N))])
            if opt.line_search:
                U_host[pb:pb + nne, sl] = vs.T
            else:
                Y_host[pb:pb + nne, sl] = opt.alpha * vs.T
                if bidx < nob:
                    Yb = Y_host[:, sl]
                    Y_host[:, sl] = Yb / np.sqrt(np.sum(Yb ** 2, axis=0))
            ps[bidx] = pb + nne
    return Y_host, U_host


def initial_factor(gen, p_pad: int, ns, off, ps, nob: int) -> np.ndarray:
    """Seeded Gaussian block factors (oblique blocks column-normalized), each
    on rows 0 .. p_i - 1 of its column group."""
    N = int(off[-1])
    rnd = torch.randn((p_pad, N), generator=gen, dtype=torch.float64,
                      device=gen.device).cpu().numpy()
    Y_host = np.zeros((p_pad, N))
    for bidx in range(len(ns)):
        sl = slice(off[bidx], off[bidx + 1])
        Yb = rnd[:ps[bidx], sl]
        if bidx < nob:
            Yb = Yb / np.sqrt(np.sum(Yb ** 2, axis=0))
        Y_host[:ps[bidx], sl] = Yb
    return Y_host


def column_mask(ns, nob: int) -> np.ndarray:
    off = np.concatenate([[0], np.cumsum(ns)]).astype(int)
    mask = np.zeros(int(off[-1]))
    mask[:off[nob]] = 1.0
    return mask


def budgets(opt: SolverOptions):
    """The tiered TR budgets: tier 0 the reference's, tier 1 the endgame
    escalation engaged when sigma freezes with dinf the only blocker."""
    def budget(tier, use32):
        kw = dict(tolgradnorm=opt.tolgradnorm,
                  tcg_dtype="float32" if use32 else None)
        if tier == 0:
            return TROptions(maxiter=opt.tr_maxiter,
                             maxinner=opt.tr_maxinner, **kw)
        return TROptions(maxiter=max(opt.boost_tr_maxiter, opt.tr_maxiter),
                         maxinner=max(opt.boost_tr_maxinner,
                                      opt.tr_maxinner), **kw)
    return budget


@recorded
def solve_multiblock(At, b, c, ns: Sequence[int], nob: int,
                     options: Optional[SolverOptions] = None,
                     Y0: Optional[np.ndarray] = None,
                     y0: Optional[np.ndarray] = None,
                     ps0: Optional[Sequence[int]] = None,
                     resume: Optional[str] = None,
                     device="cuda",
                     **overrides) -> SDPResult:
    """SeDuMi multiblock input: At (sum n_i^2, m), K.s = ns, K.nob = nob
    (or a ConstraintOp from ``ConstraintOp.build_multiblock`` already on
    ``device`` in place of At).

    ``Y0`` / ``y0`` / ``ps0`` warm-start the flat factor, multipliers and
    per-block ranks; ``resume`` loads all of them (and sigma) from a
    checkpoint_every snapshot.  ``device``: where the solve runs; "cuda"
    (the default) raises when no GPU is present."""
    timers = current()
    with timers.timed("operator"):
        device = resolve_device(device)
        if resume:
            from ..utils.checkpoint import resume_kwargs
            rk = resume_kwargs(resume)
            Y0 = rk.get("Y0", Y0)
            y0 = rk.get("y0", y0)
            ps0 = rk.get("ps0", ps0)
            if "sigma0" in rk:
                overrides.setdefault("sigma0", rk["sigma0"])
        opt = merged_options("multiblock", options, **overrides)
        ns = [int(x) for x in ns]
        nb = len(ns)
        if isinstance(At, ConstraintOp):
            op = At
            if op.device.type != device.type:
                raise ValueError(f"the ConstraintOp lives on {op.device}, the "
                                 f"solve was asked for {device}")
        else:
            op = ConstraintOp.build_multiblock(At, b, c, ns, device)
        N, m = op.n, op.m
        off = np.concatenate([[0], np.cumsum(ns)]).astype(int)
        M = MaskedProduct(column_mask(ns, nob), device)

        if opt.verbose:
            print("ManiSDP-TPU (multiblock, torch) is starting...", flush=True)
            print(f"SDP size: n = {max(ns)}, m = {m}", flush=True)

        problem, cost_only = _make_problem(M)
        budget = budgets(opt)
        line_search = make_line_search(
            cost_only, M.renormalize,
            ls_dtype="float32" if opt.inner_dtype == "tcg32" else None)
        mixed = opt.inner_dtype == "mixed"
        op32 = op.astype(torch.float32) \
            if opt.inner_dtype == "tcg32" or mixed else None

        def stats(Y, y, sigma):
            e = op.pattern_pair_dots(Y)
            obj = torch.dot(op.pat.v, e)
            Axb = op.apply_from_e(e) - op.b
            pinf = torch.linalg.norm(Axb) / (1.0 + torch.linalg.norm(op.b))
            y_new = y - sigma * Axb
            sv = op.s_vals(y_new)
            # colsum_pattern(sv * e) = colsum(Y o Y mat(sv)): K1's cost
            # epilogue, summed in a fixed order
            z = symcoo_spmm(Y, op.pat, "cost", vals=sv)[1] * M.mask
            by = torch.dot(op.b, y_new) + torch.sum(z)
            gap = torch.abs(obj - by) / (torch.abs(by) + torch.abs(obj) + 1.0)
            return obj, pinf, y_new, sv, z, gap

        blocks = BlockEigh(ns, opt.delta, device)
        pmap = blocks.pattern_map(op.pat.i.cpu().numpy().astype(np.int64),
                                  op.pat.j.cpu().numpy().astype(np.int64))

        # per-block rank state
        p0 = opt.p0 if np.ndim(opt.p0) else [int(opt.p0)] * nb
        ps: List[int] = [ns[i] if ns[i] < opt.min_facsize else int(p0[i])
                         for i in range(nb)]
        if ps0 is not None:
            ps = [int(x) for x in ps0]
        p_pad = bucketed(max(ps), opt.p_bucket)

        gen = torch.Generator(device=device)
        gen.manual_seed(opt.seed)
        if Y0 is not None:
            Y0 = np.asarray(Y0, dtype=np.float64)
            p_pad = max(p_pad, bucketed(Y0.shape[0], opt.p_bucket))
            Y_host = pad_rows(Y0, p_pad)
        else:
            Y_host = initial_factor(gen, p_pad, ns, off, ps, nob)
        as_dev = lambda a: torch.as_tensor(  # noqa: E731
            a, dtype=torch.float64, device=device)
        Y = as_dev(Y_host)
        U_dir = None

        y = torch.zeros(m, dtype=torch.float64, device=device) if y0 is None \
            else as_dev(np.asarray(y0, dtype=np.float64).ravel())
        sigma = float(opt.sigma0)
        slow = SlowProgress(50, 100)
        status = 0
        total_tr = total_hess = 0
        fac_size, history = [], []
        obj = gap = pinf = dinf = gradnorm = eta = np.nan
        sv_dev = z_dev = None
        it = 0
        tier = 0
        use32 = opt.inner_dtype == "tcg32"
        frozen = 0          # consecutive endgame iterations with frozen sigma

    for it in range(1, opt.max_outer + 1):
        with timers.timed("rtr"):
            fac_size.append(max(ps))
            solve = make_trustregions(problem, budget(tier, use32))
            params = dict(op=op, y=y, sigma=sigma)
            if U_dir is not None:
                Y = line_search(Y, U_dir, params)
            typdist = MaskedProduct.typicaldist(ns, ps, nob)
            params32 = dict(op=op32, y=y.to(torch.float32),
                            sigma=sigma) if use32 or mixed else None
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
            obj_d, pinf_d, y, sv_dev, z_dev, gap_d = stats(Y, y, sigma)
            obj, pinf, gap = float(obj_d), float(pinf_d), float(gap_d)
        with timers.timed("cert"):
            certs, dinf = blocks.certify(
                blocks.from_pattern(pmap, sv_dev, z_dev))

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

            # ---- per-block rank update (ManiSDP_multiblock.m:112-151) ----
            # no escape when the certificate already passes: raw sign counting
            # would append junk directions off noise eigenvalues
            Y_host, U_host = block_rank_update(
                Y.cpu().numpy().copy(), certs, ns, off, ps, nob, opt,
                strict=False, escape=dinf > opt.tol)
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

            # checkpoint after the sigma update, so resume continues the same
            # trajectory
            if opt.checkpoint_every and opt.checkpoint_path and \
                    it % opt.checkpoint_every == 0:
                from ..utils.checkpoint import save_state
                save_state(opt.checkpoint_path, Y=Y_host[:p_act],
                           y=y.cpu().numpy(), sigma=sigma, tier=tier,
                           iteration=it, extra=dict(ps=np.asarray(ps)))
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

        Y_final = Y.cpu().numpy()
        X_blocks = [Y_final[:, off[i]:off[i + 1]].T
                    @ Y_final[:, off[i]:off[i + 1]] for i in range(nb)]
        S_host = None
        if sv_dev is not None:
            S_host = np.zeros((N, N))
            S_host[op.pat.i.cpu().numpy(), op.pat.j.cpu().numpy()] = \
                sv_dev.cpu().numpy()
            S_host[np.arange(N), np.arange(N)] -= z_dev.cpu().numpy()
        return SDPResult(
            X=X_blocks, obj=obj, Y=Y_final, y=y.cpu().numpy(), S=S_host,
            z=z_dev.cpu().numpy() if z_dev is not None else None,
            gap=gap, pinf=pinf, dinf=dinf, eta=eta, gradnorm=gradnorm,
            status=status, iterations=it, fac_size=fac_size,
            rtr_iters=total_tr, hess_calls=total_hess, history=history,
            timers=timers.t, sigma=sigma, tier=tier)
