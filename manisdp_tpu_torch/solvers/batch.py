"""Batched-instance MaxCut driver (PyTorch port of
manisdp_tpu/solvers/batch.py): B independent unit-diagonal SDPs

    min <C_b, X_b>  s.t.  diag(X_b) = 1,  X_b >= 0

solved together on one card, or data-parallel over the ``batch`` axis
of a device mesh.

Instances are grouped into n-buckets (n rounded up to ``n_bucket``); a
bucket's factors are one (B, p_pad, n_pad) tensor.  In an instance of
size n_b < n_pad the padding columns are free unit vectors with no cost
coupling (C's padded block is 0, or, sparse, their column segments are
empty), so cost, gradient and certificate are those of the unpadded
problem; the padded block of S = C - diag(z) is 0 and adds only zero
eigenvalues.  Padding rows (rank above the instance's own p_b) are 0.

Each outer iteration runs, for the L instances not yet certified at
once: the saddle-escape line search (per-instance alpha and accept
masks), the batched RTR (both loops masked per instance: kernels K1 in
instance mode, K2 over all columns, K11 for the tCG step), z_b =
colsum(Y_b o Y_b C_b), and the dual certificate as one batched f64
``torch.linalg.eigh`` of the (L, n_pad, n_pad) S on the card (the JAX
package runs a host eigh there).  The rank update (truncation by a
factor SVD, escape along the negative eigenvectors of S) runs on the
host per instance, as in the JAX package.  An instance that certifies
leaves the batch there, with the Y, z and obj of that iteration (the
JAX package keeps it in the batch and returns the last iteration's Y);
one that never does is returned as the last iteration left it.  A
sparse bucket's cost is a BatchedSymCOO (K1); a dense one an (L, n_pad,
n_pad) tensor and ``torch.matmul``.

The call's spans (utils/timers.py): ``operator`` (buckets, starts, the
dense C and its copy, the cost operator), per outer iteration ``rtr``,
``cert`` and ``rank`` (the bookkeeping and the host rank update), and
``result``; and the derived ``batch.held``: per outer iteration its wall
times the share of the call's instances certified before it, the time a
certified instance waits in its batch, weighted by instance.

With ``mesh=`` (a DeviceMesh with a ``batch`` axis of D ranks) each rank
solves a contiguous B / D of a bucket whose B the D divides (from the
random starts the whole bucket would get, so each instance follows its
unsharded trajectory), and the per-instance results are assembled on
every rank, one broadcast from each; a bucket D does not divide is
solved whole on every rank, as the JAX package leaves it unsharded.  The
dense-or-sparse decision and the first p_pad are taken on the whole
bucket.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from ..config import SolverOptions, merged_options
from ..core import TROptions, make_batched_trustregions
from ..kernels import symcoo_spmm
from ..manifolds import Oblique
from ..ops.sparse import BatchedSymCOO
from ..parallel.mesh import batch_rows, gather_rows, mesh_axis
from .common import (SDPResult, bucketed, current, make_batched_line_search,
                     recorded, resolve_device)
from .maxcut import make_maxcut_problem


@recorded
def solve_maxcut_batch(Cs, options: Optional[SolverOptions] = None,
                       mesh=None, n_bucket: int = 256, device="cuda",
                       **overrides) -> list:
    """Solve B unit-diagonal SDPs min <C_b, X> s.t. diag(X)=1, X>=0.

    ``Cs``: a sequence of B symmetric cost matrices, dense arrays and / or
    scipy sparse, of any sizes.  Instances are grouped into n-buckets (n
    rounded up to ``n_bucket``) and each bucket is solved as one batch; the
    dense or sparse cost follows the single-instance rule on the bucket's
    padded n.  ``mesh``: a DeviceMesh this process is a rank of; a bucket
    is split over its ``batch`` axis when the axis size divides the
    bucket's size (a mesh without that axis: every rank solves the whole
    batch).  ``device``: "cuda" (the default) raises without a card;
    "cpu" runs the kernels' plain twins; under a mesh, this rank's
    device.

    Returns a list of B SDPResult, index-aligned with ``Cs``; all share
    the call's ``timers``.
    """
    timers = current()
    with timers.timed("operator"):
        device = resolve_device(device)
        axis = None
        if mesh is not None and "batch" in (mesh.mesh_dim_names or ()):
            axis = mesh_axis(mesh, "batch")
        opt = merged_options("maxcut_unitdiag", options, **overrides)
        if opt.inner_dtype == "mixed":
            warnings.warn(
                "solve_maxcut_batch does not implement the mixed-precision "
                "inner solve yet; running the batch in float64 "
                "(inner_dtype='mixed' ignored)", stacklevel=3)
        B = len(Cs)
        ns = [int(C.shape[0]) for C in Cs]
        buckets: dict = {}
        for b, n in enumerate(ns):
            buckets.setdefault(bucketed(n, n_bucket), []).append(b)
        # the instances this process solves (a bucket the batch axis
        # divides is split over it): batch.held's weights
        solved = sum(len(ix) if axis is None or len(ix) % axis[0]
                     else len(ix) // axis[0] for ix in buckets.values())

        if opt.verbose:
            print("ManiSDP-TPU (maxcut batch, torch) is starting...",
                  flush=True)
            print(f"batch = {B}, sizes = {sorted(set(ns))}, "
                  f"buckets = {sorted(buckets)}", flush=True)

    out: list = [None] * B
    for nb in sorted(buckets):
        idxs = buckets[nb]
        results = _solve_group([Cs[i] for i in idxs], [ns[i] for i in idxs],
                               nb, opt, device, axis, solved)
        with timers.timed("result"):
            for i, r in zip(idxs, results):
                out[i] = r
    return out


def _solve_group(Cs, ns, n: int, opt: SolverOptions, device, axis,
                 solved: int) -> list:
    """One bucket; ``axis`` = (D, this rank's index, group) of the mesh's
    batch axis, or None; ``solved``: the instances the call solves in this
    process."""
    timers = current()
    with timers.timed("operator"):
        # dense vs sparse on the padded bucket size (the single-instance
        # rule)
        nnzs = [sp.coo_matrix(C).nnz if sp.issparse(C)
                else int(np.count_nonzero(C)) for C in Cs]
        dense = (n <= opt.dense_cost_max_n or
                 n * n <= opt.dense_cost_nnz_factor * max(max(nnzs), 1))
        # every instance's random start, drawn as for the whole bucket
        gen = torch.Generator(device=device)
        gen.manual_seed(opt.seed)
        p_pad = bucketed(opt.p0, opt.p_bucket)
        Y = torch.stack([Oblique.rand(gen, opt.p0, n, p_pad) for _ in Cs])
    if axis is None or len(Cs) % axis[0]:
        return _solve_instances(Cs, ns, n, opt, device, dense, Y, solved)
    D, me, group = axis
    rows = batch_rows(len(Cs), D, me)
    mine = _solve_instances(Cs[rows], ns[rows], n, opt, device, dense,
                            Y[rows].contiguous(), solved)
    with timers.timed("result"):
        return gather_rows(mine, group, device)


def _solve_instances(Cs, ns, n: int, opt: SolverOptions, device,
                     dense: bool, Y, solved: int) -> list:
    """Solve the instances ``Cs`` of a bucket of padded size n from the
    (B, p_pad, n) starts ``Y``; ``solved``: the instances the call solves
    in this process (batch.held's denominator).

    The batch holds the live instances only: one that certifies is
    returned as that outer iteration left it (Y, z, obj, dinf), and its
    rows leave Y, the cost and the certificate before the next one."""
    timers = current()
    with timers.timed("operator"):
        B = len(Cs)
        as_dev = lambda a: torch.as_tensor(  # noqa: E731
            a, dtype=torch.float64, device=device)

        # the zero-padded dense cost: the certificate's S, and the dense
        # cost
        Cs_dense = np.zeros((B, n, n))
        for b, C in enumerate(Cs):
            Cb = C.toarray() if sp.issparse(C) else np.asarray(C, float)
            Cs_dense[b, :ns[b], :ns[b]] = 0.5 * (Cb + Cb.T)
        C_dense = as_dev(Cs_dense)
        del Cs_dense
        C_param = C_dense if dense else \
            BatchedSymCOO.from_scipy(Cs, n, device)

        problem = make_maxcut_problem(dense)
        solve = make_batched_trustregions(problem, TROptions(
            maxiter=opt.tr_maxiter, maxinner=opt.tr_maxinner,
            tolgradnorm=opt.tolgradnorm))
        line_search = make_batched_line_search(
            lambda Y, Cp: problem.cost(Y, Cp)[0], Oblique.renormalize)

        def z_of(Y, C_param):
            """z_b = colsum(Y_b o Y_b C_b), (L, n)."""
            if dense:
                return torch.sum(Y * (Y @ C_param), dim=-2)
            return symcoo_spmm(Y, C_param, "cost")[1]

        live = np.arange(B)          # batch position -> instance
        p = np.full(B, opt.p0, dtype=np.int64)
        p_pad = Y.shape[1]
        typdist = float(np.pi * np.sqrt(n))
        U_dir = None
        k_cert = opt.delta + 1

        done = np.zeros(B, dtype=bool)
        obj = np.full(B, np.nan)
        dinf = np.full(B, np.nan)
        it_done = np.zeros(B, dtype=np.int64)
        z_final = np.zeros((B, n))
        Y_final = [None] * B
        tr_iters = np.zeros(B, dtype=np.int64)
        hess_calls = np.zeros(B, dtype=np.int64)
        fac_size = [[] for _ in range(B)]
        history = [[] for _ in range(B)]
        it = 0

    for it in range(1, opt.max_outer + 1):
        t_it, held = timers.wall(), B - live.size
        with timers.timed("rtr"):
            if U_dir is not None:
                Y = line_search(Y, as_dev(U_dir), C_param)
            res = solve(Y, C_param, typdist)
            Y = res.Y
            z = z_of(Y, C_param)
            obj_now = torch.sum(z, dim=1).cpu().numpy()
            tr_iters[live] += res.iters
            hess_calls[live] += res.inner_iters

        with timers.timed("cert"):
            # S_b = C_b - diag(z_b); padding columns add zero eigenvalues
            S = C_dense.clone()
            S.diagonal(dim1=-2, dim2=-1).sub_(z)
            vals, vecs = torch.linalg.eigh(S)
            del S
            vals_h = vals.cpu().numpy()
            neg_vecs = vecs[:, :, :k_cert].cpu().numpy()
            z_h = z.cpu().numpy()
            del vals, vecs

        with timers.timed("rank"):
            lam_min, lam_max = vals_h[:, 0], vals_h[:, -1]
            dinf_now = np.maximum(0.0, -lam_min) / (1.0 + lam_max)
            num_neg = np.sum(vals_h < 0, axis=1)

            for k, b in enumerate(live):
                obj[b], dinf[b] = obj_now[k], dinf_now[k]
                z_final[b] = z_h[k]
                it_done[b] = it
                fac_size[b].append(int(p[b]))
                history[b].append(dict(iter=it, obj=float(obj_now[k]),
                                       dinf=float(dinf_now[k]), p=int(p[b]),
                                       live=int(live.size)))
            certified = dinf_now < opt.tol
            done[live[certified]] = True
            if opt.verbose:
                print(f"Iter {it}, done {int(done.sum())}/{B}, "
                      f"median dinf:{np.median(dinf_now):0.1e}, "
                      f"p_pad:{p_pad}, time:{timers.wall():0.2f}s",
                      flush=True)
            timers.log_delta(opt.verbose)
            # the last iteration's live instances are returned as it left
            # them (their Y read in ``result``)
            finished = certified.all() or it == opt.max_outer
            if not finished:
                Y_h = Y.cpu().numpy()
                for k in np.nonzero(certified)[0]:
                    Y_final[live[k]] = Y_h[k, :p[live[k]]]
                keep = np.nonzero(~certified)[0]
                if keep.size < live.size:
                    live = live[keep]
                    C_dense = C_dense[torch.as_tensor(keep, device=device)]
                    C_param = C_dense if dense else C_param.select(keep)
                # ---- per-instance rank update (host) ----
                Y, U_dir, p[live], p_pad = _rank_update(
                    Y_h[keep], neg_vecs[keep], num_neg[keep], p[live],
                    p_pad, opt)
                Y = as_dev(Y)
        timers.add("batch.held", (timers.wall() - t_it) * held / solved)
        if finished:
            break

    with timers.timed("result"):
        status = np.where(done, 0, 1)
        if opt.verbose:
            print(f"ManiSDP-TPU batch: {int(done.sum())}/{B} optimal, "
                  f"time = {timers.wall():0.2f}s", flush=True)

        Y_h = Y.cpu().numpy()
        for k, b in enumerate(live):
            Y_final[b] = Y_h[k, :p[b]]
        out = []
        for b in range(B):
            Yb = Y_final[b][:, :ns[b]]            # strip the n padding
            out.append(SDPResult(
                X=Yb.T @ Yb, obj=float(obj[b]), Y=Yb, z=z_final[b, :ns[b]],
                dinf=float(dinf[b]), eta=float(dinf[b]),
                status=int(status[b]),
                iterations=int(it_done[b]) if done[b] else it,
                fac_size=fac_size[b], rtr_iters=int(tr_iters[b]),
                hess_calls=int(hess_calls[b]), history=history[b],
                timers=timers.t))
    return out


def _rank_update(Y_h, neg_vecs, num_neg, p, p_pad, opt):
    """The JAX package's per-instance rank update (solvers/batch.py:245-287)
    on the host, for the L live instances: truncate each factor where its
    singular values fall below theta * the largest, then append up to
    ``delta`` escape rows along the negative eigenvectors of S (as a
    line-search direction, or mixed in with weight alpha).  p_pad never
    shrinks.  Returns (Y, U or None, p, p_pad)."""
    L, _, n = Y_h.shape
    p_next = p.copy()
    plans = [None] * L
    for b in range(L):
        Yb = Y_h[b, :p[b]]
        sv = np.linalg.svd(Yb, compute_uv=False) if p[b] > 1 else \
            np.array([np.linalg.norm(Yb)])
        r = max(int(np.sum(sv >= opt.theta * sv[0])), 1)
        nne = max(min(int(num_neg[b]), opt.delta), 1)
        plans[b] = (r, nne)
        p_next[b] = (r if r <= p[b] - 1 else p[b]) + nne
    p_pad = max(bucketed(int(p_next.max()), opt.p_bucket), p_pad)

    Y_new = np.zeros((L, p_pad, n))
    U_new = np.zeros((L, p_pad, n))
    for b in range(L):
        r, nne = plans[b]
        Yb = Y_h[b, :p[b]]
        if r <= p[b] - 1:
            Uf, _, _ = np.linalg.svd(Yb, full_matrices=False)
            Yb = Uf[:, :r].T @ Yb
        pb = Yb.shape[0]
        vs = neg_vecs[b][:, :nne]
        if opt.line_search:
            Y_new[b, :pb] = Yb
            U_new[b, pb:pb + nne] = vs.T
        else:
            Yb = np.vstack([Yb, opt.alpha * vs.T])
            Y_new[b, :pb + nne] = Yb / np.sqrt(np.sum(Yb ** 2, axis=0))
    return Y_new, (U_new if opt.line_search else None), p_next, p_pad
