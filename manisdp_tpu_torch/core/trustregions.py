"""Riemannian trust-region solver with truncated CG (PyTorch port of
manisdp_tpu/core/trustregions.py).

The JAX package runs both loops as ``lax.while_loop``s in one compiled
program.  Here the outer TR loop is a Python loop with a host branch for
accept / reject (at most ``maxiter`` host reads per solve), and the tCG
loop keeps its scalars on the device: one scalar set per instance, every
branch of the reference a select.  On a manifold sharded over ranks
(``M.reduce``: the model-sharded MaxCut of parallel/mesh.py) every sum
of the tCG covers all ranks, and K11 runs in its peer mode (``M.peer``:
the sums on the device) or its split mode; cost, inner and norm come
all-reduced from the problem and the manifold, so every rank takes the
same host branches.  Each tCG iteration is the Hessian
product and one launch of kernel K11 (``kernels.tcg_step``: the dots, the
step and the next direction); on a manifold whose tangent map is K2's
column projection (``tangent_cols``: the oblique and masked-product
manifolds) K11 also re-projects the direction, elsewhere ``M.tangent``
follows it.  The stop flags are read on the host once per ``_TCG_CHUNK``
iterations (and, in peer mode, once more after the loop): a peer-mode
time-out (stop code ``kernels.TCG_TIMEOUT_STOP``) raises there.  An
iteration that starts after a stop is a
masked no-op, so the result equals the iteration-by-iteration semantics
of the reference.  Inside a recorded solver call (utils/timers.py) the
host's waits on these reads of device values are the span ``rtr.wait``.

``make_batched_trustregions`` runs B instances of one problem at once
(the batched MaxCut driver; the JAX package's jax.vmap of the solve): the
factor is (B, p, n), every scalar of both loops is a (B,) tensor, and an
instance that has stopped, in either loop, is a masked no-op, so each
instance follows its own single-instance trajectory.

Semantics (Manopt trustregions.m / tCG.m, as in the JAX package):
  - Delta_bar = typicaldist, Delta0 = Delta_bar/8
  - tCG stop codes 1-6: negative curvature / TR boundary (exact tau) /
    kappa target / theta target / maxinner / model increase
  - per-iteration re-projection of the search direction
  - rho regularization max(1,|fx|)*eps*1e3
  - accept iff model decreased and rho > rho_prime
  - Delta/4 on rho<1/4 or model increase; min(2*Delta, Delta_bar) on
    rho>3/4 with boundary/neg-curvature stop
  - stop on gradnorm < tolgradnorm or k >= maxiter
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..kernels import TCG_TIMEOUT_STOP, tcg_step
from ..utils.timers import span
from .problem import Problem, TROptions, TRResult

_TCG_CHUNK = 8
# stop code of an instance whose outer loop has stopped: its tCG is a no-op
_IDLE = 7


def cast_floats(obj, dtype):
    """Cast every floating tensor in ``obj`` (a tensor, a tuple / list /
    dict of them, or an object with ``astype`` such as SymCOO) to
    ``dtype``.  Python numbers pass through."""
    if obj is None:
        return None
    if isinstance(obj, torch.Tensor):
        return obj.to(dtype) if obj.is_floating_point() else obj
    if isinstance(obj, (tuple, list)):
        return type(obj)(cast_floats(o, dtype) for o in obj)
    if isinstance(obj, dict):
        return {k: cast_floats(v, dtype) for k, v in obj.items()}
    if hasattr(obj, "astype"):
        return obj.astype(dtype)
    return obj


def _check_stops(codes, peer) -> bool:
    """True if every instance has stopped (``codes``: the stop codes read
    on the host); raises on K11's peer-mode time-out."""
    if TCG_TIMEOUT_STOP in codes:
        raise RuntimeError(
            peer.timeout_message() if peer is not None else
            f"K11 stop code {TCG_TIMEOUT_STOP}: a peer-mode time-out")
    return all(c != 0 for c in codes)


def _make_tcg(problem: Problem, opts: TROptions, batched: bool = False):
    M = problem.manifold
    tcg_dt = getattr(torch, opts.tcg_dtype) if opts.tcg_dtype else None
    tangent_cols = getattr(M, "tangent_cols", None)
    # a manifold whose points are sharded over ranks sums every inner
    # product over them (parallel/mesh.ShardedOblique): ||r||^2 here, and
    # K11's partials in its split mode, or on the device in its peer mode
    reduce = getattr(M, "reduce", None)
    peer = getattr(M, "peer", None)

    def tcg(Y, grad, Delta, params, aux, gaux, active=None):
        """Returns (eta, Heta, inner iterations, stop code), the last two
        as (B,) int32 device tensors (B = 1 unless ``batched``; a stopped
        instance's stop code is 5 for maxinner).  ``active`` (B,) bool:
        instances to run; the others return eta = 0 after 0 iterations."""
        out_dt = Y.dtype
        low = tcg_dt is not None and tcg_dt != out_dt
        if low:
            # the whole CG loop (and every Hessian-vector product) runs in
            # tcg_dtype; ``params`` arrive already cast by the caller
            Y, grad, aux, gaux = (cast_floats(t, tcg_dt)
                                  for t in (Y, grad, aux, gaux))
            Delta = Delta.to(tcg_dt)
        # K11 takes (B, ...) vectors: a single instance is a view with B = 1
        def bat(t):
            return t if batched else t.unsqueeze(0)

        def unb(t):
            return t if batched else t[0]

        # K11 writes into eta, Heta, r and mdelta on the card: own them
        eta = bat(M.zerovec(Y))
        Heta = bat(M.zerovec(Y))
        r = bat(grad.clone())
        mdelta = r.clone()
        r_r = torch.sum(r * r, dim=tuple(range(1, r.dim())))
        if reduce is not None:
            r_r = reduce(r_r)
        norm_r0 = torch.sqrt(r_r)
        # no preconditioner: z = r
        kappa_bound = norm_r0 * torch.clamp(norm_r0 ** opts.theta,
                                            max=opts.kappa)
        if tcg_dt is not None:
            # the reduced precision cannot reach relative residuals below
            # its floor; clamp the target instead of stalling
            kappa_bound = torch.maximum(kappa_bound,
                                        norm_r0 * opts.tcg_resid_floor)
        # stop-code 3 vs 4
        linear = (opts.kappa < norm_r0 ** opts.theta).to(r_r.dtype)
        zero = torch.zeros_like(r_r)
        DD = (Delta * Delta).expand(r_r.shape)
        sc = torch.stack([zero, zero, r_r, r_r, zero, DD, kappa_bound,
                          linear], dim=1)
        st = torch.zeros((r_r.shape[0], 2), dtype=torch.int32,
                         device=r_r.device)
        if active is not None:
            st[:, 1] = torch.where(active, 0, _IDLE)
        # K11 projects r + beta mdelta back onto the tangent space itself
        # where the tangent map is K2's column projection
        Yb = mask = None
        if tangent_cols is not None:
            Yb, mask = bat(Y), tangent_cols(Y)

        for it in range(opts.maxinner):
            if it and it % _TCG_CHUNK == 0:
                with span("rtr.wait"):
                    codes = st[:, 1].tolist()
                if _check_stops(codes, peer):
                    break
            Hm = bat(problem.hess(Y, unb(mdelta), params, aux, gaux))
            eta, Heta, r, mdelta, sc, st = tcg_step(
                mdelta, Hm, eta, Heta, r, sc, st, opts.mininner, Yb, mask,
                reduce=None if peer is not None else reduce, peer=peer)
            if Yb is None:
                mdelta = bat(M.tangent(Y, unb(mdelta)))
        if peer is not None:
            with span("rtr.wait"):
                codes = st[:, 1].tolist()
            _check_stops(codes, peer)

        stop = torch.where(st[:, 1] == 0, 5, st[:, 1])
        eta, Heta = unb(eta), unb(Heta)
        if low:
            eta = eta.to(out_dt)
            Heta = Heta.to(out_dt)
        return eta, Heta, st[:, 0], stop

    return tcg


def make_trustregions(problem: Problem, opts: TROptions):
    """Build the RTR solve: (Y0, params, typicaldist[, params_tcg]) ->
    TRResult.

    ``params_tcg``: ``params`` already cast to ``opts.tcg_dtype`` (the
    caller builds it once per outer solve); cast here when omitted.
    """
    M = problem.manifold
    tcg = _make_tcg(problem, opts)
    tcg_dt = getattr(torch, opts.tcg_dtype) if opts.tcg_dtype else None

    def solve(Y0, params, typicaldist, params_tcg=None):
        dt, dev = Y0.dtype, Y0.device
        if tcg_dt is None or tcg_dt == dt:
            params_tcg = params
        elif params_tcg is None:
            params_tcg = cast_floats(params, tcg_dt)
        Delta_bar = torch.tensor(typicaldist, dtype=dt, device=dev)
        Delta = Delta_bar / 8.0
        eps = torch.finfo(dt).eps

        Y = Y0
        fx, aux = problem.cost(Y, params)
        g, gaux = problem.grad(Y, params, aux)
        norm_grad = M.norm(Y, g)
        k = total_inner = 0

        while k < opts.maxiter:
            with span("rtr.wait"):
                going = float(norm_grad) >= opts.tolgradnorm
            if not going:
                break
            eta, Heta, numit, stop = tcg(Y, g, Delta, params_tcg, aux,
                                         gaux)
            pair = torch.stack([numit, stop], 1)
            with span("rtr.wait"):
                (numit, stop_inner), = pair.tolist()

            Y_prop = M.retr(Y, eta)
            f_prop, aux_prop = problem.cost(Y_prop, params)

            rho_reg = torch.clamp(torch.abs(fx), min=1.0) * eps * \
                opts.rho_regularization
            rhonum = fx - f_prop + rho_reg
            vecrho = g + 0.5 * Heta
            rhoden = -M.inner(Y, eta, vecrho) + rho_reg
            model_decreased = rhoden >= 0.0
            rho = rhonum / rhoden

            shrink = (rho < 0.25) | (~model_decreased) | torch.isnan(rho)
            grow = (rho > 0.75) & (stop_inner in (1, 2))
            Delta = torch.where(
                shrink, Delta / 4.0,
                torch.where(grow, torch.minimum(2.0 * Delta, Delta_bar),
                            Delta))

            accept = model_decreased & (rho > opts.rho_prime)
            with span("rtr.wait"):
                accept = bool(accept)
            if accept:
                Y, fx, aux = Y_prop, f_prop, aux_prop
                g = gaux = None
                g, gaux = problem.grad(Y, params, aux)
                norm_grad = M.norm(Y, g)
            # free this step's trial buffers before the next step makes its
            # own: otherwise a rejected step's residuals and an old gradient
            # stay live beside their successors, and the solve's peak memory
            # depends on which steps were rejected, at whatever factor size
            eta = Heta = vecrho = Y_prop = aux_prop = None
            k += 1
            total_inner += numit

        return TRResult(Y=Y, fx=fx, norm_grad=norm_grad, iters=k,
                        inner_iters=total_inner)

    return solve


class BatchedTRResult(NamedTuple):
    Y: Any              # (B, p, n)
    fx: Any             # (B,) tensor
    norm_grad: Any      # (B,) tensor
    iters: np.ndarray   # (B,) TR iterations of each instance
    inner_iters: np.ndarray  # (B,) tCG iterations of each instance


def _select(mask, new, old):
    """Per-instance select over a tensor or a tuple of tensors whose
    leading axis is the instance."""
    if isinstance(new, tuple):
        return tuple(_select(mask, a, b) for a, b in zip(new, old))
    return torch.where(mask.view((-1,) + (1,) * (new.dim() - 1)), new, old)


def make_batched_trustregions(problem: Problem, opts: TROptions):
    """Build the batched RTR solve: (Y0 (B, p, n), params, typicaldist) ->
    BatchedTRResult.  ``problem`` maps a (B, p, n) stack to (B,) costs and
    its manifold's ``inner`` / ``norm`` return (B,) values.

    Both loops hold (B,) scalars on the device.  An instance leaves the
    outer loop when its gradient norm falls below ``tolgradnorm`` or after
    ``maxiter`` iterations, and from then on every iteration leaves it as
    it is; the host reads "any instance still active" once per outer
    iteration.  ``opts.tcg_dtype`` must be None (the JAX package's batch
    runs its tCG in the ambient dtype)."""
    if opts.tcg_dtype is not None:
        raise ValueError("the batched RTR runs its tCG in the ambient dtype")
    M = problem.manifold
    tcg = _make_tcg(problem, opts, batched=True)

    def solve(Y0, params, typicaldist):
        dt, dev = Y0.dtype, Y0.device
        B = Y0.shape[0]
        Delta_bar = torch.tensor(typicaldist, dtype=dt, device=dev)
        Delta = torch.full((B,), float(typicaldist), dtype=dt,
                           device=dev) / 8.0
        eps = torch.finfo(dt).eps

        Y = Y0
        fx, aux = problem.cost(Y, params)
        g, gaux = problem.grad(Y, params, aux)
        norm_grad = M.norm(Y, g)
        k = torch.zeros((B,), dtype=torch.int32, device=dev)
        total_inner = torch.zeros((B,), dtype=torch.int32, device=dev)

        for _ in range(opts.maxiter):
            active = (k < opts.maxiter) & (norm_grad >= opts.tolgradnorm)
            going = torch.any(active)
            with span("rtr.wait"):
                going = bool(going)
            if not going:
                break
            eta, Heta, numit, stop_inner = tcg(Y, g, Delta, params, aux,
                                               gaux, active)

            Y_prop = M.retr(Y, eta)
            f_prop, aux_prop = problem.cost(Y_prop, params)

            rho_reg = torch.clamp(torch.abs(fx), min=1.0) * eps * \
                opts.rho_regularization
            rhonum = fx - f_prop + rho_reg
            vecrho = g + 0.5 * Heta
            rhoden = -M.inner(Y, eta, vecrho) + rho_reg
            model_decreased = rhoden >= 0.0
            rho = rhonum / rhoden

            shrink = (rho < 0.25) | (~model_decreased) | torch.isnan(rho)
            grow = (rho > 0.75) & ((stop_inner == 1) | (stop_inner == 2))
            Delta_n = torch.where(
                shrink, Delta / 4.0,
                torch.where(grow, torch.minimum(2.0 * Delta, Delta_bar),
                            Delta))
            Delta = torch.where(active, Delta_n, Delta)

            accept = active & model_decreased & (rho > opts.rho_prime)
            g_prop, gaux_prop = problem.grad(Y_prop, params, aux_prop)
            Y = _select(accept, Y_prop, Y)
            fx = torch.where(accept, f_prop, fx)
            aux = _select(accept, aux_prop, aux)
            g = _select(accept, g_prop, g)
            gaux = _select(accept, gaux_prop, gaux)
            norm_grad = torch.where(accept, M.norm(Y_prop, g_prop),
                                    norm_grad)
            k = k + active.to(k.dtype)
            total_inner = total_inner + numit

        with span("rtr.wait"):
            iters, inner = k.cpu().numpy(), total_inner.cpu().numpy()
        return BatchedTRResult(Y=Y, fx=fx, norm_grad=norm_grad,
                               iters=iters, inner_iters=inner)

    return solve
