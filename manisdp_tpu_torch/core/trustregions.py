"""Riemannian trust-region solver with truncated CG (PyTorch port of
manisdp_tpu/core/trustregions.py).

The JAX package runs both loops as ``lax.while_loop``s in one compiled
program.  Here the outer TR loop is a Python loop with a host branch for
accept / reject (at most ``maxiter`` host reads per solve), and the tCG
loop keeps its scalars as 0-d device tensors: every branch of the
reference is a ``torch.where``, and the stop flag is read on the host
once per ``_TCG_CHUNK`` iterations.  An iteration that starts after a
stop is a masked no-op, so the result equals the iteration-by-iteration
semantics of the reference.

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

import torch

from .problem import Problem, TROptions, TRResult

_TCG_CHUNK = 8


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


def _make_tcg(problem: Problem, opts: TROptions):
    M = problem.manifold
    inner = M.inner
    tcg_dt = getattr(torch, opts.tcg_dtype) if opts.tcg_dtype else None

    def tcg(Y, grad, Delta, params, aux, gaux):
        """Returns (eta, Heta, inner iterations, stop code); the last two
        as Python ints."""
        out_dt = Y.dtype
        low = tcg_dt is not None and tcg_dt != out_dt
        if low:
            # the whole CG loop (and every Hessian-vector product) runs in
            # tcg_dtype; ``params`` arrive already cast by the caller
            Y, grad, aux, gaux = (cast_floats(t, tcg_dt)
                                  for t in (Y, grad, aux, gaux))
            Delta = Delta.to(tcg_dt)
        eta = M.zerovec(Y)
        Heta = M.zerovec(Y)
        r = grad
        r_r = inner(Y, r, r)
        norm_r0 = torch.sqrt(r_r)
        # no preconditioner: z = r
        kappa_bound = norm_r0 * torch.clamp(norm_r0 ** opts.theta,
                                            max=opts.kappa)
        if tcg_dt is not None:
            # the reduced precision cannot reach relative residuals below
            # its floor; clamp the target instead of stalling
            kappa_bound = torch.maximum(kappa_bound,
                                        norm_r0 * opts.tcg_resid_floor)
        linear = opts.kappa < norm_r0 ** opts.theta    # stop-code 3 vs 4

        zero = torch.zeros((), dtype=r_r.dtype, device=r_r.device)
        mdelta = r
        e_Pe, e_Pd, d_Pd, z_r, model_value = zero, zero, r_r, r_r, zero
        j = torch.zeros((), dtype=torch.int32, device=r_r.device)
        stop = torch.zeros((), dtype=torch.int32, device=r_r.device)
        code = lambda c: torch.tensor(c, dtype=torch.int32,  # noqa: E731
                                      device=r_r.device)
        c0, c1, c2, c3, c4, c6 = (code(c) for c in (0, 1, 2, 3, 4, 6))
        DD = Delta * Delta

        for it in range(opts.maxinner):
            if it % _TCG_CHUNK == 0 and it and int(stop) != 0:
                break
            act = stop == 0
            Hm = problem.hess(Y, mdelta, params, aux, gaux)
            d_Hd = inner(Y, mdelta, Hm)
            d_r = inner(Y, mdelta, r)
            alpha = z_r / d_Hd
            e_Pe_new = e_Pe + 2.0 * alpha * e_Pd + alpha * alpha * d_Pd

            boundary = (d_Hd <= 0.0) | (e_Pe_new >= DD)
            # exact boundary solve (tCG.m:188)
            tau = (-e_Pd + torch.sqrt(e_Pd * e_Pd + d_Pd * (DD - e_Pe))) \
                / d_Pd
            step = torch.where(boundary, tau, alpha)

            new_eta = eta - step * mdelta
            new_Heta = Heta - step * Hm
            # incremental model value m(eta - t d) = m(eta) - t<d, r>
            # + t^2/2 <d, Hd>
            new_mv = model_value - step * d_r + 0.5 * step * step * d_Hd
            model_inc = (~boundary) & (new_mv >= model_value)

            stop_n = torch.where(
                boundary, torch.where(d_Hd <= 0.0, c1, c2),
                torch.where(model_inc, c6, c0))
            # on model increase (stop 6) keep the PREVIOUS iterate
            keep = model_inc | ~act
            eta = torch.where(keep, eta, new_eta)
            Heta = torch.where(keep, Heta, new_Heta)
            model_value = torch.where(keep, model_value, new_mv)

            r_n = r - alpha * Hm
            r_r_n = inner(Y, r_n, r_n)
            norm_r = torch.sqrt(r_r_n)
            hit_kappa = (stop_n == 0) & (j + 1 >= opts.mininner) & \
                (norm_r <= kappa_bound)
            stop_n = torch.where(hit_kappa, torch.where(linear, c3, c4),
                                 stop_n)

            beta = r_r_n / z_r
            mdelta_n = M.tangent(Y, r_n + beta * mdelta)
            e_Pd_n = beta * (e_Pd + alpha * d_Pd)
            d_Pd_n = r_r_n + beta * beta * d_Pd

            r = torch.where(act, r_n, r)
            mdelta = torch.where(act, mdelta_n, mdelta)
            e_Pe = torch.where(act & ~boundary, e_Pe_new, e_Pe)
            e_Pd = torch.where(act, e_Pd_n, e_Pd)
            d_Pd = torch.where(act, d_Pd_n, d_Pd)
            z_r = torch.where(act, r_r_n, z_r)
            j = j + act.to(j.dtype)
            stop = torch.where(act, stop_n, stop)

        stop_i = int(stop)
        if low:
            eta = eta.to(out_dt)
            Heta = Heta.to(out_dt)
        return eta, Heta, int(j), (5 if stop_i == 0 else stop_i)

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

        while k < opts.maxiter and float(norm_grad) >= opts.tolgradnorm:
            eta, Heta, numit, stop_inner = tcg(Y, g, Delta, params_tcg,
                                               aux, gaux)

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

            if bool(model_decreased & (rho > opts.rho_prime)):
                g, gaux = problem.grad(Y_prop, params, aux_prop)
                Y, fx, aux = Y_prop, f_prop, aux_prop
                norm_grad = M.norm(Y, g)
            k += 1
            total_inner += numit

        return TRResult(Y=Y, fx=fx, norm_grad=norm_grad, iters=k,
                        inner_iters=total_inner)

    return solve
