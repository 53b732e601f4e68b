"""The batch-level ADMM engine with over-relaxation and adaptive rho
(port of `fcc_qp_tpu/core/batched.py`).

The f64 parity engine (`core.solver`) is the reference algorithm per
instance. Two accelerations need batch-level control: adaptive rho, which
refactors the KKT operator when rho changes (only when some instance's
rho changed, so the rebuild is skipped once rho has settled), and
over-relaxation. This engine runs the reference iteration over all n
variables in chunks of the full-layout kernel
(`ops.pallas_admm.admm_chunk_full_f64`, or `admm_chunk_full_f32` on f32
data) with ``alpha`` inside the kernel, and the adaptation between
chunks:

* chunks of ``adaptive_rho_interval`` iterations when adapting (else of
  up to 64), the convergence test between chunks (one host read each);
* at a due check (``it >= next_adapt``, ``next_adapt`` doubling at every
  check, so the rebuilds are O(log(max_iter / K))) and while fewer than
  ``adaptive_rho_max_adaptations`` rebuilds ran: ``rho <- clip(rho *
  sqrt(prim / dual))`` where an unfinished instance's L2 residuals are out
  of balance by more than the tolerance, in the data's dtype;
* the scaled duals take ``rho_old / rho_new``, so the unscaled duals
  ``y = rho mu`` stay continuous;
* the operator of the whole batch is rebuilt when any rho changed (an
  instance whose rho did not change gets the identical operator back).

With ``alpha = 1`` and ``adaptive_rho=False`` the iteration is the parity
engine's, and so are the results. The primal-increment gate of the
operator presolve runs over all rows (`ops.pallas_admm.GATE_ALL`), as in
the parity engine. The L2 norms the adaptation reads are the kernel's
``prim = ||x - s_now||`` and ``dual = rho ||s_now - s_prev||``, those of
the JAX engine.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from fcc_qp_tpu_torch.config import FCCQPOptions, ProblemShape
from fcc_qp_tpu_torch.core.ds_engine import _rho_step, resolve_device
from fcc_qp_tpu_torch.core.solver import (
    _details,
    _presolve,
    compute_dtype,
    full_chunk,
)
from fcc_qp_tpu_torch.ops.kkt import admm_operator
from fcc_qp_tpu_torch.ops.pallas_admm import GATE_ALL, GATE_OFF
from fcc_qp_tpu_torch.types import FCCQPSolution, QPBatch, WarmStart
from fcc_qp_tpu_torch.utils.timing import (
    StageClock,
    stamp_solution_times,
    sync,
)


def _admm_batched(qp: QPBatch, x0, mu_x0, mu_lam0, rho, shape: ProblemShape,
                  opts: FCCQPOptions, operator, clock: StageClock):
    """The chunked loop with adaptation between chunks (B-leading in and
    out). Returns ``(x, mu_x, mu_lam, n_iter, xrn, lrn)``."""
    nc, ls = shape.nc, shape.lambda_c_start
    B = x0.shape[0]
    dev, dt = x0.device, x0.dtype
    max_iter = opts.max_iter
    last = lambda a: a.T.contiguous()
    Fj_of = lambda F: F.permute(2, 1, 0).contiguous()   # [j, i, b]
    K = opts.adaptive_rho_interval if opts.adaptive_rho else min(max_iter, 64)
    n_chunks = -(-max_iter // K)
    F, x_const = operator
    Fj, xc = Fj_of(F), last(x_const)
    lb, ub, mu_f = last(qp.lb), last(qp.ub), last(qp.friction_coeffs)
    zb = torch.zeros((B,), dtype=dt, device=dev)
    x = last(x0)
    st = dict(
        x=x, x_bar=x, lam_bar=x[ls:ls + nc].contiguous(), mu_x=last(mu_x0),
        mu_lam=last(mu_lam0), v=x - last(mu_x0),
        done=torch.zeros((B,), dtype=torch.bool, device=dev),
        n_iter=torch.full((B,), max_iter, dtype=torch.int32, device=dev),
        itv=None, xrn=zb, lrn=zb, prim=zb, dual=zb,
    )
    keys = ("x", "x_bar", "lam_bar", "mu_x", "mu_lam", "v", "done",
            "n_iter", "itv", "xrn", "lrn", "prim", "dual")
    gate = GATE_ALL if opts.presolve == "operator" else GATE_OFF
    chunk = full_chunk(dt)
    it, next_adapt, n_refactor = 0, K, 0
    while it < n_chunks * K and not bool(st["done"].all()):
        # every unfinished instance is at the global iteration count
        st["itv"] = torch.full((B,), it, dtype=torch.int32, device=dev)
        out = chunk(Fj, xc, lb, ub, mu_f, rho, opts.eps_bound,
                    opts.eps_fcone, *(st[k] for k in keys), ls=ls, K=K,
                    max_iter=max_iter, gate=gate, alpha=opts.alpha)
        st = dict(zip(keys, out))
        it += K
        if not (opts.adaptive_rho and it >= next_adapt
                and n_refactor < opts.adaptive_rho_max_adaptations):
            continue
        next_adapt *= 2
        step = _rho_step(st["prim"], st["dual"], st["done"], rho, opts,
                         dtype=dt)
        if step is None:
            continue
        rho, scale = step
        st["mu_x"] = st["mu_x"] * scale[None, :]
        st["mu_lam"] = st["mu_lam"] * scale[None, :]
        F, x_const = admm_operator(qp.Q, qp.b, qp.A_eq, qp.b_eq, rho)
        Fj, xc = Fj_of(F), last(x_const)
        n_refactor += 1
    clock.count("n_refactor", n_refactor)
    return (st["x"].T, st["mu_x"].T, st["mu_lam"].T, st["n_iter"],
            st["xrn"], st["lrn"])


def solve_batched_fast(
    qp: QPBatch,
    shape: ProblemShape,
    opts: FCCQPOptions = FCCQPOptions(),
    warm: Optional[WarmStart] = None,
    warm_start: bool = False,
    device=None,
    stage_times: Optional[dict] = None,
):
    """Accelerated batched solve (leading batch axis): the parity
    engine's control flow (duals reset unless ``warm_start``; the exact
    presolve unless ``warm_start``; an equality-constrained instance, no
    cones and every bound infinite, takes the presolve with n_iter 0)
    with over-relaxation (``opts.alpha``) and adaptive rho
    (``opts.adaptive_rho``).

    Runs on ``device`` (default CUDA; raises when there is no card) in
    the data's dtype (f32 or f64); rho starts at ``opts.rho`` for every
    instance and adapts per instance. ``details.solve_time`` is the wall
    of the call and ``details.factorization_time`` the initial operator
    build, each span ending in a device synchronize. ``stage_times``: a
    dict that receives the synchronized seconds of the stages
    ``operator``, ``iterate`` and ``finalize`` and the count of operator
    rebuilds ``n_refactor``.

    Returns ``(FCCQPSolution, WarmStart)``, batch-leading.
    """
    dev = resolve_device(device)
    dt = compute_dtype(qp)
    qp = qp.to(dev, dt)
    B = qp.b.shape[0]
    nc = shape.nc
    if warm is None:
        warm = WarmStart.zeros(shape, (B,), dtype=dt, device=dev)
    else:
        warm = warm.to(dev, dt)
    rho = torch.full((B,), float(opts.rho), dtype=dt, device=dev)
    clock = StageClock(stage_times, dev)
    sync(dev)
    t0 = time.perf_counter()
    operator = admm_operator(qp.Q, qp.b, qp.A_eq, qp.b_eq, rho)
    clock.mark("operator")
    sync(dev)
    t1 = time.perf_counter()

    if warm_start:
        mu_x0, mu_lam0, x_init = warm.mu_x, warm.mu_lambda_c, warm.x
    else:
        mu_x0 = torch.zeros_like(warm.mu_x)
        mu_lam0 = torch.zeros_like(warm.mu_lambda_c)
        x_init = _presolve(qp)
    # equality-constrained instances iterate with the batch (their
    # residuals take part in the adaptation, as in the JAX engine) and
    # take the presolve afterwards
    if nc == 0:
        eq_c = (torch.isinf(qp.lb).all(dim=-1)
                & torch.isinf(qp.ub).all(dim=-1))
        if warm_start and bool(eq_c.any()):
            x_init = torch.where(eq_c[:, None], _presolve(qp), x_init)
    else:
        eq_c = torch.zeros((B,), dtype=torch.bool, device=dev)

    x, mu_x, mu_lam, n_iter, xrn, lrn = _admm_batched(
        qp, x_init, mu_x0, mu_lam0, rho, shape, opts, operator, clock)
    clock.mark("iterate")
    x = torch.where(eq_c[:, None], x_init, x)
    n_iter = torch.where(eq_c, 0, n_iter).to(torch.int32)
    xrn = torch.where(eq_c, torch.zeros_like(xrn), xrn)
    lrn = torch.where(eq_c, torch.zeros_like(lrn), lrn)
    details = _details(x, qp, shape, n_iter, xrn, lrn, opts.max_iter)
    sol = FCCQPSolution(details=details, z=x)
    new_warm = WarmStart(x=x, mu_x=torch.where(eq_c[:, None], mu_x0, mu_x),
                         mu_lambda_c=mu_lam)
    clock.mark("finalize")
    sync(dev)
    t2 = time.perf_counter()
    return stamp_solution_times(sol, t2 - t0, t1 - t0), new_warm
