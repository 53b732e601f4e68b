"""The f64 parity engine: presolve and ADMM with the reference's
semantics (port of `fcc_qp_tpu/core/solver.py`).

Reference control flow, per instance: the duals reset to zero unless the
solve is warm-started; the presolve (the equality-constrained QP solved
exactly) gives the initial primal unless the solve is warm-started; a
problem without cones and with every bound infinite is solved by the
presolve alone (``n_iter = 0``); otherwise the ADMM loop runs until the
residuals fall below the tolerances or ``max_iter`` iterations are spent.

The factorization builds the explicit KKT inverse blocks
(`ops.kkt.admm_operator`); the loop is one launch of the CUDA kernel
`ops.pallas_admm.admm_chunk_full_f64` (the full layout, unit weights,
the increment gate over all rows with operator presolve) for
``max_iter`` iterations: each instance's warp stops where it converges
or runs out of iterations, and frozen instances copy through, so a
batch gives each instance the result of its own serial solve. The JAX
package runs the same loop as a vmapped `lax.while_loop` over chunks;
one launch equals that chunked loop bit for bit and is faster on the
card (`exp_single_launch.py`).

With ``static=True`` (`_solve_core`; the form `core.graphs` captures as
CUDA graphs, `parity_stages`) the solve also reads nothing back outside
the loop: the factorization's shift levels and refinement and the
equality-only presolve are branches on their device flags
(`ops.device_branch.branch`: IF nodes under a capture, computed and
selected otherwise). On the card `solve_batched` and `replay` run
captured at any batch size (`core.graphs.solve_captured`,
`replay_captured`), as `FCCQP` does at B = 1.

Data is batch-LEADING `types.QPBatch` (`solve` takes one instance,
`solve_batched` a batch); the loop's state is batch-last, as the kernel
reads it. The engine computes in the data's dtype, as the JAX package's
does: f64 data runs `admm_chunk_full_f64`, f32 data (the JAX bench's
``--engine f32``) the f32 instantiation `admm_chunk_full_f32`, with the
operator, the presolve and the residuals in f32. Any other dtype is
taken as f64.

Like the JAX package's, this engine is the reference algorithm: it
ignores the acceleration options (``alpha``, adaptive rho, scaling,
splitting, polish). `core.batched.solve_batched_fast` is the batch-level
engine that takes over-relaxation and adaptive rho.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from fcc_qp_tpu_torch.config import FCCQPOptions, ProblemShape
from fcc_qp_tpu_torch.core.ds_engine import Stages, resolve_device, zero_batch
from fcc_qp_tpu_torch.ops.device_branch import branch
from fcc_qp_tpu_torch.ops.kkt import admm_operator, kkt_solve
from fcc_qp_tpu_torch.ops.pallas_admm import (
    GATE_ALL,
    GATE_OFF,
    admm_chunk_full_f32,
    admm_chunk_full_f64,
)
from fcc_qp_tpu_torch.ops.projections import (
    calc_bound_violation,
    calc_friction_cone_violation,
)
from fcc_qp_tpu_torch.types import (
    FCCQPDetails,
    FCCQPSolution,
    FCCQPSolveStatus,
    QPBatch,
    WarmStart,
)
from fcc_qp_tpu_torch.utils.timing import stamp_solution_times, sync


def compute_dtype(qp: QPBatch) -> torch.dtype:
    """The dtype a solve of ``qp`` computes in: f32 for f32 data, f64
    otherwise."""
    return torch.float32 if qp.Q.dtype == torch.float32 else torch.float64


def full_chunk(dtype):
    """The full-layout chunk kernel's wrapper for ``dtype``."""
    return admm_chunk_full_f32 if dtype == torch.float32 else admm_chunk_full_f64


def _presolve(qp: QPBatch, static: bool = False) -> torch.Tensor:
    """The equality-constrained QP's solution, (B, n): ``[[Q, A'],[A, 0]]
    s = [-b; b_eq]``."""
    return kkt_solve(qp.Q, qp.A_eq, 0.0, -qp.b, qp.b_eq, static=static)


def _admm(qp: QPBatch, x0, mu_x0, mu_lam0, skip, shape: ProblemShape,
          opts: FCCQPOptions, operator):
    """The ADMM loop over a batch (B-leading in, B-leading out): one
    launch of the full-layout kernel for ``max_iter`` iterations, in the
    dtype of ``x0``. ``skip`` (B,) marks instances that do not iterate.
    Returns ``(x, mu_x, mu_lam, n_iter, xrn, lrn)``."""
    nc, ls = shape.nc, shape.lambda_c_start
    F, x_const = operator
    B = x0.shape[0]
    dev = x0.device
    dt = x0.dtype
    last = lambda a: a.T.contiguous()
    zb = torch.zeros((B,), dtype=dt, device=dev)
    x = last(x0)
    mu_x, mu_lam = last(mu_x0), last(mu_lam0)
    st = dict(
        x=x, x_bar=x, lam_bar=x[ls:ls + nc].contiguous(), mu_x=mu_x,
        mu_lam=mu_lam, v=x - mu_x, done=skip.clone(),
        n_iter=torch.full((B,), opts.max_iter, dtype=torch.int32,
                          device=dev),
        itv=torch.zeros((B,), dtype=torch.int32, device=dev),
        xrn=zb, lrn=zb, prim=zb, dual=zb,
    )
    Fj = F.permute(2, 1, 0).contiguous()          # [j, i, b] = F[b, i, j]
    const = (Fj, last(x_const), last(qp.lb), last(qp.ub),
             last(qp.friction_coeffs),
             torch.full((B,), float(opts.rho), dtype=dt, device=dev),
             opts.eps_bound, opts.eps_fcone)
    chunk = full_chunk(dt)
    gate = GATE_ALL if opts.presolve == "operator" else GATE_OFF
    keys = ("x", "x_bar", "lam_bar", "mu_x", "mu_lam", "v", "done",
            "n_iter", "itv", "xrn", "lrn", "prim", "dual")
    st = dict(zip(keys, chunk(*const, *(st[k] for k in keys), ls=ls,
                              K=opts.max_iter, max_iter=opts.max_iter,
                              gate=gate)))
    return (st["x"].T, st["mu_x"].T, st["mu_lam"].T, st["n_iter"],
            st["xrn"], st["lrn"])


def _details(x, qp: QPBatch, shape: ProblemShape, n_iter, xrn, lrn,
             max_iter: int) -> FCCQPDetails:
    nc, ls = shape.nc, shape.lambda_c_start
    if qp.A_eq.shape[-2]:
        eq_viol = ((qp.A_eq @ x[..., None])[..., 0] - qp.b_eq).abs().amax(-1)
    else:
        eq_viol = torch.zeros_like(xrn)
    status = torch.where(
        n_iter == max_iter, int(FCCQPSolveStatus.kMaxIterations),
        int(FCCQPSolveStatus.kSuccess),
    ).to(torch.int32)
    zeros_i = torch.zeros_like(n_iter)
    zb = torch.zeros_like(xrn)
    return FCCQPDetails(
        n_iter=n_iter, admm_residual_bounds=xrn,
        admm_residual_friction_cone=lrn, solve_time=zb,
        factorization_time=zb,
        bounds_viol=calc_bound_violation(x, qp.lb, qp.ub),
        friction_cone_viol=calc_friction_cone_violation(
            x[..., ls:ls + nc], qp.friction_coeffs),
        solve_status=status, equality_viol=eq_viol, n_iter_f32=zeros_i,
        n_iter_ds=zeros_i, polish_attempts=zeros_i, polish_accepted=zeros_i,
    )


def _solve_core(qp: QPBatch, shape: ProblemShape, opts: FCCQPOptions,
                warm: Optional[WarmStart], warm_start: bool, operator=None,
                static: bool = False):
    """A solve of the batch ``qp`` (B-leading, f64 or f32, on its
    device). ``static``: read-free (see the module docstring), the
    eager results bit for bit."""
    B = qp.b.shape[0]
    dev = qp.b.device
    nc = shape.nc
    if warm is None:
        warm = WarmStart.zeros(shape, (B,), dtype=qp.Q.dtype, device=dev)
    if warm_start:
        mu_x0, mu_lam0 = warm.mu_x, warm.mu_lambda_c
    else:
        mu_x0 = torch.zeros_like(warm.mu_x)
        mu_lam0 = torch.zeros_like(warm.mu_lambda_c)
    # the equality-constrained fast path needs nc == 0 and every bound
    # infinite (then the presolve is the solution)
    if nc == 0:
        eq_c = (torch.isinf(qp.lb).all(dim=-1)
                & torch.isinf(qp.ub).all(dim=-1))
    else:
        eq_c = torch.zeros((B,), dtype=torch.bool, device=dev)
    if warm_start:
        x_init = warm.x
        if nc == 0:
            (x_init,) = branch(
                eq_c.any() if static else bool(eq_c.any()),
                lambda x: (torch.where(eq_c[:, None], _presolve(qp, static),
                                       x),), x_init)
    else:
        x_init = _presolve(qp, static)
    if operator is None:
        operator = admm_operator(qp.Q, qp.b, qp.A_eq, qp.b_eq, opts.rho,
                                 static=static)
    x, mu_x, mu_lam, n_iter, xrn, lrn = _admm(
        qp, x_init, mu_x0, mu_lam0, eq_c, shape, opts, operator)
    # skipped instances: the presolve, their incoming duals, no iteration
    n_iter = torch.where(eq_c, 0, n_iter).to(torch.int32)
    details = _details(x, qp, shape, n_iter, xrn, lrn, opts.max_iter)
    return (FCCQPSolution(details=details, z=x),
            WarmStart(x=x, mu_x=mu_x, mu_lambda_c=mu_lam))


def parity_stages(shape: ProblemShape, opts: FCCQPOptions,
                  dtype=torch.float64) -> Stages:
    """The parity engine's static stage pair on ``dtype`` data (the form
    `core.graphs.CapturedBatch` captures): the operator, then the rest of
    `_solve_core`."""
    return Stages(
        ("parity", shape, opts, dtype),
        lambda B, dev: zero_batch(shape, B, dev, dtype, batch_last=False),
        lambda qp, warm, cache, warm_start: admm_operator(
            qp.Q, qp.b, qp.A_eq, qp.b_eq, opts.rho, static=True),
        lambda qp, prep, warm, cache, warm_start: _solve_core(
            qp, shape, opts, warm, warm_start, prep, static=True))


def solve(qp: QPBatch, shape: ProblemShape,
          opts: FCCQPOptions = FCCQPOptions(),
          warm: Optional[WarmStart] = None, warm_start: bool = False,
          device=None, rho=None, operator=None):
    """Solve ONE QP instance (unbatched fields). Control flow of the
    reference's Solve: duals reset unless ``warm_start``; the presolve
    runs unless ``warm_start`` (or for an equality-constrained problem);
    ADMM runs unless the problem is purely equality-constrained.

    ``rho``: the penalty (a float or a 0-d tensor) in place of
    ``opts.rho``. ``operator``: a prebuilt ``(F, x_const)`` ADMM operator
    for that rho (`ops.kkt.admm_operator` of the instance, unbatched or
    with a batch of one), which the solve then does not build; it must
    match ``rho``, and the solve equals one at ``opts.replace(rho=rho)``
    without it.

    Runs on ``device`` (default CUDA; raises when there is no card), in
    the data's dtype (f32 or f64), uncaptured: the ADMM loop is one
    launch of the full-layout kernel, as in the captured batched solve.
    Returns ``(FCCQPSolution, WarmStart)`` of the single instance."""
    dev = resolve_device(device)
    dt = compute_dtype(qp)
    qp1 = QPBatch(*(a[None] for a in qp.to(dev, dt).__dict__.values()))
    w1 = None
    if warm is not None:
        w = warm.to(dev, dt)
        w1 = WarmStart(w.x[None], w.mu_x[None], w.mu_lambda_c[None])
    if rho is not None:
        opts = opts.replace(rho=float(rho))
    if operator is not None:
        F, x_const = (a.to(dev, dt) for a in operator)
        operator = (F, x_const) if F.dim() == 3 else (F[None], x_const[None])
    sol, ws = _solve_core(qp1, shape, opts, w1, warm_start, operator)
    det = FCCQPDetails(**{k: v[0] for k, v in sol.details.__dict__.items()})
    return (FCCQPSolution(details=det, z=sol.z[0]),
            WarmStart(x=ws.x[0], mu_x=ws.mu_x[0],
                      mu_lambda_c=ws.mu_lambda_c[0]))


def solve_batched(qp: QPBatch, shape: ProblemShape,
                  opts: FCCQPOptions = FCCQPOptions(),
                  warm: Optional[WarmStart] = None, warm_start: bool = False,
                  device=None, graphs: Optional[bool] = None,
                  timing: bool = True):
    """Solve a batch of independent QPs (leading batch axis B): the
    replacement for looping the reference's Solve. Each instance gets the
    result of its own serial solve.

    Runs on ``device`` (default CUDA; raises when there is no card), in
    the data's dtype (f32 or f64). On the card the solve runs captured
    (`parity_stages`, `core.graphs.solve_captured`: the first call of
    each configuration, dtype, batch size and ``warm_start`` captures
    it, every call replays it); ``graphs=False`` runs it uncaptured. The
    operator build and the solve are timed apart: ``details.solve_time``
    is the span of the whole solve and ``details.factorization_time`` the
    operator build's (CUDA events around the replays; uncaptured, wall
    spans each ending in a device synchronize). ``timing=False`` leaves
    both zero and adds no barrier, so captured calls queue back to back
    on the current stream (`core.graphs.solve_captured`). Returns
    ``(FCCQPSolution, WarmStart)``, batch-leading."""
    dev = resolve_device(device)
    dt = compute_dtype(qp)
    qp = qp.to(dev, dt)
    if warm is not None:
        warm = warm.to(dev, dt)
    if graphs and dev.type != "cuda":
        raise ValueError("CUDA graphs need a CUDA device")
    if dev.type == "cuda" and graphs is not False:
        from fcc_qp_tpu_torch.core.graphs import solve_captured

        return solve_captured(parity_stages(shape, opts, dt), qp, warm,
                              warm_start, dev, timing)
    if not timing:
        return _solve_core(qp, shape, opts, warm, warm_start)
    sync(dev)
    t0 = time.perf_counter()
    operator = admm_operator(qp.Q, qp.b, qp.A_eq, qp.b_eq, opts.rho)
    sync(dev)
    t1 = time.perf_counter()
    sol, ws = _solve_core(qp, shape, opts, warm, warm_start, operator)
    sync(dev)
    t2 = time.perf_counter()
    return stamp_solution_times(sol, t2 - t0, t1 - t0), ws


def replay(qps: QPBatch, shape: ProblemShape,
           opts: FCCQPOptions = FCCQPOptions(), device=None,
           graphs: Optional[bool] = None):
    """Sequential warm-started replay of a logged QP sequence (leading
    time axis T; a batch axis may follow it): step 0 cold, every later
    step warm-started from the one before, as the reference loop does
    with ``set_warm_start(i > 0)``. Computes in the data's dtype (f32 or
    f64). On the card the replay runs captured (the JAX package's
    ``lax.scan``: `core.graphs.replay_captured` replays the cold graphs
    of `parity_stages` at step 0 and the warm graphs at every later step,
    the warm state in static buffers, no host read between steps);
    ``graphs=False`` runs the steps uncaptured. Returns ``(solutions
    stacked over T, final WarmStart)``."""
    dev = resolve_device(device)
    dt = compute_dtype(qps)
    qps = qps.to(dev, dt)
    single = qps.b.dim() == 2
    if single:
        qps = QPBatch(*(a[:, None] for a in qps.__dict__.values()))
    if graphs and dev.type != "cuda":
        raise ValueError("CUDA graphs need a CUDA device")
    if dev.type == "cuda" and graphs is not False:
        from fcc_qp_tpu_torch.core.graphs import replay_captured

        sols, ws, _, _ = replay_captured(parity_stages(shape, opts, dt),
                                         qps, dev)
    else:
        fields = list(qps.__dict__.values())
        sols, ws = [], None
        for t in range(qps.b.shape[0]):
            sol, ws = _solve_core(QPBatch(*(a[t] for a in fields)), shape,
                                  opts, ws, t > 0)
            sols.append(sol)
    pick = (lambda a: a[0]) if single else (lambda a: a)
    det = FCCQPDetails(**{
        k: torch.stack([pick(getattr(s.details, k)) for s in sols])
        for k in sols[0].details.__dict__
    })
    z = torch.stack([pick(s.z) for s in sols])
    final = WarmStart(*(pick(a) for a in (ws.x, ws.mu_x, ws.mu_lambda_c)))
    return FCCQPSolution(details=det, z=z), final
