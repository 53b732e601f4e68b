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
  up to 64), the convergence test between chunks (eager: one host read
  each; static, the form `core.graphs` captures: a branch on the device
  flag, `core.ds_engine.chunk_loop`);
* at a due check (``it >= next_adapt``, ``next_adapt`` doubling at every
  check, so the rebuilds are O(log(max_iter / K))) and while fewer than
  ``adaptive_rho_max_adaptations`` rebuilds ran: ``rho <- clip(rho *
  sqrt(prim / dual))`` where an unfinished instance's L2 residuals are out
  of balance by more than the tolerance, in the data's dtype;
* the scaled duals take ``rho_old / rho_new``, so the unscaled duals
  ``y = rho mu`` stay continuous;
* the operator of the whole batch is rebuilt when any rho changed (an
  instance whose rho did not change gets the identical operator back;
  static: an IF node, as the JAX engine's ``lax.cond``).

With ``alpha = 1`` and ``adaptive_rho=False`` the iteration is the parity
engine's, and so are the results. The primal-increment gate of the
operator presolve runs over all rows (`ops.pallas_admm.GATE_ALL`), as in
the parity engine. The L2 norms the adaptation reads are the kernel's
``prim = ||x - s_now||`` and ``dual = rho ||s_now - s_prev||``, those of
the JAX engine.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import torch

from fcc_qp_tpu_torch.config import FCCQPOptions, ProblemShape
from fcc_qp_tpu_torch.core.ds_engine import (
    Stages,
    chunk_loop,
    resolve_device,
    zero_batch,
)
from fcc_qp_tpu_torch.core.solver import (
    _details,
    _presolve,
    compute_dtype,
    full_chunk,
)
from fcc_qp_tpu_torch.ops.device_branch import branch
from fcc_qp_tpu_torch.ops.kkt import admm_operator
from fcc_qp_tpu_torch.ops.pallas_admm import GATE_ALL, GATE_OFF
from fcc_qp_tpu_torch.types import FCCQPSolution, QPBatch, WarmStart
from fcc_qp_tpu_torch.utils.timing import (
    StageClock,
    stamp_solution_times,
    sync,
)


def _admm_batched(qp: QPBatch, x0, mu_x0, mu_lam0, rho, shape: ProblemShape,
                  opts: FCCQPOptions, operator, static: bool = False):
    """The chunked loop with adaptation between chunks
    (`core.ds_engine.chunk_loop`; B-leading in and out). ``static``:
    read-free. Returns ``(x, mu_x, mu_lam, n_iter, xrn, lrn,
    n_refactor)``."""
    nc, ls = shape.nc, shape.lambda_c_start
    B = x0.shape[0]
    dev, dt = x0.device, x0.dtype
    max_iter = opts.max_iter
    last = lambda a: a.T.contiguous()
    K = opts.adaptive_rho_interval if opts.adaptive_rho else min(max_iter, 64)
    n_chunks = -(-max_iter // K)
    lb, ub, mu_f = last(qp.lb), last(qp.ub), last(qp.friction_coeffs)
    zb = torch.zeros((B,), dtype=dt, device=dev)
    x = last(x0)
    keys = ("x", "x_bar", "lam_bar", "mu_x", "mu_lam", "v", "done",
            "n_iter", "itv", "xrn", "lrn", "prim", "dual")
    st = (x, x, x[ls:ls + nc].contiguous(), last(mu_x0), last(mu_lam0),
          x - last(mu_x0), torch.zeros((B,), dtype=torch.bool, device=dev),
          torch.full((B,), max_iter, dtype=torch.int32, device=dev),
          torch.zeros((B,), dtype=torch.int32, device=dev), zb, zb, zb, zb)
    gate = GATE_ALL if opts.presolve == "operator" else GATE_OFF
    kernel = full_chunk(dt)

    def operator_of(F, x_const):
        return F.permute(2, 1, 0).contiguous(), last(x_const)  # [j, i, b]

    def chunk(st, rho, op):
        return kernel(*op, lb, ub, mu_f, rho, opts.eps_bound, opts.eps_fcone,
                      *st, ls=ls, K=K, max_iter=max_iter, gate=gate,
                      alpha=opts.alpha)

    def rebuild(rho):
        return operator_of(*admm_operator(qp.Q, qp.b, qp.A_eq, qp.b_eq, rho,
                                          static=static))

    st, _, _, n_refactor = chunk_loop(st, keys, rho, operator_of(*operator),
                                      chunk, rebuild, opts, n_chunks, K,
                                      static)
    st = dict(zip(keys, st))
    return (st["x"].T, st["mu_x"].T, st["mu_lam"].T, st["n_iter"],
            st["xrn"], st["lrn"], n_refactor)


class Given(NamedTuple):
    """A batch with what the caller gives beside it: each instance's rho,
    (B,), and optionally its prebuilt ADMM operator ``(F, x_const)``,
    (B, n, n) / (B, n). The input buffers of `fast_stages`."""

    qp: QPBatch
    rho: torch.Tensor
    operator: Optional[tuple] = None

    @property
    def b(self) -> torch.Tensor:
        """The batch's ``b``, by which a capture reads the batch size."""
        return self.qp.b


def _rho_vector(qp: QPBatch, opts: FCCQPOptions, rho=None) -> torch.Tensor:
    """Each instance's rho, (B,) in the data's dtype: ``rho`` (a float, a
    0-d tensor or one per instance) or ``opts.rho``."""
    B = qp.b.shape[0]
    if rho is None:
        return torch.full((B,), float(opts.rho), dtype=qp.Q.dtype,
                          device=qp.b.device)
    rho = torch.as_tensor(rho, dtype=qp.Q.dtype).to(qp.b.device)
    return rho.expand(B).contiguous()


def _prepare_fast(qp: QPBatch, opts: FCCQPOptions, static: bool = False,
                  rho=None, operator=None):
    """The operator stage: each instance's rho (`_rho_vector`) and its
    operator, ``operator`` where given. Returns ``(rho, operator)``."""
    rho = _rho_vector(qp, opts, rho)
    if operator is None:
        operator = admm_operator(qp.Q, qp.b, qp.A_eq, qp.b_eq, rho,
                                 static=static)
    return rho, operator


def _iterate_fast(qp: QPBatch, prep, shape: ProblemShape, opts: FCCQPOptions,
                  warm: Optional[WarmStart], warm_start: bool,
                  clock: Optional[StageClock] = None, static: bool = False):
    """The rest of the solve: the initial state (the exact presolve unless
    ``warm_start``), the chunk loop, the details and the warm state.
    ``static``: read-free (the presolve of a warm solve's
    equality-constrained instances is a branch on whether there is
    one)."""
    B = qp.b.shape[0]
    dev, dt = qp.b.device, qp.Q.dtype
    nc = shape.nc
    clock = clock or StageClock()
    rho, operator = prep
    if warm is None:
        warm = WarmStart.zeros(shape, (B,), dtype=dt, device=dev)
    if warm_start:
        mu_x0, mu_lam0, x_init = warm.mu_x, warm.mu_lambda_c, warm.x
    else:
        mu_x0 = torch.zeros_like(warm.mu_x)
        mu_lam0 = torch.zeros_like(warm.mu_lambda_c)
        x_init = _presolve(qp, static)
    # equality-constrained instances iterate with the batch (their
    # residuals take part in the adaptation, as in the JAX engine) and
    # take the presolve afterwards
    if nc == 0:
        eq_c = (torch.isinf(qp.lb).all(dim=-1)
                & torch.isinf(qp.ub).all(dim=-1))
        if warm_start:
            (x_init,) = branch(
                eq_c.any() if static else bool(eq_c.any()),
                lambda x: (torch.where(eq_c[:, None], _presolve(qp, static),
                                       x),), x_init)
    else:
        eq_c = torch.zeros((B,), dtype=torch.bool, device=dev)

    x, mu_x, mu_lam, n_iter, xrn, lrn, n_refactor = _admm_batched(
        qp, x_init, mu_x0, mu_lam0, rho, shape, opts, operator, static)
    clock.mark("iterate")
    clock.count("n_refactor", n_refactor)
    x = torch.where(eq_c[:, None], x_init, x)
    n_iter = torch.where(eq_c, 0, n_iter).to(torch.int32)
    xrn = torch.where(eq_c, torch.zeros_like(xrn), xrn)
    lrn = torch.where(eq_c, torch.zeros_like(lrn), lrn)
    details = _details(x, qp, shape, n_iter, xrn, lrn, opts.max_iter)
    sol = FCCQPSolution(details=details, z=x)
    new_warm = WarmStart(x=x, mu_x=torch.where(eq_c[:, None], mu_x0, mu_x),
                         mu_lambda_c=mu_lam)
    clock.mark("finalize")
    return sol, new_warm


def fast_stages(shape: ProblemShape, opts: FCCQPOptions,
                dtype=torch.float64, operator: bool = False) -> Stages:
    """`solve_batched_fast`'s static stage pair on ``dtype`` data (the
    form `core.graphs.CapturedBatch` captures). Its input buffers are a
    `Given`: the batch and each instance's rho, and with ``operator`` the
    prebuilt operator, which the operator stage then copies instead of
    building it."""
    n = shape.num_vars

    def inputs(B, dev):
        kw = dict(dtype=dtype, device=dev)
        op = ((torch.zeros((B, n, n), **kw), torch.zeros((B, n), **kw))
              if operator else None)
        return Given(zero_batch(shape, B, dev, dtype, batch_last=False),
                     torch.zeros((B,), **kw), op)

    def prepare(inp, warm, cache, warm_start):
        # copies: an adaptive-rho rebuild (an IF node under a capture)
        # writes rho and the operator in place
        op = (None if inp.operator is None
              else tuple(a.clone() for a in inp.operator))
        return _prepare_fast(inp.qp, opts, static=True, rho=inp.rho.clone(),
                             operator=op)

    return Stages(
        ("fast", shape, opts, dtype, operator), inputs, prepare,
        lambda inp, prep, warm, cache, warm_start: _iterate_fast(
            inp.qp, prep, shape, opts, warm, warm_start, static=True))


def solve_batched_fast(
    qp: QPBatch,
    shape: ProblemShape,
    opts: FCCQPOptions = FCCQPOptions(),
    warm: Optional[WarmStart] = None,
    warm_start: bool = False,
    rho=None,
    operator=None,
    timing: bool = True,
    device=None,
    stage_times: Optional[dict] = None,
    graphs: Optional[bool] = None,
):
    """Accelerated batched solve (leading batch axis): the parity
    engine's control flow (duals reset unless ``warm_start``; the exact
    presolve unless ``warm_start``; an equality-constrained instance, no
    cones and every bound infinite, takes the presolve with n_iter 0)
    with over-relaxation (``opts.alpha``) and adaptive rho
    (``opts.adaptive_rho``).

    Runs on ``device`` (default CUDA; raises when there is no card) in
    the data's dtype (f32 or f64); rho starts at ``rho`` (a float, a 0-d
    tensor or one per instance) or else ``opts.rho``, and adapts per
    instance. ``operator``: a prebuilt ``(F, x_const)`` of the batch,
    (B, n, n) / (B, n), for that starting rho (`ops.kkt.admm_operator`),
    which the solve then does not build; it must match ``rho``. On the
    card the solve runs captured (`fast_stages`, `core.graphs.
    solve_captured`: the first call of each configuration, batch size,
    ``warm_start`` and with or without an operator captures it, and
    every call replays it, rho and the operator copied into input
    buffers of the capture); ``graphs=False`` runs it uncaptured (the
    eager path, which reads the device between chunks).
    ``details.solve_time`` is the span of the whole solve and
    ``details.factorization_time`` the initial operator build's (CUDA
    events around the replays; uncaptured, wall spans each ending in a
    device synchronize). ``timing=False`` leaves both zero and adds no
    barrier, so captured calls queue back to back on the current stream
    (`core.graphs.solve_captured`). ``stage_times``: a dict that receives
    the synchronized seconds of the stages ``operator``, ``iterate`` and
    ``finalize`` and the count of operator rebuilds ``n_refactor``; such
    a call runs uncaptured.

    Returns ``(FCCQPSolution, WarmStart)``, batch-leading.
    """
    dev = resolve_device(device)
    dt = compute_dtype(qp)
    qp = qp.to(dev, dt)
    if warm is not None:
        warm = warm.to(dev, dt)
    if graphs and dev.type != "cuda":
        raise ValueError("CUDA graphs need a CUDA device")
    if operator is not None:
        operator = tuple(a.to(dev, dt) for a in operator)
    if dev.type == "cuda" and stage_times is None and graphs is not False:
        from fcc_qp_tpu_torch.core.graphs import solve_captured

        return solve_captured(
            fast_stages(shape, opts, dt, operator is not None),
            Given(qp, _rho_vector(qp, opts, rho), operator), warm,
            warm_start, dev, timing)
    clock = StageClock(stage_times, dev)
    if timing:
        sync(dev)
    t0 = time.perf_counter()
    prep = _prepare_fast(qp, opts, rho=rho, operator=operator)
    clock.mark("operator")
    if timing:
        sync(dev)
    t1 = time.perf_counter()
    sol, new_warm = _iterate_fast(qp, prep, shape, opts, warm, warm_start,
                                  clock)
    if not timing:
        return sol, new_warm
    sync(dev)
    t2 = time.perf_counter()
    return stamp_solution_times(sol, t2 - t0, t1 - t0), new_warm
