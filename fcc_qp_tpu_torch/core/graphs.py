"""The B = 1 solve as one device program: the port's counterpart of the
JAX package's program boundary (`fcc_qp_tpu.core.serving._serve_step_ds`
and the drop-in's jitted solve, each one compiled program with its
control flow on the device).

A `CapturedSolve` owns, for one ``(shape, options, engine,
classification)``, the static solve of a single instance (the
``static=True`` form of `core.ds_engine._solve_ds_reduced` or
`core.solver._solve_core`, which reads nothing back from the device)
and, on CUDA, that solve captured as CUDA graphs: a cold pair and a warm
pair, each an operator stage and an iteration stage, in one private
memory pool. It reads and writes `SolveBuffers`, static device buffers:

* ``inp``, the QP packed as the server uploads it (`layout`);
* ``warm``, the warm state the next solve starts from; the iteration
  stage writes the new state into it, so solve t+1 queued behind solve
  t reads t's state in stream order, with no host involvement;
* ``out``, the solution and the eleven diagnostics (`STATS`) in f64.

`run` replays the operator graph and then the iteration graph on the
current stream (a callback between the two lets `FCCQP` time the
factorization with CUDA events). The graphs are captured at the first
`run`, after a warm-up of both pairs on a side stream that writes no
buffer, so the warm chain starts from the first real solve. On the CPU,
or with ``graphs=False`` (the eager reference `chip_smoke.py` holds the
replays against), the same static solve runs eagerly, stage by stage.
A failed capture raises: nothing falls back to the eager solve.

Capture runs with cuSOLVER as PyTorch's linear-algebra backend (MAGMA's
batched routines wait on the host); at one instance PyTorch picks
cuSOLVER anyway, so the replays equal the eager solve.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import numpy as np
import torch

from fcc_qp_tpu_torch.config import FCCQPOptions, ProblemShape
from fcc_qp_tpu_torch.core.ds_engine import (
    QPBatchDS,
    WarmStartDS,
    _iterate_reduced,
    _prepare_reduced,
    _solve_reduced_k0,
    constrained_indices,
)
from fcc_qp_tpu_torch.core.solver import _solve_core
from fcc_qp_tpu_torch.ops.kkt import admm_operator
from fcc_qp_tpu_torch.types import QPBatch, WarmStart

# the packed result: the n solution words, then these diagnostics
STATS = ("n_iter", "solve_status", "admm_residual_bounds",
         "admm_residual_friction_cone", "bounds_viol", "friction_cone_viol",
         "equality_viol", "n_iter_f32", "n_iter_ds", "polish_attempts",
         "polish_accepted")
INT_STATS = ("n_iter", "solve_status", "n_iter_f32", "n_iter_ds",
             "polish_attempts", "polish_accepted")


def engine_options(opts: FCCQPOptions, engine: str) -> FCCQPOptions:
    """The options a B = 1 solve of ``engine`` runs: the ds engine forces
    scaling, constrained splitting, polish and the operator presolve,
    which keep the reference's solution and tolerance contract
    (tolerances checked in unscaled units; the polish validates
    itself)."""
    if engine == "ds":
        return opts.replace(scaling=True, splitting="constrained",
                            polish=True, presolve="operator")
    return opts


def host_fields(fields):
    """The seven QP fields (numpy arrays, sequences or tensors on any
    device) as f64 numpy arrays on the host."""
    return [np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor)
                       else a, np.float64) for a in fields]


def layout(shape: ProblemShape):
    """Field offsets of the packed QP: Q, b, A_eq, b_eq, friction_coeffs,
    lb, ub, each flattened in row-major order."""
    n, m, k = shape.num_vars, shape.num_eq, shape.n_cones
    sizes = (n * n, n, m * n, m, k, n, n)
    return tuple(int(o) for o in np.cumsum((0,) + sizes))


def field_dims(shape: ProblemShape):
    """The unbatched shape of each packed field."""
    n, m, k = shape.num_vars, shape.num_eq, shape.n_cones
    return ((n, n), (n,), (m, n), (m,), (k,), (n,), (n,))


def pack_host(shape: ProblemShape, fields, out: torch.Tensor) -> None:
    """Write the seven fields (host arrays) into the host buffer ``out``
    in the packed layout."""
    h = out.numpy()
    offs = layout(shape)
    for a, lo, hi in zip(fields, offs[:-1], offs[1:]):
        h[lo:hi] = np.asarray(a, np.float64).reshape(-1)


def unpack_views(shape: ProblemShape, buf: torch.Tensor, batch_last: bool):
    """The packed QP as views of ``buf``, a batch of one: batch-last
    (`QPBatchDS`) or batch-leading (`QPBatch`)."""
    offs = layout(shape)
    out = []
    for i, d in enumerate(field_dims(shape)):
        v = buf[offs[i]:offs[i + 1]]
        out.append(v.view(*d, 1) if batch_last else v.view(1, *d))
    return QPBatchDS(*out) if batch_last else QPBatch(*out)


def classify(shape: ProblemShape, engine: str,
             host: torch.Tensor) -> Optional[tuple]:
    """The classification a capture of ``engine`` is made for, from the
    packed QP ``host`` on the host (no device read): the ds engine's
    constrained coordinates (`core.ds_engine.constrained_indices`, the
    counterpart of the JAX engine's static ``con_idx``), None on the f64
    engine."""
    if engine != "ds":
        return None
    return constrained_indices(unpack_views(shape, host, batch_last=True),
                               shape)


@contextlib.contextmanager
def _cusolver():
    """PyTorch's linear algebra on cuSOLVER for the enclosed region."""
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


class SolveBuffers:
    """The static buffers of a B = 1 solve on ``device``: ``inp`` (the
    packed QP), ``warm`` (the engine's warm state: ds ``(x, mu_x,
    mu_lambda_c, rho)`` batch-last, f64 ``(x, mu_x, mu_lambda_c)``
    batch-leading) and ``out`` (z, then `STATS`). Captures of other
    options on the same shape and engine may share them, and with them
    the warm chain."""

    def __init__(self, shape: ProblemShape, engine: str, device,
                 rho: float):
        n, nc = shape.num_vars, shape.nc
        f64 = dict(dtype=torch.float64, device=device)
        self.inp = torch.zeros((layout(shape)[-1],), **f64)
        if engine == "ds":
            self.warm = (torch.zeros((n, 1), **f64),
                         torch.zeros((n, 1), **f64),
                         torch.zeros((nc, 1), **f64),
                         torch.full((1,), rho, dtype=torch.float32,
                                    device=device))
        else:
            self.warm = (torch.zeros((1, n), **f64),
                         torch.zeros((1, n), **f64),
                         torch.zeros((1, nc), **f64))
        self.out = torch.zeros((n + len(STATS),), **f64)


def pack_solution(sol) -> torch.Tensor:
    """The solution of one instance and its diagnostics as one f64
    vector (z, then `STATS`), on its device."""
    d = sol.details
    return torch.cat([
        sol.z.reshape(-1).to(torch.float64),
        torch.stack([getattr(d, k).reshape(-1)[0].to(torch.float64)
                     for k in STATS]),
    ])


class CapturedSolve:
    """One B = 1 solve of ``(shape, opts, engine, con_idx)`` over
    ``buffers`` (see the module docstring).

    ``engine``: ``"ds"`` (the reduced path) or ``"f64"`` (the parity
    engine); ``opts`` as given (`engine_options` gives the set that
    `FCCQP` and `FCCQPServer` run).
    ``con_idx``: the ds engine's classification
    (`core.ds_engine.constrained_indices`), fixed for the capture.
    ``graphs``: capture and replay CUDA graphs (the default on CUDA; on
    the CPU there is no graph)."""

    def __init__(self, shape: ProblemShape, opts: FCCQPOptions, engine: str,
                 buffers: SolveBuffers, con_idx: Optional[tuple] = None,
                 graphs: Optional[bool] = None):
        self.shape, self.opts, self.engine = shape, opts, engine
        self.buffers = buffers
        self.con_idx = con_idx
        self.device = buffers.inp.device
        cuda = self.device.type == "cuda"
        self.graphs = cuda if graphs is None else graphs
        if self.graphs and not cuda:
            raise ValueError("CUDA graphs need a CUDA device")
        self._captured = None

    # -- the static solve, in two stages ------------------------------
    def _warm_state(self):
        w = self.buffers.warm
        return WarmStartDS(*w) if self.engine == "ds" else WarmStart(*w)

    def _prepare(self, warm_start: bool):
        """The operator stage (the factorization time)."""
        s, o = self.shape, self.opts
        if self.engine == "f64":
            qp = unpack_views(s, self.buffers.inp, batch_last=False)
            return admm_operator(qp.Q, qp.b, qp.A_eq, qp.b_eq, o.rho,
                                 static=True)
        qp = unpack_views(s, self.buffers.inp, batch_last=True)
        if len(self.con_idx) == 0:
            # no constrained coordinate: one refined KKT solve is the solve
            return _solve_reduced_k0(qp, s, o, static=True)
        return _prepare_reduced(qp, self._warm_state(), s, o, warm_start,
                                self.con_idx, static=True)

    def _iterate(self, prep, warm_start: bool):
        """The iteration stage: returns the packed result and the new
        warm state's tensors."""
        s, o = self.shape, self.opts
        if self.engine == "f64":
            qp = unpack_views(s, self.buffers.inp, batch_last=False)
            sol, warm = _solve_core(qp, s, o, self._warm_state(), warm_start,
                                    prep, static=True)
        elif len(self.con_idx) == 0:
            sol, warm = prep
        else:
            qp = unpack_views(s, self.buffers.inp, batch_last=True)
            sol, warm = _iterate_reduced(qp, prep, s, o, self.con_idx,
                                         static=True)
        fields = ((warm.x, warm.mu_x, warm.mu_lambda_c, warm.rho)
                  if self.engine == "ds"
                  else (warm.x, warm.mu_x, warm.mu_lambda_c))
        return pack_solution(sol), fields

    def _store(self, packed, warm_fields) -> None:
        self.buffers.out.copy_(packed)
        for dst, src in zip(self.buffers.warm, warm_fields):
            dst.copy_(src)

    # -- capture and replay -------------------------------------------
    def _capture(self) -> None:
        """Warm up both pairs on a side stream (their results are
        dropped, so the warm buffers stay as they are), then capture each
        stage into one memory pool."""
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with _cusolver(), torch.cuda.stream(side):
            for warm_start in (False, True):
                self._iterate(self._prepare(warm_start), warm_start)
        current.wait_stream(side)
        pool = torch.cuda.graph_pool_handle()
        captured = {}
        with _cusolver():
            for warm_start in (False, True):
                g_prep, g_iter = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
                with torch.cuda.graph(g_prep, pool=pool):
                    prep = self._prepare(warm_start)
                with torch.cuda.graph(g_iter, pool=pool):
                    self._store(*self._iterate(prep, warm_start))
                # the operator stage's outputs stay referenced: the
                # iteration graph reads them at every replay
                captured[warm_start] = (g_prep, g_iter, prep)
        self._captured = captured

    @property
    def captured(self) -> bool:
        return self._captured is not None

    def run(self, warm_start: bool,
            between: Optional[Callable[[], None]] = None) -> None:
        """Solve the QP in ``buffers.inp`` from the warm buffers (cold:
        from nothing) into ``buffers.out`` and the warm buffers, queued on
        the current stream; ``between()`` runs after the operator stage
        is queued. Captures at the first call on CUDA."""
        if not self.graphs:
            prep = self._prepare(warm_start)
            if between is not None:
                between()
            self._store(*self._iterate(prep, warm_start))
            return
        if self._captured is None:
            self._capture()
        g_prep, g_iter, _ = self._captured[warm_start]
        g_prep.replay()
        if between is not None:
            between()
        g_iter.replay()
