"""The solve as one device program: the port's counterpart of the JAX
package's program boundary (the drop-in's jitted solve,
`fcc_qp_tpu.core.serving._serve_step_ds`, and the jitted batched solve
and warm scan of `fcc_qp_tpu.core.ds_engine`, each one compiled program
with its control flow on the device).

Every data-dependent skip of a static solve is an IF node of its graph
(`ops.device_branch.branch`): a replay runs or skips each body on the
device, with no host read.

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

`CapturedBatch` does the same for a batch of any size, for whichever
engine's static stage pair it is given (`core.ds_engine.Stages`: the
reduced path, the full-splitting engine, `solve_batched_fast`, the
parity engine): `solve_batched_ds`, `replay_ds_streams`,
`solve_batched_fast`, `solve_batched` and `replay` on the card replay one
(see its docstring, `solve_captured` and `replay_captured`).

Capture runs with cuSOLVER as PyTorch's linear-algebra backend (MAGMA's
batched routines wait on the host); at one instance PyTorch picks
cuSOLVER anyway, so the replays equal the eager solve. At large batches
the eager (reading) solve may take MAGMA, so a batched capture is held
bit for bit against the uncaptured static solve under cuSOLVER, and
against the eager solve by its statuses and a tolerance.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Callable, Optional

import numpy as np
import torch

from fcc_qp_tpu_torch.config import FCCQPOptions, ProblemShape
from fcc_qp_tpu_torch.core.ds_engine import (
    QPBatchDS,
    Stages,
    WarmStartDS,
    _iterate_reduced,
    _prepare_reduced,
    _solve_reduced_k0,
    constrained_indices,
    field_dims,
    reduced_stages,
)
from fcc_qp_tpu_torch.ops.device_branch import (
    _leaves,
    _rebuild,
    body_graphs,
    device_key,
    exhausted_flag,
    forget_owned,
)
from fcc_qp_tpu_torch.utils.timing import stamp_solution_times
from fcc_qp_tpu_torch.core.solver import _solve_core
from fcc_qp_tpu_torch.ops import pallas_admm
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
        exhausted_flag(self.device)
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
                forget_owned()
                with torch.cuda.graph(g_iter, pool=pool):
                    self._store(*self._iterate(prep, warm_start))
                forget_owned()
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


# --------------------------------------------------------------------------
# the batched solves
# --------------------------------------------------------------------------

# the batched captures `captured_batch` keeps (least recently used
# dropped, and with it its graphs' memory), as `core.api.FCCQP` keeps its
# own: one per (engine configuration, batch, device)
MAX_CAPTURES = 8
_CAPTURES: collections.OrderedDict = collections.OrderedDict()


def _store(dst, src) -> None:
    """Copy the tensors of ``src`` into the buffers of ``dst`` (the same
    structure). A source that shares memory with a buffer it does not go
    to is copied out first, so no buffer is read after it is written."""
    dsts, srcs = _leaves(dst, []), _leaves(src, [])
    if len(dsts) != len(srcs):
        raise ValueError("the solve's outputs changed their structure")
    targets = {d.untyped_storage().data_ptr() for d in dsts}
    srcs = [s_.clone() if s_.untyped_storage().data_ptr() in targets
            and s_ is not d else s_ for d, s_ in zip(dsts, srcs)]
    for d, s_ in zip(dsts, srcs):
        if s_ is not d:
            d.copy_(s_)


class CapturedBatch:
    """An engine's static solve of a batch of ``B`` (its `Stages`: the
    reduced path's `core.ds_engine.reduced_stages`, `full_stages`, the
    batch-level engine's `core.batched.fast_stages`, the parity engine's
    `core.solver.parity_stages`), over static buffers on ``device``:

    * ``inp``: the batch, in the stages' layout (`load`);
    * ``warm``: the warm state a warm solve starts from (`load_warm`, or
      the solve before it); every solve writes its new state into it;
    * ``cache``: where the stages thread one (a reduced replay), the
      `OperatorCache` (KKT and polish seeds, classification, Ruiz
      factors) a warm solve starts from and every solve writes, as a
      replay threads it from step to step;
    * ``out``: the solution (`FCCQPSolution`, batch-leading).

    ``CapturedBatch(shape, opts, con_idx, B, device, with_cache=...)`` is
    the reduced path's spelling of ``CapturedBatch(reduced_stages(shape,
    opts, con_idx, cached=with_cache), B, device)``.

    `run` solves the batch in ``inp``, cold or warm, into the buffers.
    On CUDA the first `run` of each kind captures it: a warm-up of the
    static solve on a side stream (whose results only give the buffers
    their shapes), then an operator graph and an iteration graph in one
    memory pool, kept (``keep_graph``) so their nodes can be counted;
    later runs replay them. On the CPU, or with ``graphs=False`` (the
    uncaptured static solve the replays are held against), the static
    solve runs eagerly. A failed capture raises. ``capture_seconds``
    holds each capture's warm-up, capture and instantiate seconds,
    ``capture_launches`` the hand kernels' launches in one replay of each
    pair (counted while it is captured: every launch is one kernel node,
    whether or not its IF body runs), and ``graph_handles`` the
    ``cudaGraph_t`` of each graph and of every IF body in it."""

    def __init__(self, stages, *args, with_cache: bool = False,
                 graphs: Optional[bool] = None):
        if not isinstance(stages, Stages):
            shape, opts, con_idx, *args = (stages, *args)
            stages = reduced_stages(shape, opts, con_idx, cached=with_cache)
        B, device = args
        self.stages, self.B = stages, B
        self.with_cache = stages.cached
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        self.graphs = cuda if graphs is None else graphs
        if self.graphs and not cuda:
            raise ValueError("CUDA graphs need a CUDA device")
        self.inp = stages.inputs(B, self.device)
        self.warm = None
        self.cache = None
        self.out = None
        self._captured: dict = {}
        self.capture_seconds: dict = {}
        self.capture_launches: dict = {}
        self.graph_handles: dict = {}
        # recorded behind every replay, so that the capture can be dropped
        # while a replay is queued (`wait`)
        self._replayed = torch.cuda.Event() if self.graphs else None

    def load(self, qp) -> None:
        """Copy the batch ``qp`` (in the stages' layout, any device) into
        ``inp``."""
        for buf, a in zip(_leaves(self.inp, []), _leaves(qp, [])):
            buf.copy_(a)

    def load_warm(self, warm) -> None:
        """Copy a warm state into the ``warm`` buffers."""
        if self.warm is None:
            self.warm = _rebuild(warm, iter([a.to(self.device).clone()
                                             for a in _leaves(warm, [])]))
        else:
            _store(self.warm, warm)

    # -- the static solve, in two stages ------------------------------
    def _prepare(self, warm_start: bool):
        return self.stages.prepare(
            self.inp, self.warm if warm_start else None,
            self.cache if warm_start else None, warm_start)

    def _iterate(self, prep, warm_start: bool):
        """The iteration stage: ``(solution, warm[, cache])``."""
        return self.stages.iterate(
            self.inp, prep, self.warm if warm_start else None,
            self.cache if warm_start else None, warm_start)

    def _targets(self):
        return ((self.out, self.warm, self.cache) if self.with_cache
                else (self.out, self.warm))

    def _keep(self, outputs) -> None:
        """Give the buffers not made yet the shapes of ``outputs``."""
        if self.out is None:
            self.out = _copy(outputs[0])
        if self.warm is None:
            self.warm = _copy(outputs[1])
        if self.with_cache and self.cache is None:
            self.cache = _copy(outputs[2])

    # -- capture and replay -------------------------------------------
    def _capture(self, warm_start: bool) -> None:
        dev = self.device
        exhausted_flag(dev)
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(current)
        with _cusolver(), torch.cuda.stream(side):
            outputs = self._iterate(self._prepare(warm_start), warm_start)
        current.wait_stream(side)
        self._keep(outputs)
        del outputs
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        pool = (self._captured[not warm_start][3] if self._captured
                else torch.cuda.graph_pool_handle())
        handles = {}
        launches = {fn.__name__: fn.launches for fn in pallas_admm.KERNELS}
        with _cusolver():
            graphs = []
            for stage in ("operator", "iteration"):
                g = torch.cuda.CUDAGraph(keep_graph=True)
                n0 = len(body_graphs)
                with torch.cuda.graph(g, pool=pool):
                    if stage == "operator":
                        prep = self._prepare(warm_start)
                    else:
                        _store(self._targets(),
                               self._iterate(prep, warm_start))
                forget_owned()
                handles[stage] = [g.raw_cuda_graph()] + body_graphs[n0:]
                graphs.append(g)
            t2 = time.perf_counter()
            for g in graphs:
                g.instantiate()
            torch.cuda.synchronize(dev)
        t3 = time.perf_counter()
        # the operator stage's outputs stay referenced: the iteration
        # graph reads them at every replay
        self._captured[warm_start] = (graphs[0], graphs[1], prep, pool)
        self.graph_handles[warm_start] = handles
        self.capture_launches[warm_start] = {
            fn.__name__: fn.launches - launches[fn.__name__]
            for fn in pallas_admm.KERNELS}
        self.capture_seconds[warm_start] = dict(
            warm_up=t1 - t0, capture=t2 - t1, instantiate=t3 - t2)

    def run(self, warm_start: bool,
            between: Optional[Callable[[], None]] = None) -> None:
        """Solve the batch in ``inp`` (from the ``warm`` and ``cache``
        buffers when ``warm_start``) into the buffers, queued on the
        current stream; ``between()`` runs after the operator stage is
        queued. Captures at the first call of each kind on CUDA."""
        if warm_start and self.warm is None:
            raise ValueError("warm_start=True needs a warm state")
        if not self.graphs:
            with _cusolver() if self.device.type == "cuda" else (
                    contextlib.nullcontext()):
                prep = self._prepare(warm_start)
                if between is not None:
                    between()
                outputs = self._iterate(prep, warm_start)
            self._keep(outputs)
            _store(self._targets(), outputs)
            return
        if warm_start not in self._captured:
            self._capture(warm_start)
        g_prep, g_iter, _, _ = self._captured[warm_start]
        g_prep.replay()
        if between is not None:
            between()
        g_iter.replay()
        self._replayed.record()

    def wait(self) -> None:
        """Block until the last replay queued by `run` has finished (its
        event, not the whole device)."""
        if self._replayed is not None:
            self._replayed.synchronize()

    def result(self):
        """The solution, warm state (and cache) in the buffers, copied out
        (the next run overwrites the buffers)."""
        return tuple(_copy(x) for x in self._targets())


def _copy(x):
    """``x`` with every tensor cloned."""
    return _rebuild(x, iter([a.clone() for a in _leaves(x, [])]))


def captured_batch(stages: Stages, B: int, device) -> CapturedBatch:
    """The `CapturedBatch` of this engine configuration, batch size and
    device, made at its first use; the least recently used of more than
    `MAX_CAPTURES` is dropped, once its last queued replay has finished
    (a solve with ``timing=False`` returns before its replay runs)."""
    key = (stages.key, B, device_key(device))
    if key in _CAPTURES:
        _CAPTURES.move_to_end(key)
    else:
        _CAPTURES[key] = CapturedBatch(stages, B, device)
        if len(_CAPTURES) > MAX_CAPTURES:
            _, dropped = _CAPTURES.popitem(last=False)
            dropped.wait()
    return _CAPTURES[key]


def solve_captured(stages: Stages, qp, warm, warm_start: bool, device,
                   timing: bool = True):
    """A batched solve on the card through its capture (the entry points'
    captured form: `solve_batched_ds`, `solve_batched_fast`,
    `solve_batched`): the batch (and warm state) copied into the
    capture's buffers, a replay, the results copied out (so that callers
    of the same capture, the shards of a split batch among them, never
    see each other's buffers). ``factorization_time`` is the operator
    graph's span and ``solve_time`` both graphs', from CUDA events.

    ``timing=False`` records no event and reads nothing back: the
    copy-in, the replay and the copy-out are queued on the current stream
    and the call returns, its time fields zero, so calls queue back to
    back (the CUDA driver may still hold the host at a launch while
    earlier replays of the same graphs are queued). That is safe on one
    stream only: the next call's copy-in
    overwrites the buffers this call's copy-out reads, and stream order
    alone keeps it behind that copy-out. Calls of one capture on two
    streams need the caller's synchronization between them."""
    cap = captured_batch(stages, _batch(qp), device)
    cap.load(qp)
    if warm_start:
        if warm is None:
            raise ValueError("warm_start=True needs a warm state")
        cap.load_warm(warm)
    if not timing:
        cap.run(warm_start)
        return cap.result()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    cap.run(warm_start, between=ev[1].record)
    ev[2].record()
    sol, ws = cap.result()
    ev[2].synchronize()
    return (stamp_solution_times(sol, ev[0].elapsed_time(ev[2]) * 1e-3,
                                 ev[0].elapsed_time(ev[1]) * 1e-3), ws)


def _batch(qp) -> int:
    """The batch size of ``qp``: batch-last for the ds engines
    (`QPBatchDS`), batch-leading otherwise."""
    b = qp.b
    return b.shape[-1] if isinstance(qp, QPBatchDS) else b.shape[0]


def replay_captured(stages: Stages, log, device):
    """A warm-chained replay on the card through the capture of
    ``stages``, over the step-major ``log`` (element ``[t]`` of each
    field is step t's batch in the stages' layout): step 0 replays the
    cold graphs, each later step copies its slice into the input buffers
    and replays the warm graphs, which read and rewrite the warm state
    (and the operator cache) in place. Nothing is read back between
    steps. Returns ``(per-step solutions, final warm state, wall seconds,
    step 0's operator-graph seconds)``."""
    fields = _leaves(log, [])
    steps = fields[0].shape[0]
    step = lambda t: _rebuild(log, iter([a[t] for a in fields]))
    cap = captured_batch(stages, _batch(step(0)), device)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    sols = []
    for t in range(steps):
        name = "replay_step0" if t == 0 else "replay_warm_step"
        with torch.profiler.record_function(name):
            cap.load(step(t))
            if t == 0:
                ev[0].record()
                cap.run(False, between=ev[1].record)
            else:
                cap.run(True)
            sols.append(_copy(cap.out))
    ws = _copy(cap.warm)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    return sols, ws, wall, ev[0].elapsed_time(ev[1]) * 1e-3
