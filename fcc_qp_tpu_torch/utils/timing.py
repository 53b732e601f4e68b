"""Device synchronization, timing and the program's own telemetry (port
of `fcc_qp_tpu/utils/timing.py`, extended).

PyTorch launches CUDA work asynchronously: a host clock read right after
a call measures the enqueue, not the work. `sync` is the barrier every
host-clock span must end in, and `timed` is the JAX package's best-of-N
wall of a call.

The telemetry, which observes and never changes an answer:

* `StageClock`: the stages of a solve. Eager, with a dict, it adds
  synchronized host seconds per stage (``stage_times=``). Inside a
  CUDA graph capture its marks become stamp kernels
  (`csrc/graph_nodes.cu`, `stage_stamp`) that add each stage's device
  nanoseconds and visits to the capture's row, at every replay; its
  nested pairs (`StageClock.begin` / `end`, around each Newton-Schulz
  chain of the polish) add a site's nanoseconds and visits to the
  capture's sub-stage row, inside the stage and without closing it;
* `CaptureRecord`: one per capture (`core.graphs.CapturedBatch`,
  `CapturedSolve`): its key, warm-up / capture / instantiate seconds,
  graph nodes by type, hand-kernel launches, replays, the stage row,
  and the sub-stage sites with their row;
* `span`: named host spans (`fccqp.<layer>.<name>`), each duration kept
  in a ring of the last `RING` per name; a profiler range opens only
  while a `torch.profiler` session records;
* `telemetry`: a plain snapshot of all three, read back once.

With no profiler recording and no ``stage_times``, what this adds to a
solve is the stamp nodes inside its graphs and a few host clock reads
per call: no synchronize, no device read, no dispatcher call.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import numpy as np
import torch
import torch.autograd.profiler as _profiler


def sync(device=None) -> None:
    """Block until all queued work on ``device`` has finished (no-op for
    the CPU, whose operations are synchronous)."""
    if device is None or torch.device(device).type == "cuda":
        if torch.cuda.is_available():
            torch.cuda.synchronize(device)


def _cuda_devices(tree, out: set) -> set:
    """The CUDA devices of the tensors in ``tree`` (a tensor, dataclass,
    named tuple, tuple, list or dict of them)."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            out.add(tree.device)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            _cuda_devices(getattr(tree, f.name), out)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _cuda_devices(v, out)
    return out


def timed(fn, *args, reps: int = 3, **kw):
    """Best-of-``reps`` wall time of ``fn(*args, **kw)``, each call ended
    by a true barrier: a synchronize of every card that holds a tensor of
    its result (the CPU needs none). The first call (which captures or
    builds what later calls replay) is excluded. Returns ``(best_seconds,
    last_result)``."""
    def call():
        out = fn(*args, **kw)
        for dev in _cuda_devices(out, set()):
            torch.cuda.synchronize(dev)
        return out

    out = call()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = call()
        best = min(best, time.perf_counter() - t0)
    return best, out


def stamp_solution_times(sol, solve_time: float, factor_time: float):
    """Broadcast host-measured per-phase wall times into a solution's
    details (every instance of a batched solve shares the wall clock)."""
    like = sol.details.admm_residual_bounds
    det = dataclasses.replace(
        sol.details,
        solve_time=torch.full_like(like, solve_time, dtype=torch.float64),
        factorization_time=torch.full_like(
            like, factor_time, dtype=torch.float64
        ),
    )
    return type(sol)(details=det, z=sol.z)


# --------------------------------------------------------------------------
# stages
# --------------------------------------------------------------------------

# every stage a `StageClock.mark` names, in the order of the stamp row's
# slots (the reduced path's seven, then the full engines' "iterate")
STAGES = ("scaling", "operator", "approach", "polish", "exact_build",
          "endgame", "finalize", "iterate")
_SLOT = {name: i for i, name in enumerate(STAGES)}
# a row: the last stamp, then (nanoseconds, visits) per stage
ROW = 1 + 2 * len(STAGES)
# sub-stage sites a capture has room for, each a (nanoseconds, visits)
# pair of its sub-stage row after the open pair's begin stamp: a cold
# capture of 8192 opens about 470 (the polish's chain sites, every
# gathered pass's included)
SUB_SITES = 2048
SUB_ROW = 1 + 2 * SUB_SITES

# the record of the capture in progress and the graph being captured,
# while it is (`stamping`): the only time a mark stamps
_STAMPING: Optional[tuple] = None


class StageClock:
    """The stages of a solve: `mark` closes the stage that ran since the
    previous mark, `count` adds instance counts.

    With a dict ``out`` (``stage_times=``) it adds synchronized wall
    seconds per stage and the counts into ``out``; it synchronizes at
    every mark, so such a solve runs eagerly. With ``out=None`` it
    neither synchronizes nor records, so an untimed solve keeps its
    asynchronous launches; but a mark made while a capture is stamped
    (`stamping`) queues one stamp kernel on the current stream, which at
    every replay adds the stage's device nanoseconds to the capture's
    row (a mark inside an IF body stamps on the body's stream, so a
    skipped body stamps nothing). `begin` / `end` nest a sub-stage
    inside the current stage: under a stamped capture they queue a pair
    of stamps on the capture's sub-stage row, which add the device
    nanoseconds between them to the site's slot and count its visit at
    every replay, and leave the stage row alone, so the enclosing stage
    still holds the sub-stage's time; otherwise (eager, or the CPU) they
    do nothing. The counts (``n_refactor``,
    ``n_kkt_rescue``, ``n_fallback``, ``n_fallback_calls``,
    ``n_polish_rebuild``) are host reads, so they exist in the eager
    form only."""

    def __init__(self, out=None, device=None):
        self.out, self.device = out, device
        self.t = None
        if out is not None:
            sync(device)
            self.t = time.perf_counter()

    def mark(self, stage: str) -> None:
        if self.out is None:
            if _STAMPING is not None:
                rec, graph = _STAMPING
                if (rec.device.type == "cuda"
                        and torch.cuda.is_current_stream_capturing()):
                    rec.stamp(_SLOT[stage], graph)
            return
        sync(self.device)
        now = time.perf_counter()
        self.out[stage] = self.out.get(stage, 0.0) + (now - self.t)
        self.t = now

    def begin(self, name: str, **site) -> Optional[tuple]:
        """Open the sub-stage ``name`` at a site described by ``site``
        (plain values, known at capture: for a polish chain its mode,
        N2, chain count and path); returns the token `end` takes, None
        where nothing stamps."""
        if _STAMPING is None:
            return None
        rec, graph = _STAMPING
        if not (rec.device.type == "cuda"
                and torch.cuda.is_current_stream_capturing()):
            return None
        return rec, graph, rec.open_site(graph, name, site)

    def end(self, token: Optional[tuple]) -> None:
        """Close the sub-stage `begin` opened (None: nothing)."""
        if token is not None:
            rec, graph, slot = token
            rec.queue_stamp(rec.sub, slot, graph)

    def count(self, key: str, mask) -> None:
        """Adds the number of set entries of ``mask`` (or an int) to
        ``out[key]`` (a host read, so only when recording)."""
        if self.out is None:
            return
        n = int(mask.sum()) if isinstance(mask, torch.Tensor) else int(mask)
        self.out[key] = self.out.get(key, 0) + n


# --------------------------------------------------------------------------
# one record per capture
# --------------------------------------------------------------------------

@dataclasses.dataclass
class CaptureRecord:
    """One capture of a stage pair (an operator graph and an iteration
    graph). ``kind``: ``"batch"`` (`core.graphs.CapturedBatch`) or
    ``"solve"`` (`CapturedSolve`, B = 1); ``key``: the capture's own key
    (engine configuration and batch, or options and classification);
    ``warm``: the warm pair or the cold one. Filled by the capture:
    ``seconds`` (``warm_up``, ``capture``, ``count``: the node count,
    ``instantiate``), ``nodes``
    (per graph, ``operator`` / ``iteration``: its nodes by type from
    `libcuda`, its IF bodies' included, None where `libcuda` does not
    answer; ``kernel`` counts every kernel node, the stamps among them),
    ``stamps`` (per graph, the stamp kernel nodes) and ``launches`` (the
    hand kernels' launches in one replay of the pair, counted while it
    is captured). ``replays``: the pair's replays, counted on the host.
    ``row``: the stage clock's int64 row on the capture's device
    (`ROW`), written by the stamps only; ``sub``: its sub-stage row
    (`SUB_ROW`), and ``sites``, one dict per sub-stage site opened in
    the capture (``name``, ``graph`` and what `StageClock.begin` was
    given), site i in slot i of ``sub``. The stamps of both rows count
    in ``stamps``."""

    kind: str
    key: tuple
    warm: bool
    device: torch.device
    row: torch.Tensor
    sub: torch.Tensor
    sites: list = dataclasses.field(default_factory=list)
    seconds: dict = dataclasses.field(default_factory=dict)
    nodes: dict = dataclasses.field(default_factory=dict)
    stamps: dict = dataclasses.field(default_factory=dict)
    launches: dict = dataclasses.field(default_factory=dict)
    replays: int = 0

    def stamp(self, slot: int, graph: str) -> None:
        """Queue a stamp of ``slot`` (-1: the graph's opening stamp,
        which adds nothing) on the current stream, which is capturing
        ``graph`` (``"operator"`` / ``"iteration"``) or an IF body in
        it."""
        self.queue_stamp(self.row, slot, graph)

    def open_site(self, graph: str, name: str, site: dict) -> int:
        """Register a sub-stage site of ``graph`` and queue its begin
        stamp (slot -1 of ``sub``, which only sets the last stamp);
        returns the site's slot."""
        slot = len(self.sites)
        if slot >= SUB_SITES:
            raise RuntimeError(f"a capture opened more than {SUB_SITES} "
                               f"sub-stage sites")
        self.sites.append(dict(site, name=name, graph=graph))
        self.queue_stamp(self.sub, -1, graph)
        return slot

    def queue_stamp(self, row: torch.Tensor, slot: int, graph: str) -> None:
        """Queue one stamp kernel of ``slot`` on ``row`` (the stage row
        or the sub-stage row) on the current stream."""
        from fcc_qp_tpu_torch.ops.device_branch import build_graph_nodes

        err = build_graph_nodes().stage_stamp(
            torch.cuda.current_stream(self.device).cuda_stream,
            row.data_ptr(), slot)
        if err != 0:
            raise RuntimeError(f"could not queue a stage stamp: CUDA error "
                               f"{err}")
        self.stamps[graph] = self.stamps.get(graph, 0) + 1

    def total_nodes(self, kind: str) -> Optional[int]:
        """Nodes of ``kind`` (``"kernel"``, ``"conditional"``) over both
        graphs and their IF bodies; None where they were not counted."""
        if not self.nodes or None in self.nodes.values():
            return None
        return sum(n.get(kind, 0) for n in self.nodes.values())


# every capture's record, in the order they were made (kept when the
# capture itself is dropped: a record is a few numbers and one row)
_RECORDS: list = []


def _device(device) -> torch.device:
    """``device`` with its index (``cuda`` is the current card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def capture_record(kind: str, key: tuple, warm: bool,
                   device) -> CaptureRecord:
    """A new record, its rows allocated now (outside any capture)."""
    dev = _device(device)
    rec = CaptureRecord(kind=kind, key=key, warm=warm, device=dev,
                        row=torch.zeros((ROW,), dtype=torch.int64,
                                        device=dev),
                        sub=torch.zeros((SUB_ROW,), dtype=torch.int64,
                                        device=dev))
    _RECORDS.append(rec)
    return rec


@contextlib.contextmanager
def stamping(rec: CaptureRecord, graph: str):
    """Stamp the marks made while the enclosed graph ``graph``
    (``"operator"`` / ``"iteration"``) of ``rec``'s pair is captured:
    opens with the graph's opening stamp, so that the time between
    replays is never charged to a stage. Enter it inside
    ``torch.cuda.graph(...)``."""
    global _STAMPING
    if _STAMPING is not None:
        raise RuntimeError("a stamped capture is already in progress")
    rec.stamp(-1, graph)
    _STAMPING = (rec, graph)
    try:
        yield rec
    finally:
        _STAMPING = None


# --------------------------------------------------------------------------
# host spans
# --------------------------------------------------------------------------

# durations each span keeps (a power of two)
RING = 1 << 16


class Span:
    """A named host span, entered with ``with``: records its duration
    (`time.perf_counter_ns`) into a ring of the last `RING`, and, only
    while a `torch.profiler` session records, opens a profiler range of
    its name around it (checked per span on the profiler's module flag,
    so that otherwise no dispatcher call is made). Not reentrant: one
    object per site, entered by one thread at a time."""

    __slots__ = ("name", "ring", "n", "_t0", "_range")

    def __init__(self, name: str):
        self.name = name
        self.ring = np.zeros(RING, dtype=np.int64)
        self.n = 0
        self._t0 = 0
        self._range = None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self._range = _profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.ring[self.n & (RING - 1)] = time.perf_counter_ns() - self._t0
        self.n += 1
        if self._range is not None:
            r, self._range = self._range, None
            r.__exit__(*exc)
        return False

    def durations(self) -> np.ndarray:
        """The kept durations in nanoseconds, oldest first."""
        if self.n <= RING:
            return self.ring[:self.n].copy()
        i = self.n & (RING - 1)
        return np.concatenate([self.ring[i:], self.ring[:i]])


_SPANS: dict = {}


def span(layer: str, name: str) -> Span:
    """The span ``fccqp.<layer>.<name>``, made at its first use."""
    full = f"fccqp.{layer}.{name}"
    s = _SPANS.get(full)
    if s is None:
        s = _SPANS[full] = Span(full)
    return s


# --------------------------------------------------------------------------
# the snapshot
# --------------------------------------------------------------------------

def telemetry(device=None) -> dict:
    """A plain snapshot of the telemetry: ``spans`` (name -> durations in
    ns, oldest first, and ``count``, the spans ever closed) and
    ``captures`` (one dict per `CaptureRecord`, of ``device`` or of every
    device when None, with ``stages``: name -> ``ns`` and ``visits``
    summed over its replays, and ``sites``: its sub-stage sites, each
    with its ``ns`` and ``visits`` so summed). Reads the rows back with
    one synchronize and one small copy per device; call it outside the
    timed path."""
    recs = [r for r in _RECORDS
            if device is None or r.device == _device(device)]
    rows = {}
    for dev in dict.fromkeys(r.device for r in recs):
        mine = [r for r in recs if r.device == dev]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        host = torch.stack([torch.cat([r.row, r.sub])
                            for r in mine]).cpu().numpy()
        rows.update({id(r): h for r, h in zip(mine, host)})
    captures = []
    for r in recs:
        row, sub = rows[id(r)][:ROW], rows[id(r)][ROW:]
        captures.append(dict(
            kind=r.kind, key=repr(r.key), warm=r.warm, device=str(r.device),
            seconds=dict(r.seconds), nodes=dict(r.nodes),
            stamps=dict(r.stamps), launches=dict(r.launches),
            replays=r.replays,
            stages={name: dict(ns=int(row[1 + 2 * i]),
                               visits=int(row[2 + 2 * i]))
                    for i, name in enumerate(STAGES)},
            sites=[dict(site, ns=int(sub[1 + 2 * i]),
                        visits=int(sub[2 + 2 * i]))
                   for i, site in enumerate(r.sites)]))
    return dict(
        spans={name: dict(ns=s.durations(), count=s.n)
               for name, s in _SPANS.items()},
        captures=captures)
