"""Pipelined serving for the drop-in API (port of
`fcc_qp_tpu/core/serving.py`).

A control loop submits one QP per tick and reads results some ticks
later. `FCCQPServer` keeps up to ``depth`` warm-chained solves in flight:
solve t+1 is queued against the warm state that solve t leaves on the
device, and the host waits only when it retires a result, ``depth``
solves behind the submission front. Results retire in submission order.

The solve is one device program, as the JAX server's jitted step is: a
`core.graphs.CapturedSolve` (the engine's static, read-free B = 1 solve,
captured as CUDA graphs at the first submit). A submit, in CUDA terms:

* the seven QP fields go into one pinned host buffer and cross to the
  graph's input buffer in one ``non_blocking`` copy on the current
  stream;
* the cold graph (first submit, or after `reset_warm_start`) or the
  warm graph is replayed on the stream: it reads the warm state the
  previous replay left in the graph's buffers and writes the new one;
* the solution and every diagnostic, packed on the device into one f64
  vector, are copied to a pinned host buffer of a ring of ``depth`` in
  one ``non_blocking`` copy behind an event.

So a submit reads nothing back and waits on nothing: with depth > 1 the
host queues solve t+1 while the card still runs solve t, and retiring
(waiting on the oldest event) is the only wait. On the CPU the same
static solve runs eagerly inside the submit.

    server = FCCQPServer(shape, opts, depth=4)
    for qp in control_loop:
        t = server.submit(**qp)        # one upload, one replay
        done = server.poll()           # retired (ticket, FCCQPSolution)
    for t, sol in server.drain(): ...  # flush the tail

`submit` / `result` have the semantics of `FCCQP.Solve` /
`GetSolution` in the reference's replay loop: the first submit is cold,
every later one warm (``set_warm_start(i > 0)``).
"""

from __future__ import annotations

import collections
import time

import torch

from fcc_qp_tpu_torch.config import FCCQPOptions, ProblemShape
from fcc_qp_tpu_torch.core.ds_engine import resolve_device
from fcc_qp_tpu_torch.core.graphs import (
    INT_STATS,
    STATS,
    CapturedSolve,
    SolveBuffers,
    classify,
    engine_options,
    host_fields,
    layout,
    pack_host,
)
from fcc_qp_tpu_torch.types import FCCQPDetails, FCCQPSolution


class FCCQPServer:
    """Depth-D pipelined, warm-started QP serving on one device.

    Parameters:
      shape: the fixed problem shape (as the `FCCQP` constructor).
      opts: solver options; on ``engine="ds"`` scaling, constrained
        splitting, polish and the operator presolve are forced on, as in
        `FCCQP`'s ds engine.
      depth: the most solves in flight before `submit` retires the
        oldest; ``depth=1`` is the synchronous drop-in loop.
      engine: ``"ds"`` (the batched reduced engine on a batch of one) or
        ``"f64"`` (the parity engine).
      device: where the solves run (default CUDA; raises when there is
        no card). On CUDA every solve is a replay of the captured graphs.
    """

    def __init__(self, shape: ProblemShape,
                 opts: FCCQPOptions = FCCQPOptions(), depth: int = 4,
                 engine: str = "ds", device=None):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        if engine not in ("ds", "f64"):
            raise ValueError("engine must be 'ds' or 'f64'")
        self.shape = shape
        self.depth = int(depth)
        self.engine = engine
        self.device = resolve_device(device)
        self._opts = engine_options(opts, engine)
        self._cuda = self.device.type == "cuda"
        # the captured solve, made at the first submit (the ds engine's
        # classification comes from the first problem, as the JAX
        # server's static con_idx does)
        self._solve = None
        self._warm = False
        self._next_ticket = 0
        # the packed results land in a ring of `depth` host buffers: a
        # slot is written again only after its ticket has retired
        n_out = shape.num_vars + len(STATS)
        self._ring = [torch.empty((n_out,), dtype=torch.float64,
                                  pin_memory=self._cuda)
                      for _ in range(self.depth)]
        # in flight: (ticket, submit time, its ring slot, its event, the
        # pinned upload buffer kept alive until the copy ran)
        self._inflight: collections.deque = collections.deque()
        self._retired: dict[int, FCCQPSolution] = {}

    # -- dispatch ------------------------------------------------------
    def _captured(self, host: torch.Tensor) -> CapturedSolve:
        if self._solve is None:
            # classified once, from the first problem (the stream's shape
            # and bound pattern are fixed, as the reference's are)
            con_idx = classify(self.shape, self.engine, host)
            buffers = SolveBuffers(self.shape, self.engine, self.device,
                                   self._opts.rho)
            self._solve = CapturedSolve(self.shape, self._opts, self.engine,
                                        buffers, con_idx)
        return self._solve

    def submit(self, Q, b, A_eq, b_eq, friction_coeffs, lb, ub) -> int:
        """Queue one warm-chained solve; returns its ticket. Retires the
        oldest first when ``depth`` solves are in flight."""
        while len(self._inflight) >= self.depth:
            self._retire_oldest()
        ticket = self._next_ticket
        self._next_ticket += 1
        t_submit = time.perf_counter()
        host = torch.empty((layout(self.shape)[-1],), dtype=torch.float64,
                           pin_memory=self._cuda)
        pack_host(self.shape, host_fields((Q, b, A_eq, b_eq,
                                           friction_coeffs, lb, ub)), host)
        solve = self._captured(host)
        solve.buffers.inp.copy_(host, non_blocking=self._cuda)
        # the warm state chains on the device: no copy, no wait
        solve.run(warm_start=self._warm)
        self._warm = True
        out = self._ring[ticket % self.depth]
        out.copy_(solve.buffers.out, non_blocking=self._cuda)
        event = None
        if self._cuda:
            event = torch.cuda.Event()
            event.record()
        self._inflight.append((ticket, t_submit, out, event, host))
        return ticket

    # -- retire --------------------------------------------------------
    def _retire_oldest(self):
        # the one wait of the pipeline; named for `torch.profiler`, so a
        # trace shows every synchronization to lie inside a retire
        with torch.profiler.record_function("FCCQPServer.retire"):
            ticket, t_submit, out, event, _ = self._inflight.popleft()
            if event is not None:
                event.synchronize()
        v = out.numpy()
        n = self.shape.num_vars
        stats = dict(zip(STATS, v[n:].tolist()))
        fields = {k: (int(x) if k in INT_STATS else float(x))
                  for k, x in stats.items()}
        details = FCCQPDetails(
            solve_time=time.perf_counter() - t_submit,
            factorization_time=0.0, **fields)
        self._retired[ticket] = FCCQPSolution(details=details,
                                              z=v[:n].copy())

    def poll(self) -> list:
        """Every result already retired, as ``(ticket, FCCQPSolution)`` in
        ticket order; does not wait."""
        out = sorted(self._retired.items())
        self._retired.clear()
        return out

    def result(self, ticket: int) -> FCCQPSolution:
        """Wait until ``ticket``'s solve has retired and return it (once);
        an unknown or already collected ticket raises `KeyError`."""
        while ticket not in self._retired:
            if not self._inflight:
                raise KeyError(f"unknown or already-collected ticket {ticket}")
            self._retire_oldest()
        return self._retired.pop(ticket)

    def drain(self) -> list:
        """Retire every solve in flight and return all pending results."""
        while self._inflight:
            self._retire_oldest()
        return self.poll()

    # -- introspection -------------------------------------------------
    @property
    def in_flight(self) -> int:
        return len(self._inflight)

    def reset_warm_start(self):
        """Drop the carried warm state: the next submit solves cold."""
        self._warm = False
