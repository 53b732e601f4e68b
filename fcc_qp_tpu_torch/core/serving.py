"""Pipelined serving for the drop-in API (port of
`fcc_qp_tpu/core/serving.py`).

A control loop submits one QP per tick and reads results some ticks
later. `FCCQPServer` keeps up to ``depth`` warm-chained solves in flight:
solve t+1 is queued against the warm state that solve t leaves on the
device, and the host waits only when it retires a result, ``depth``
solves behind the submission front. Results retire in submission order.

The transport, in CUDA terms (the JAX package packs for its tunnel
instead):

* per submit, the seven QP fields go into one pinned host buffer and
  cross to the device in one ``non_blocking`` copy on the current
  stream; the solve reads them as views of that one device buffer;
* per retire, the solution and every diagnostic were packed on the device
  into one f64 vector when the solve was queued, copied to a pinned host
  buffer in one ``non_blocking`` copy behind an event; retiring waits on
  that event;
* the warm state never leaves the device.

Whether depth > 1 overlaps anything depends on the engine: a solve that
reads the device in its loop (the chunk loops' convergence tests, the ds
engine's polish) blocks the host there, and the next submit waits for it.

    server = FCCQPServer(shape, opts, depth=4)
    for qp in control_loop:
        t = server.submit(**qp)        # one upload
        done = server.poll()           # retired (ticket, FCCQPSolution)
    for t, sol in server.drain(): ...  # flush the tail

`submit` / `result` have the semantics of `FCCQP.Solve` /
`GetSolution` in the reference's replay loop: the first submit is cold,
every later one warm (``set_warm_start(i > 0)``).
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from fcc_qp_tpu_torch.config import FCCQPOptions, ProblemShape
from fcc_qp_tpu_torch.core.ds_engine import (
    QPBatchDS,
    _solve_ds_reduced,
    constrained_indices,
    resolve_device,
)
from fcc_qp_tpu_torch.core.solver import _solve_core
from fcc_qp_tpu_torch.types import FCCQPDetails, FCCQPSolution, QPBatch

# the packed result: the n solution words, then these diagnostics
_STATS = ("n_iter", "solve_status", "admm_residual_bounds",
          "admm_residual_friction_cone", "bounds_viol", "friction_cone_viol",
          "equality_viol", "n_iter_f32", "n_iter_ds", "polish_attempts",
          "polish_accepted")
_INT_STATS = ("n_iter", "solve_status", "n_iter_f32", "n_iter_ds",
              "polish_attempts", "polish_accepted")


def _layout(shape: ProblemShape):
    """Field offsets of the packed QP: Q, b, A_eq, b_eq, friction_coeffs,
    lb, ub."""
    n, m, k = shape.num_vars, shape.num_eq, shape.n_cones
    sizes = (n * n, n, m * n, m, k, n, n)
    return tuple(int(o) for o in np.cumsum((0,) + sizes))


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
        no card).
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
        self._opts = (
            opts.replace(scaling=True, splitting="constrained", polish=True,
                         presolve="operator")
            if engine == "ds" else opts
        )
        self._offs = _layout(shape)
        self._cuda = self.device.type == "cuda"
        self._warm = None
        self._con_idx = None
        self._next_ticket = 0
        # in flight: (ticket, submit time, packed result on the host, its
        # event, the pinned upload buffer kept alive until the copy ran)
        self._inflight: collections.deque = collections.deque()
        self._retired: dict[int, FCCQPSolution] = {}

    # -- dispatch ------------------------------------------------------
    def _upload(self, fields):
        """The seven fields in one host buffer (pinned on CUDA) and one
        copy to the device; returns (device buffer, host buffer)."""
        host = torch.empty((self._offs[-1],), dtype=torch.float64,
                           pin_memory=self._cuda)
        h = host.numpy()
        for a, lo, hi in zip(fields, self._offs[:-1], self._offs[1:]):
            if isinstance(a, torch.Tensor):
                a = a.detach().cpu().numpy()
            h[lo:hi] = np.asarray(a, np.float64).reshape(-1)
        dev = host.to(self.device, non_blocking=True) if self._cuda else host
        return dev, host

    def _views(self, buf, batch_last: bool):
        """The QP as views of the device buffer, a batch of one."""
        s = self.shape
        n, m, k = s.num_vars, s.num_eq, s.n_cones
        dims = ((n, n), (n,), (m, n), (m,), (k,), (n,), (n,))
        offs = self._offs
        out = []
        for i, d in enumerate(dims):
            v = buf[offs[i]:offs[i + 1]]
            out.append(v.view(*d, 1) if batch_last else v.view(1, *d))
        return out

    def _solve(self, buf):
        warm_start = self._warm is not None
        if self.engine == "ds":
            qp = QPBatchDS(*self._views(buf, batch_last=True))
            if self._con_idx is None:
                # classified once, from the first problem (the stream's
                # shape and bound pattern are fixed, as the reference's are)
                self._con_idx = constrained_indices(
                    qp, self.shape, full=self._opts.splitting == "full")
            sol, warm = _solve_ds_reduced(
                qp, self._warm, self.shape, self._opts, warm_start,
                self._con_idx)
        else:
            qp = QPBatch(*self._views(buf, batch_last=False))
            sol, warm = _solve_core(qp, self.shape, self._opts, self._warm,
                                    warm_start)
        # the warm handle chains on the device: no copy, no wait
        self._warm = warm
        d = sol.details
        packed = torch.cat([
            sol.z.reshape(-1).to(torch.float64),
            torch.stack([getattr(d, k).reshape(-1)[0].to(torch.float64)
                         for k in _STATS]),
        ])
        out = torch.empty(packed.shape, dtype=torch.float64,
                          pin_memory=self._cuda)
        out.copy_(packed, non_blocking=self._cuda)
        event = None
        if self._cuda:
            event = torch.cuda.Event()
            event.record()
        return out, event

    def submit(self, Q, b, A_eq, b_eq, friction_coeffs, lb, ub) -> int:
        """Queue one warm-chained solve; returns its ticket. Retires the
        oldest first when ``depth`` solves are in flight."""
        while len(self._inflight) >= self.depth:
            self._retire_oldest()
        ticket = self._next_ticket
        self._next_ticket += 1
        t_submit = time.perf_counter()
        buf, host_in = self._upload((Q, b, A_eq, b_eq, friction_coeffs, lb,
                                     ub))
        out, event = self._solve(buf)
        self._inflight.append((ticket, t_submit, out, event, host_in))
        return ticket

    # -- retire --------------------------------------------------------
    def _retire_oldest(self):
        ticket, t_submit, out, event, _ = self._inflight.popleft()
        if event is not None:
            event.synchronize()
        v = out.numpy()
        n = self.shape.num_vars
        stats = dict(zip(_STATS, v[n:].tolist()))
        fields = {k: (int(x) if k in _INT_STATS else float(x))
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
        self._warm = None
