"""Drop-in object-oriented wrapper with the reference's Python API (port
of `fcc_qp_tpu/core/api.py`).

The `FCCQP` class has the reference's method surface: constructed from
``(num_vars, num_equality_constraints, nc, lambda_c_start)``, with
`Solve`, `GetSolution`, `set_rho`, `set_max_iter`, `set_options`,
`set_warm_start` and `contact_vars_start`. It is a thin stateful shell
over the engines' static B = 1 solve (`core.graphs.CapturedSolve`): on
the card every `Solve` is one upload, a replay of the captured operator
graph and of the iteration graph, and one download, and the warm state
(the reference's persistent members) stays in the graphs' buffers on
the device. ``factorization_time`` is the operator replay's span and
``solve_time`` both replays', each read from CUDA events recorded
between the replays; on the CPU the same solve runs eagerly and the
spans are host wall times.

The first `Solve` of each option set (and, on the ds engine, of each
pattern of finite bounds) captures its graphs, which takes a fraction of
a second; `MAX_CAPTURES` of them are kept.
"""

from __future__ import annotations

import collections
import time
from typing import Optional

import numpy as np
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
from fcc_qp_tpu_torch.ops.projections import validate_bounds
from fcc_qp_tpu_torch.types import FCCQPDetails, FCCQPSolution, QPBatch

# the captures an `FCCQP` keeps, one per (options, classification): a new
# one costs a capture (`chip_smoke.py` prints each capturing `Solve`'s
# wall), so a controller cycling through more option sets or bound
# patterns than this pays it again
MAX_CAPTURES = 8


def default_dtype() -> torch.dtype:
    """The dtype `FCCQP` keeps when none is given: f64, the JAX package's
    choice wherever it runs with x64."""
    return torch.float64


class FCCQP:
    """Stateful solver with the reference's exact method surface.

    ``engine``:
      * ``"auto"`` (default): the f64 parity engine. The JAX package picks
        it wherever the device has native f64 and the double-single engine
        elsewhere (a TPU); an H100 has f64, so "auto" is "f64" here.
      * ``"f64"``: the reference's algorithm in f64 (`core.solver`), the
        full-layout ADMM kernel in one launch.
      * ``"ds"``: the batched engine on a batch of one with Ruiz scaling,
        constrained splitting, polish and operator presolve forced on; its
        ``rho`` acts in the equilibrated space (0.05 is a good value), and
        residuals are still checked in unscaled units.

    ``dtype``: accepted and kept as ``self.dtype`` (default f64), as the
    JAX class keeps its own; as there, the f64 engine solves in f64 and
    the ds engine in its own precisions whatever it says.

    ``device``: where the solves run (default CUDA; raises when there is
    no card). Inputs may be numpy arrays or tensors on any device; they
    are validated on the host and uploaded in one copy.
    """

    def __init__(self, num_vars: int, num_equality_constraints: int,
                 nc: int, lambda_c_start: int, dtype=None,
                 engine: str = "auto", device=None):
        self.shape = ProblemShape(
            num_vars=num_vars, num_eq=num_equality_constraints, nc=nc,
            lambda_c_start=lambda_c_start,
        )
        self.dtype = dtype or default_dtype()
        if engine not in ("auto", "f64", "ds"):
            raise ValueError("engine must be 'auto', 'f64', or 'ds'")
        self.engine = "f64" if engine == "auto" else engine
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        self._options = FCCQPOptions()
        self._warm_start = False
        # the warm chain lives in these buffers, shared by the captures
        # of every option set (and classification) this object solves
        self._buffers = None
        self._has_warm = False
        self._captures: collections.OrderedDict = collections.OrderedDict()
        n_in, n_out = layout(self.shape)[-1], num_vars + len(STATS)
        self._host_in = torch.empty((n_in,), dtype=torch.float64,
                                    pin_memory=self._cuda)
        self._host_out = torch.empty((n_out,), dtype=torch.float64,
                                     pin_memory=self._cuda)
        self._solution: Optional[np.ndarray] = None
        self._solve_time = 0.0
        self._factorization_time = 0.0

    # ---- option setters (the reference's) ----
    def set_rho(self, rho: float):
        if rho <= 0:
            raise ValueError("rho must be > 0")
        self._options = self._options.replace(rho=float(rho))

    def set_max_iter(self, n: int):
        if n <= 0:
            raise ValueError("max_iter must be > 0")
        self._options = self._options.replace(max_iter=int(n))

    def set_options(self, opt: FCCQPOptions):
        self._options = opt

    def set_warm_start(self, warm_start: bool):
        self._warm_start = bool(warm_start)

    def contact_vars_start(self) -> int:
        return self.shape.lambda_c_start

    @property
    def options(self) -> FCCQPOptions:
        return self._options

    # ---- solve ----
    def _validate(self, qp: QPBatch):
        """Input validation (the reference's asserts)."""
        s = self.shape
        if tuple(qp.Q.shape) != (s.num_vars, s.num_vars):
            raise ValueError(
                f"Q must be {(s.num_vars, s.num_vars)}, got "
                f"{tuple(qp.Q.shape)}")
        if tuple(qp.b.shape) != (s.num_vars,):
            raise ValueError(f"b must be ({s.num_vars},)")
        if tuple(qp.A_eq.shape) != (s.num_eq, s.num_vars):
            raise ValueError(f"A_eq must be {(s.num_eq, s.num_vars)}")
        if tuple(qp.b_eq.shape) != (s.num_eq,):
            raise ValueError(f"b_eq must be ({s.num_eq},)")
        if tuple(qp.friction_coeffs.shape) != (s.n_cones,):
            raise ValueError(f"friction_coeffs must be ({s.n_cones},)")
        if (tuple(qp.lb.shape) != (s.num_vars,)
                or tuple(qp.ub.shape) != (s.num_vars,)):
            raise ValueError(f"lb/ub must be ({s.num_vars},)")
        if not bool(validate_bounds(qp.lb, qp.ub)):
            raise ValueError("invalid bounds: lb > ub somewhere")

    def _captured(self, host: torch.Tensor) -> CapturedSolve:
        """The captured solve of the current options and (ds) of this
        problem's classification, made at its first use; the least
        recently used of more than `MAX_CAPTURES` is dropped, and with it
        its graphs' memory."""
        opts = engine_options(self._options, self.engine)
        key = (opts, classify(self.shape, self.engine, host))
        if key in self._captures:
            self._captures.move_to_end(key)
        else:
            if self._buffers is None:
                self._buffers = SolveBuffers(self.shape, self.engine,
                                             self.device, opts.rho)
            self._captures[key] = CapturedSolve(
                self.shape, opts, self.engine, self._buffers, key[1])
            if len(self._captures) > MAX_CAPTURES:
                self._captures.popitem(last=False)
        return self._captures[key]

    def Solve(self, Q, b, A_eq, b_eq, friction_coeffs, lb, ub):
        fields = host_fields((Q, b, A_eq, b_eq, friction_coeffs, lb, ub))
        self._validate(QPBatch(*(torch.from_numpy(a) for a in fields)))
        pack_host(self.shape, fields, self._host_in)
        solve = self._captured(self._host_in)
        solve.buffers.inp.copy_(self._host_in, non_blocking=self._cuda)
        warm_start = self._warm_start and self._has_warm
        if self._cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            solve.run(warm_start, between=ev[1].record)
            ev[2].record()
            self._host_out.copy_(solve.buffers.out, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record()
            copied.synchronize()
            self._factorization_time = ev[0].elapsed_time(ev[1]) * 1e-3
            self._solve_time = ev[0].elapsed_time(ev[2]) * 1e-3
        else:
            t = [time.perf_counter()]
            solve.run(warm_start,
                      between=lambda: t.append(time.perf_counter()))
            self._host_out.copy_(solve.buffers.out)
            t.append(time.perf_counter())
            self._factorization_time = t[1] - t[0]
            self._solve_time = t[2] - t[0]
        self._has_warm = True
        self._solution = self._host_out.numpy().copy()

    def GetSolution(self) -> FCCQPSolution:
        """The last solve's result as host types: Python numbers in the
        details and a numpy ``z`` of shape (n,)."""
        if self._solution is None:
            raise RuntimeError("call Solve() first")
        n = self.shape.num_vars
        v = self._solution
        fields = {k: (int(x) if k in INT_STATS else float(x))
                  for k, x in zip(STATS, v[n:].tolist())}
        return FCCQPSolution(
            details=FCCQPDetails(solve_time=self._solve_time,
                                 factorization_time=self._factorization_time,
                                 **fields),
            z=v[:n].copy())
