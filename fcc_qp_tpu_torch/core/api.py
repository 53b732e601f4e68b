"""Drop-in object-oriented wrapper with the reference's Python API (port
of `fcc_qp_tpu/core/api.py`).

The `FCCQP` class has the reference's method surface: constructed from
``(num_vars, num_equality_constraints, nc, lambda_c_start)``, with
`Solve`, `GetSolution`, `set_rho`, `set_max_iter`, `set_options`,
`set_warm_start` and `contact_vars_start`. It is a thin stateful shell
over the functional engines: it owns the warm state (the reference's
persistent members) and measures wall-clock ``solve_time`` /
``factorization_time`` with device synchronizes.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from fcc_qp_tpu_torch.config import FCCQPOptions, ProblemShape
from fcc_qp_tpu_torch.core.ds_engine import (
    QPBatchDS,
    resolve_device,
    solve_batched_ds,
)
from fcc_qp_tpu_torch.core.solver import _solve_core
from fcc_qp_tpu_torch.ops.kkt import admm_operator
from fcc_qp_tpu_torch.ops.projections import validate_bounds
from fcc_qp_tpu_torch.types import FCCQPDetails, FCCQPSolution, QPBatch
from fcc_qp_tpu_torch.utils.timing import sync


class FCCQP:
    """Stateful solver with the reference's exact method surface.

    ``engine``:
      * ``"auto"`` (default): the f64 parity engine. The JAX package picks
        it wherever the device has native f64 and the double-single engine
        elsewhere (a TPU); an H100 has f64, so "auto" is "f64" here.
      * ``"f64"``: the reference's algorithm in f64 (`core.solver`), the
        full-layout ADMM kernel in chunks.
      * ``"ds"``: the batched engine on a batch of one with Ruiz scaling,
        constrained splitting, polish and operator presolve forced on; its
        ``rho`` acts in the equilibrated space (0.05 is a good value), and
        residuals are still checked in unscaled units.

    ``dtype``: accepted and kept as ``self.dtype`` (default f64), as the
    JAX class keeps its own; as there, the f64 engine solves in f64 and
    the ds engine in its own precisions whatever it says.

    ``device``: where the solves run (default CUDA; raises when there is
    no card). Inputs may be numpy arrays or tensors on any device.
    """

    def __init__(self, num_vars: int, num_equality_constraints: int,
                 nc: int, lambda_c_start: int, dtype=None,
                 engine: str = "auto", device=None):
        self.shape = ProblemShape(
            num_vars=num_vars, num_eq=num_equality_constraints, nc=nc,
            lambda_c_start=lambda_c_start,
        )
        self.dtype = dtype or torch.float64
        if engine not in ("auto", "f64", "ds"):
            raise ValueError("engine must be 'auto', 'f64', or 'ds'")
        self.engine = "f64" if engine == "auto" else engine
        self.device = resolve_device(device)
        self._options = FCCQPOptions()
        self._warm_start = False
        self._warm = None
        self._solution: Optional[FCCQPSolution] = None
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

    def Solve(self, Q, b, A_eq, b_eq, friction_coeffs, lb, ub):
        t = lambda a: torch.as_tensor(np.asarray(a, np.float64)
                                      if not isinstance(a, torch.Tensor)
                                      else a).to(self.device, torch.float64)
        qp = QPBatch(Q=t(Q), b=t(b), A_eq=t(A_eq), b_eq=t(b_eq),
                     friction_coeffs=t(friction_coeffs), lb=t(lb), ub=t(ub))
        self._validate(qp)
        warm_start = self._warm_start and self._warm is not None
        warm = self._warm if warm_start else None
        if self.engine == "ds":
            return self._solve_ds(qp, warm, warm_start)

        # the operator is built once, passed into the solve, and its span
        # is the factorization time; solve_time is the whole Solve
        qp1 = QPBatch(*(a[None] for a in qp.__dict__.values()))
        sync(self.device)
        t0 = time.perf_counter()
        operator = admm_operator(qp1.Q, qp1.b, qp1.A_eq, qp1.b_eq,
                                 self._options.rho)
        sync(self.device)
        t1 = time.perf_counter()
        sol, new_warm = _solve_core(qp1, self.shape, self._options, warm,
                                    warm_start, operator)
        sync(self.device)
        t2 = time.perf_counter()
        self._factorization_time = t1 - t0
        self._solve_time = t2 - t0
        self._warm = new_warm
        self._solution = sol

    def _solve_ds(self, qp: QPBatch, warm, warm_start: bool):
        """The batched engine on a batch of one, with scaling, constrained
        splitting, polish and operator presolve forced on: they keep the
        reference's solution and tolerance contract (tolerances checked
        in unscaled units; the polish validates itself)."""
        # batch-last with B = 1
        qpds = QPBatchDS(*(v[..., None].contiguous()
                           for v in qp.__dict__.values()))
        opts_ds = self._options.replace(
            scaling=True, splitting="constrained", polish=True,
            presolve="operator",
        )
        sol, new_warm = solve_batched_ds(
            qpds, self.shape, opts_ds, warm=warm, warm_start=warm_start,
            device=self.device,
        )
        self._solve_time = float(sol.details.solve_time[0])
        self._factorization_time = float(sol.details.factorization_time[0])
        self._warm = new_warm
        self._solution = sol

    def GetSolution(self) -> FCCQPSolution:
        """The last solve's result as host types: Python numbers in the
        details and a numpy ``z`` of shape (n,)."""
        if self._solution is None:
            raise RuntimeError("call Solve() first")
        d = self._solution.details
        one = lambda v, kind: kind(v.reshape(-1)[0].item())
        ints = ("n_iter", "solve_status", "n_iter_f32", "n_iter_ds",
                "polish_attempts", "polish_accepted")
        fields = {k: one(v, int if k in ints else float)
                  for k, v in d.__dict__.items()}
        fields.update(solve_time=self._solve_time,
                      factorization_time=self._factorization_time)
        z = self._solution.z.reshape(-1, self.shape.num_vars)[0]
        return FCCQPSolution(details=FCCQPDetails(**fields),
                             z=z.cpu().numpy())
