"""Problem, warm-state and result types (port of `fcc_qp_tpu/types.py`).

  * `QPBatch`          <- the seven arguments of the reference's Solve
  * `WarmStart`        <- the reference's persistent primal and duals
  * `FCCQPSolveStatus` <- the reference status enum, plus
    ``kFactorizationFailed``
  * `FCCQPDetails`     <- the reference details struct, plus the
    equality residual and the per-phase telemetry of the JAX package
  * `FCCQPSolution`    <- the reference solution struct

The JAX package registers these as pytrees; here they are plain frozen
dataclasses of tensors. Every tensor field is batch-LEADING: ``(B,)``
for the details and ``(B, n)`` for ``z``; `QPBatch` and `WarmStart` take
any leading batch shape (none for a single instance).
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch


class FCCQPSolveStatus(enum.IntEnum):
    kSuccess = 0
    kMaxIterations = 1
    # Extension beyond the reference enum: an instance whose final
    # primal is equality-infeasible (see `FCCQPDetails.equality_viol`)
    # can only come from a broken factorization chain, so it never reads
    # kSuccess.
    kFactorizationFailed = 2


@dataclasses.dataclass(frozen=True)
class QPBatch:
    """One QP (or a batch of QPs) in stacked dense form, batch-leading:
    Q (..., n, n), b (..., n), A_eq (..., m, n), b_eq (..., m),
    friction_coeffs (..., nc/3), lb / ub (..., n)."""

    Q: torch.Tensor
    b: torch.Tensor
    A_eq: torch.Tensor
    b_eq: torch.Tensor
    friction_coeffs: torch.Tensor
    lb: torch.Tensor
    ub: torch.Tensor

    def to(self, *args, **kw) -> "QPBatch":
        """`torch.Tensor.to` applied to every field."""
        return QPBatch(*(getattr(self, f.name).to(*args, **kw)
                         for f in dataclasses.fields(self)))

    @property
    def batch_shape(self) -> torch.Size:
        return self.b.shape[:-1]

    def astype(self, dtype) -> "QPBatch":
        """Every field cast to ``dtype``."""
        return self.to(dtype=dtype)


@dataclasses.dataclass(frozen=True)
class WarmStart:
    """ADMM state persisting across solves of the f64 parity engine
    (primal and scaled duals), batch-leading."""

    x: torch.Tensor
    mu_x: torch.Tensor
    mu_lambda_c: torch.Tensor

    @staticmethod
    def zeros(shape, batch_shape=(), dtype=torch.float64,
              device="cpu") -> "WarmStart":
        z = lambda k: torch.zeros((*batch_shape, k), dtype=dtype,
                                  device=device)
        return WarmStart(x=z(shape.num_vars), mu_x=z(shape.num_vars),
                         mu_lambda_c=z(shape.nc))

    def to(self, *args, **kw) -> "WarmStart":
        return WarmStart(self.x.to(*args, **kw), self.mu_x.to(*args, **kw),
                         self.mu_lambda_c.to(*args, **kw))


@dataclasses.dataclass(frozen=True)
class FCCQPDetails:
    """Per-solve diagnostics, one entry per instance. Field names match
    the reference struct; ``eps_bounds`` / ``eps_friction_cone`` are the
    reference Python binding's aliases of the residuals."""

    n_iter: torch.Tensor
    admm_residual_bounds: torch.Tensor
    admm_residual_friction_cone: torch.Tensor
    solve_time: torch.Tensor
    factorization_time: torch.Tensor
    bounds_viol: torch.Tensor
    friction_cone_viol: torch.Tensor
    solve_status: torch.Tensor  # int32; values from FCCQPSolveStatus
    # ``max_i |A_eq x - b_eq|_i`` in unscaled units.
    equality_viol: torch.Tensor
    # per-phase telemetry:
    #   n_iter_f32:      plain-f32 approach + polish-round iterations
    #   n_iter_ds:       high-precision (f64 here) endgame iterations
    #   polish_attempts: polish attempts run for this instance
    #   polish_accepted: 1 if the final point came from an accepted polish
    n_iter_f32: torch.Tensor
    n_iter_ds: torch.Tensor
    polish_attempts: torch.Tensor
    polish_accepted: torch.Tensor

    @property
    def eps_bounds(self):
        return self.admm_residual_bounds

    @property
    def eps_friction_cone(self):
        return self.admm_residual_friction_cone


@dataclasses.dataclass(frozen=True)
class FCCQPSolution:
    details: FCCQPDetails
    z: torch.Tensor  # (B, n) f64


def stack_qps(qps, device=None) -> QPBatch:
    """Stack single-instance `QPBatch`es (or dicts of the reference's npz
    schema: ``Q, b, A_eq, b_eq, friction_coeffs, lb, ub``, numpy arrays
    or tensors) into one batch-leading `QPBatch` on ``device`` (default
    CUDA; raises when there is no card), each field in its given
    dtype."""
    from fcc_qp_tpu_torch.core.ds_engine import resolve_device

    dev = resolve_device(device)
    names = [f.name for f in dataclasses.fields(QPBatch)]
    rows = [[getattr(q, k) if isinstance(q, QPBatch) else q[k]
             for k in names] for q in qps]
    tensor = lambda a: (a if isinstance(a, torch.Tensor)
                        else torch.from_numpy(np.asarray(a)))
    return QPBatch(*(torch.stack([tensor(r[i]).to(dev) for r in rows])
                     for i in range(len(names))))
