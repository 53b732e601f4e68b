"""Static configuration: solver options and problem shape.

Port of `fcc_qp_tpu/config.py`: the same fields, defaults and
validation, so an options object built for one package describes the
same solve in the other. `FCCQPOptions` mirrors the reference FCCQP
options struct (the first four fields) plus the acceleration features
documented field by field in the JAX package; `ProblemShape` mirrors the
reference constructor arguments.

Every option is implemented by the engine that takes it (the f64
parity engine, like the JAX package's, ignores the acceleration
options: ``alpha``, adaptive rho, scaling, splitting and polish).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FCCQPOptions:
    """Solver options; see `fcc_qp_tpu.config.FCCQPOptions` for the
    meaning of every field. The first four fields and their defaults
    match the reference struct; every other field defaults to off or
    neutral, so the default behaviour is the reference's."""

    max_iter: int = 1000
    rho: float = 1e-6
    eps_fcone: float = 1e-3
    eps_bound: float = 1e-6
    alpha: float = 1.0
    adaptive_rho: bool = False
    adaptive_rho_interval: int = 25
    adaptive_rho_tolerance: float = 2.0
    adaptive_rho_max_adaptations: int = 8
    rho_min: float = 1e-6
    rho_max: float = 1e6
    presolve: str = "exact"  # "exact" (reference parity) | "operator"
    scaling: bool = False
    scaling_iters: int = 8
    splitting: str = "full"  # "full" (reference parity) | "constrained"
    kkt_refine_steps: int = 1
    kkt_factor: str = "hybrid"  # "hybrid" (f32 seed + f64 refine) | "ds"
    phase1_tol: float = 0.0
    polish: bool = False
    polish_tol: float = 1e-2
    polish_act_tol: float = 1e-3
    polish_newton_steps: int = 4
    polish_rounds: int = 1
    polish_interval: int = 64
    # Defer the exact operator build until after the polish (hybrid
    # factorization + polish only; see `core.ds_engine._lazy_exact`).
    lazy_exact: bool = True

    def __post_init__(self):
        if self.max_iter <= 0:
            raise ValueError("max_iter must be > 0")
        if self.rho <= 0:
            raise ValueError("rho must be > 0")
        if not (0.0 < self.alpha < 2.0):
            raise ValueError("alpha must be in (0, 2)")
        if self.adaptive_rho_interval <= 0:
            raise ValueError("adaptive_rho_interval must be > 0")
        if self.adaptive_rho_tolerance < 1.0:
            raise ValueError("adaptive_rho_tolerance must be >= 1")
        if self.presolve not in ("exact", "operator"):
            raise ValueError("presolve must be 'exact' or 'operator'")
        if self.splitting not in ("full", "constrained"):
            raise ValueError("splitting must be 'full' or 'constrained'")
        if self.scaling_iters <= 0:
            raise ValueError("scaling_iters must be > 0")
        if self.kkt_refine_steps < 0:
            raise ValueError("kkt_refine_steps must be >= 0")
        if self.kkt_factor not in ("hybrid", "ds"):
            raise ValueError("kkt_factor must be 'hybrid' or 'ds'")
        if self.phase1_tol < 0:
            raise ValueError("phase1_tol must be >= 0")
        if self.polish_tol <= 0 or self.polish_act_tol <= 0:
            raise ValueError("polish tolerances must be > 0")
        if self.polish_newton_steps < 1:
            raise ValueError("polish_newton_steps must be >= 1")
        if self.polish_rounds < 1:
            raise ValueError("polish_rounds must be >= 1")
        if self.polish_interval < 1:
            raise ValueError("polish_interval must be >= 1")

    def replace(self, **kw) -> "FCCQPOptions":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ProblemShape:
    """Fixed problem shape (the reference constructor's arguments).

    Attributes:
      num_vars: total decision variables (n).
      num_eq: rows of A_eq (m).
      nc: number of contact-force variables; multiple of 3.
      lambda_c_start: index of the first contact-force variable; the
        contact forces are ``x[lambda_c_start : lambda_c_start + nc]``.
    """

    num_vars: int
    num_eq: int
    nc: int
    lambda_c_start: int

    def __post_init__(self):
        if self.num_vars < 0 or self.num_eq < 0 or self.nc < 0:
            raise ValueError("dimensions must be non-negative")
        if self.nc % 3 != 0:
            raise ValueError("nc must be a multiple of 3")
        if self.lambda_c_start + self.nc > self.num_vars:
            raise ValueError("contact segment exceeds num_vars")

    @property
    def n_cones(self) -> int:
        return self.nc // 3

    @property
    def kkt_dim(self) -> int:
        return self.num_vars + self.num_eq


# Canonical robot shapes (see fcc_qp_tpu_torch.models.osc).
CASSIE_SHAPE = ProblemShape(num_vars=60, num_eq=38, nc=12, lambda_c_start=38)
