"""Structured whole-body-control (OSC / inverse-dynamics) QP generators.

Numpy copy of `fcc_qp_tpu/models/osc.py` (the port imports nothing of
the JAX package): for the same arguments and seed both return identical
arrays. The reference's only "model" is the Cassie OSC problem shape of
its benchmark: decision variables ``x = [vdot, u, lambda_h, lambda_c,
slack]`` with ``n_vars=60, n_eq=38, nc=12, lambda_c_start=38``, solved
against a logged walking sequence. This module regenerates equivalent
data synthetically and generalizes it to a family of robot models.

Problem structure (paper `fccqp.pdf` eq. (10)):

  cost       || J_t vdot + Jdot_t_v - yddot_des ||^2_W
             + w_u ||u||^2 + w_l ||lambda||^2 + w_s ||slack||^2
  dynamics   M vdot - B u - J_h^T lambda_h - J_c^T lambda_c = -C   (nv rows)
  holonomic  J_h vdot = -Jdot_h_v                                  (nh rows)
  contact    J_cr vdot + slack = -Jdot_cr_v                        (ncr rows)
  bounds     u in [-u_max, u_max]; everything else unbounded
  cones      lambda_c in product of friction cones

Physical realism matters for solver behavior: the bias force C is built
from *desired contact forces* that follow a stance/swing gait (normal
force positive in stance, tangential near a controllable fraction of the
friction-cone boundary), so the equality-QP optimum has contact forces
that are mostly cone-interior with episodes of boundary activity — the
regime in which the reference converges in O(10) warm-started iterations
(paper Table 1: max_iter=15 suffices on hardware). Actuator bounds are
calibrated from the unconstrained optimum so a controllable fraction of
them is active.

Sequences vary smoothly in time (low-pass random walks + a periodic gait
phase) so that warm starting behaves like the real walking log. All
generation is NumPy on the host — data then ships to the device as one
stacked batch (`core.ds_engine.to_ds_batch`).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from fcc_qp_tpu_torch.config import ProblemShape


@dataclasses.dataclass(frozen=True)
class RobotModel:
    """Dimensions of a WBC QP family.

    n_vars = nv_dof + nu + nh + nc + n_slack; contact forces are the
    contiguous segment starting at lambda_c_start (matching the Cassie
    slicing at `fcc_qp_test.py:52-56`).
    """

    name: str
    nv_dof: int   # generalized-velocity dims (vdot vars)
    nu: int       # actuators
    nh: int       # holonomic constraint forces (lambda_h)
    nc: int       # contact force vars (3 per cone)
    nc_rows: int  # contact-constraint rows in A_eq
    n_slack: int = 0  # soft-contact slack vars appended after lambda_c
    mu: float = 0.8
    # recommended PDAS re-linearization depth for the flagship engine
    # on this model's geometry (the analog of per-robot solver tuning a
    # reference user does via FCCQPOptions): quadruped point-feet cold
    # states misclassify more cone rows at the coarse point and need
    # deeper continuation for 100% convergence at 1e-6 (measured r4/r5:
    # ns=4 -> 97.6% cold, ns=6 -> 100%); cassie/humanoid reach 100% at
    # the cheaper 4. bench.py and the scaling sweep default to this.
    polish_newton_steps: int = 4

    @property
    def shape(self) -> ProblemShape:
        return ProblemShape(
            num_vars=self.nv_dof + self.nu + self.nh + self.nc + self.n_slack,
            num_eq=self.nv_dof + self.nh + self.nc_rows,
            nc=self.nc,
            lambda_c_start=self.nv_dof + self.nu + self.nh,
        )


# Cassie biped: 22 vdot + 10 u + 6 lambda_h + 12 lambda_c + 10 soft-contact
# slacks = 60 vars; 22 dynamics + 6 holonomic + 10 contact rows = 38
# equality rows -- exactly the reference benchmark dims
# (`fcc_qp_test.py:52-56,77`: nc=12 at lambda_c_start=38 inside 60 vars
# implies 10 trailing non-contact variables).
CASSIE = RobotModel("cassie", nv_dof=22, nu=10, nh=6, nc=12, nc_rows=10,
                    n_slack=10)

# Quadruped (A1/Go1-class): 18 dof, 12 actuators, 4 point feet.
QUADRUPED = RobotModel("quadruped", nv_dof=18, nu=12, nh=0, nc=12,
                       nc_rows=12, polish_newton_steps=6)

# Humanoid (Digit/H1-class): bigger KKT system, 8 contact cones
# (4-vertex patch per foot).
HUMANOID = RobotModel("humanoid", nv_dof=29, nu=23, nh=0, nc=24, nc_rows=12)

MODELS = {m.name: m for m in (CASSIE, QUADRUPED, HUMANOID)}


class _SmoothWalk:
    """Low-pass random walk: x_{t+1} = (1-a) x_t + a * noise.

    Initialized AT the stationary distribution (std = scale *
    sqrt(a/(2-a))), not at the noise scale: a full-scale start is
    sqrt(2/a) times the stationary std (32x at a=0.002), and the
    resulting decay transient produced ~200 genuinely INFEASIBLE
    quadruped QPs at the head of every generated log (oversized bias
    forces vs torque bounds calibrated on the stationary tail) —
    observed r5 as a 97.55% cold convergence floor no solver setting
    could move. A real control log has no such warm-up artifact."""

    def __init__(self, rng, shape, alpha=0.15, scale=1.0):
        self.rng = rng
        self.alpha = alpha
        self.scale = scale
        self.x = (
            rng.normal(size=shape)
            * scale
            * np.sqrt(alpha / (2.0 - alpha))
        )

    def step(self):
        self.x = (1 - self.alpha) * self.x + self.alpha * self.rng.normal(
            size=self.x.shape
        ) * self.scale
        return self.x


def _spd(rng, n, cond=30.0):
    """Random SPD matrix with bounded condition number."""
    U, _ = np.linalg.qr(rng.normal(size=(n, n)))
    eigs = np.exp(rng.uniform(0, np.log(cond), size=n))
    return (U * eigs) @ U.T


def _equality_solve(Q, b, A, beq):
    """Host-side equality-QP KKT solve used to calibrate bounds."""
    n = Q.shape[0]
    m = A.shape[0]
    M = np.zeros((n + m, n + m))
    M[:n, :n] = Q
    M[:n, n:] = A.T
    M[n:, :n] = A
    rhs = np.concatenate([-b, beq])
    try:
        return np.linalg.solve(M, rhs)[:n]
    except np.linalg.LinAlgError:
        return np.linalg.lstsq(M, rhs, rcond=None)[0][:n]


def generate_osc_sequence(
    model: RobotModel,
    T: int,
    seed: int = 0,
    gait_period: int = 400,
    w_u: float = 1e-3,
    w_l: float = 1e-2,
    w_slack: float = 1e2,
    smoothness: float = 0.05,
    f_normal: float = 400.0,
    cone_activity: float = 0.5,
    bound_quantile: float = 0.9,
):
    """Generate a length-T smoothly-varying, physically-plausible OSC
    QP sequence.

    Args:
      model: robot dimensions.
      T: sequence length.
      gait_period: steps per gait cycle (2 kHz log of ~0.2 s steps -> 400).
      w_u, w_l, w_slack: cost weights for actuators, forces, slacks.
      smoothness: per-step innovation rate of the random-walk drivers.
      f_normal: nominal stance normal force per cone (N).
      cone_activity: fraction of the friction-cone boundary the desired
        tangential force reaches at peak (>1 -> infeasible desired force,
        guaranteeing boundary activity).
      bound_quantile: actuator bounds are set at this quantile of |u*| of
        the unconstrained solution, so ~(1-q) of entries are active.

    Returns a list of dicts with the exact npz schema the reference
    replay expects (`fcc_qp_test.py:28-30`):
    keys ``Q, b, A_eq, b_eq, friction_coeffs, lb, ub``.
    """
    rng = np.random.default_rng(seed)
    nv, nu, nh, nc, ncr = model.nv_dof, model.nu, model.nh, model.nc, model.nc_rows
    nsl = model.n_slack
    n = model.shape.num_vars
    n_cones = nc // 3

    # Fixed robot structure
    M0 = _spd(rng, nv, cond=50.0)
    B = np.zeros((nv, nu))
    B[nv - nu :, :] = np.eye(nu)  # actuated joints are the trailing dofs
    Jh0 = rng.normal(size=(nh, nv)) if nh else np.zeros((0, nv))
    Jc0 = rng.normal(size=(nc, nv))
    n_task = min(nv, 12)
    Jt0 = rng.normal(size=(n_task, nv))
    W_task = np.diag(np.exp(rng.uniform(0, 2, size=n_task)))

    # Smooth drivers. `smoothness` scales the per-step innovation rate:
    # a real 2 kHz control log changes ~0.1% per step.
    a = smoothness
    dM = _SmoothWalk(rng, (nv, nv), alpha=0.4 * a, scale=0.02)
    dJh = _SmoothWalk(rng, Jh0.shape, alpha=0.5 * a, scale=0.05) if nh else None
    dJc = _SmoothWalk(rng, Jc0.shape, alpha=0.5 * a, scale=0.05)
    dJt = _SmoothWalk(rng, Jt0.shape, alpha=0.5 * a, scale=0.05)
    dydd = _SmoothWalk(rng, (n_task,), alpha=a, scale=1.0)
    dC = _SmoothWalk(rng, (nv,), alpha=a, scale=1.0)
    dbias_h = _SmoothWalk(rng, (nh,), alpha=a, scale=0.2) if nh else None
    dbias_c = _SmoothWalk(rng, (ncr,), alpha=a, scale=0.2)
    # slowly-rotating tangential force directions, one per cone
    dtan = _SmoothWalk(rng, (n_cones, 2), alpha=0.5 * a, scale=1.0)

    raw = []
    for t in range(T):
        phase = 2 * np.pi * t / gait_period
        Mt = M0 + dM.step()
        Mt = 0.5 * (Mt + Mt.T) + 1e-3 * np.eye(nv)
        Jh = Jh0 + (dJh.step() if nh else 0)
        Jc = Jc0 + dJc.step()
        Jt = Jt0 + dJt.step()
        yddot = dydd.step() + 3.0 * np.array(
            [np.sin(phase + k) for k in range(n_task)]
        )

        # Desired stance/swing contact forces: alternating-leg gait.
        # fz: smooth stance profile, zero in swing; fxy: a gait-varying
        # fraction of the cone boundary mu*fz.
        f_des = np.zeros(nc)
        tan = dtan.step()
        for i in range(n_cones):
            leg_phase = phase + np.pi * (i % 2)  # alternate legs
            stance = max(0.0, np.sin(leg_phase)) ** 0.7
            fz = f_normal * stance
            frac = cone_activity * (0.5 + 0.5 * np.sin(0.5 * phase + i))
            d = tan[i] / (np.linalg.norm(tan[i]) + 1e-9)
            f_des[3 * i : 3 * i + 2] = frac * model.mu * fz * d
            f_des[3 * i + 2] = fz

        # Bias force consistent with the desired contact forces (so the
        # equality optimum carries physical, mostly-positive normal
        # forces), plus noise.
        C = Jc.T @ f_des + dC.step() * np.sqrt(f_normal)

        Jcr = Jc[:ncr]

        # Cost
        Q = np.zeros((n, n))
        Q[:nv, :nv] = Jt.T @ W_task @ Jt + 1e-6 * np.eye(nv)
        Q[nv : nv + nu, nv : nv + nu] = w_u * np.eye(nu)
        Q[nv + nu : nv + nu + nh + nc, nv + nu : nv + nu + nh + nc] = (
            w_l * np.eye(nh + nc)
        )
        if nsl:
            Q[nv + nu + nh + nc :, nv + nu + nh + nc :] = w_slack * np.eye(nsl)
        b = np.zeros(n)
        b[:nv] = -Jt.T @ W_task @ yddot
        # force tracking: w_l ||lambda_c - f_des||^2 anchors the optimum
        # near the (mostly cone-interior) desired gait forces, giving the
        # mild boundary activity seen in real walking logs.
        b[nv + nu + nh : nv + nu + nh + nc] = -w_l * f_des

        # Equality constraints
        m = model.shape.num_eq
        A = np.zeros((m, n))
        beq = np.zeros(m)
        A[:nv, :nv] = Mt
        A[:nv, nv : nv + nu] = -B
        if nh:
            A[:nv, nv + nu : nv + nu + nh] = -Jh.T
        A[:nv, nv + nu + nh : nv + nu + nh + nc] = -Jc.T
        beq[:nv] = -C
        if nh:
            A[nv : nv + nh, :nv] = Jh
            beq[nv : nv + nh] = -dbias_h.step()
        # contact rows, with slack coupling when the model has soft
        # contact constraints: J_cr vdot + s = -Jdot_cr_v
        A[nv + nh :, :nv] = Jcr
        if nsl:
            A[nv + nh :, nv + nu + nh + nc :] = np.eye(ncr, nsl)
        beq[nv + nh :] = -dbias_c.step()

        raw.append((Q, b, A, beq))

    # Calibrate actuator bounds from the unconstrained optima so the box
    # constraint is mildly active (like real torque limits in walking).
    u_stars = np.stack(
        [_equality_solve(Q, b, A, beq)[nv : nv + nu] for Q, b, A, beq in raw]
    )
    # Pool the quantile over time AND actuators so the rule also works
    # for T=1 (domain-randomized batches), where a per-actuator quantile
    # would place every bound exactly at the optimum.
    u_max = np.quantile(np.abs(u_stars), bound_quantile) * np.ones(nu)
    u_max = np.maximum(u_max, 1e-3)

    qps = []
    for Q, b, A, beq in raw:
        lb = np.full(n, -np.inf)
        ub = np.full(n, np.inf)
        lb[nv : nv + nu] = -u_max
        ub[nv : nv + nu] = u_max
        qps.append(
            dict(
                Q=Q,
                b=b,
                A_eq=A,
                b_eq=beq,
                friction_coeffs=np.full(n_cones, model.mu),
                lb=lb,
                ub=ub,
            )
        )
    return qps


def generate_osc_batch(
    model: RobotModel,
    batch: int,
    seed: int = 0,
    w_u: float = 1e-3,
    w_l: float = 1e-2,
    w_slack: float = 1e2,
    smoothness: float = 0.05,
    f_normal: float = 400.0,
    cone_activity: float = 0.5,
    bound_quantile: float = 0.9,
    random_phase: bool = False,
):
    """Domain-randomized batch of independent OSC QPs (one per robot
    state), fully vectorized over the batch axis (batched QR / einsum /
    solve — no per-instance Python loop, so 4096-instance generation is
    host-cheap without an on-disk cache).

    Semantically the batch analog of ``generate_osc_sequence`` at T=1:
    each instance gets its own robot structure (mass matrix, Jacobians,
    task weights) and bias drivers drawn from the same distributions.
    ``random_phase=True`` additionally gives each instance a uniform
    random gait phase, so desired contact forces span the full
    stance/swing range (harder, more diverse batch); the default
    ``False`` matches the sequence generator's t=0 (phase 0: all cones
    unloaded).

    Returns a list of dicts with the reference npz schema
    (`fcc_qp_test.py:28-30`): keys ``Q, b, A_eq, b_eq,
    friction_coeffs, lb, ub``.
    """
    rng = np.random.default_rng([seed, 0x05CBA7C4])
    B = batch
    nv, nu, nh, nc, ncr = model.nv_dof, model.nu, model.nh, model.nc, model.nc_rows
    nsl = model.n_slack
    n = model.shape.num_vars
    m = model.shape.num_eq
    n_cones = nc // 3
    n_task = min(nv, 12)

    # --- per-instance fixed structure, batched -------------------------
    U, _ = np.linalg.qr(rng.normal(size=(B, nv, nv)))
    eigs = np.exp(rng.uniform(0, np.log(50.0), size=(B, nv)))
    M0 = np.einsum("bij,bj,bkj->bik", U, eigs, U)
    Jh0 = rng.normal(size=(B, nh, nv))
    Jc0 = rng.normal(size=(B, nc, nv))
    Jt0 = rng.normal(size=(B, n_task, nv))
    w_task = np.exp(rng.uniform(0, 2, size=(B, n_task)))

    # one random-walk step of each smooth driver (x0 -> x1), batched
    a = smoothness
    def walk(shape, alpha, scale):
        x0 = rng.normal(size=(B,) + shape) * scale
        return (1 - alpha) * x0 + alpha * rng.normal(size=(B,) + shape) * scale

    dM = walk((nv, nv), 0.4 * a, 0.02)
    dJh = walk((nh, nv), 0.5 * a, 0.05)
    dJc = walk((nc, nv), 0.5 * a, 0.05)
    dJt = walk((n_task, nv), 0.5 * a, 0.05)
    dydd = walk((n_task,), a, 1.0)
    dC = walk((nv,), a, 1.0)
    dbias_h = walk((nh,), a, 0.2)
    dbias_c = walk((ncr,), a, 0.2)
    tan = walk((n_cones, 2), 0.5 * a, 1.0)

    Mt = M0 + dM
    Mt = 0.5 * (Mt + np.swapaxes(Mt, -1, -2)) + 1e-3 * np.eye(nv)
    Jh = Jh0 + dJh
    Jc = Jc0 + dJc
    Jt = Jt0 + dJt
    phase = (
        rng.uniform(0, 2 * np.pi, size=(B, 1))
        if random_phase
        else np.zeros((B, 1))
    )
    yddot = dydd + 3.0 * np.sin(phase + np.arange(n_task))

    # desired stance/swing contact forces (B, nc)
    ks = np.arange(n_cones)
    leg_phase = phase + np.pi * (ks % 2)                       # (B, K)
    stance = np.maximum(0.0, np.sin(leg_phase)) ** 0.7
    fz = f_normal * stance
    frac = cone_activity * (0.5 + 0.5 * np.sin(0.5 * phase + ks))
    d = tan / (np.linalg.norm(tan, axis=-1, keepdims=True) + 1e-9)
    f_des = np.zeros((B, n_cones, 3))
    f_des[..., :2] = (frac * model.mu * fz)[..., None] * d
    f_des[..., 2] = fz
    f_des = f_des.reshape(B, nc)

    C = np.einsum("bcv,bc->bv", Jc, f_des) + dC * np.sqrt(f_normal)
    Jcr = Jc[:, :ncr]

    # --- cost ----------------------------------------------------------
    Q = np.zeros((B, n, n))
    Q[:, :nv, :nv] = (
        np.einsum("btv,bt,btw->bvw", Jt, w_task, Jt) + 1e-6 * np.eye(nv)
    )
    idx = np.arange(n)
    diag = np.zeros(n)
    diag[nv : nv + nu] = w_u
    diag[nv + nu : nv + nu + nh + nc] = w_l
    if nsl:
        diag[nv + nu + nh + nc :] = w_slack
    Q[:, idx, idx] += diag
    b = np.zeros((B, n))
    b[:, :nv] = -np.einsum("btv,bt,bt->bv", Jt, w_task, yddot)
    b[:, nv + nu + nh : nv + nu + nh + nc] = -w_l * f_des

    # --- equality constraints ------------------------------------------
    A = np.zeros((B, m, n))
    beq = np.zeros((B, m))
    A[:, :nv, :nv] = Mt
    # -B, where B selects the trailing (actuated) dofs
    A[:, :nv, nv : nv + nu] = np.vstack(
        [np.zeros((nv - nu, nu)), -np.eye(nu)]
    )
    if nh:
        A[:, :nv, nv + nu : nv + nu + nh] = -np.swapaxes(Jh, -1, -2)
    A[:, :nv, nv + nu + nh : nv + nu + nh + nc] = -np.swapaxes(Jc, -1, -2)
    beq[:, :nv] = -C
    if nh:
        A[:, nv : nv + nh, :nv] = Jh
        beq[:, nv : nv + nh] = -dbias_h
    A[:, nv + nh :, :nv] = Jcr
    if nsl:
        A[:, nv + nh :, nv + nu + nh + nc :] = np.eye(ncr, nsl)
    beq[:, nv + nh :] = -dbias_c

    # --- calibrate actuator bounds from the unconstrained optima -------
    N = n + m
    K = np.zeros((B, N, N))
    K[:, :n, :n] = Q
    K[:, :n, n:] = np.swapaxes(A, -1, -2)
    K[:, n:, :n] = A
    rhs = np.concatenate([-b, beq], axis=-1)
    try:
        x_star = np.linalg.solve(K, rhs[..., None])[:, :n, 0]
    except np.linalg.LinAlgError:
        x_star = np.stack(
            [_equality_solve(Q[i], b[i], A[i], beq[i]) for i in range(B)]
        )
    u_star = np.abs(x_star[:, nv : nv + nu])
    u_max = np.maximum(
        np.quantile(u_star, bound_quantile, axis=-1, keepdims=True), 1e-3
    )                                                          # (B, 1)

    # --- feasibility certificate ---------------------------------------
    # Tight actuator bounds + exact cones can render a random instance
    # PRIMAL INFEASIBLE (models without contact slacks, e.g. the
    # quadruped: the unactuated dynamics rows then demand cone-violating
    # contact forces), and ADMM stalls at a nonzero least-violation
    # residual — as does the reference algorithm. Real OSC logs are
    # feasible (the robot exists), so certify feasibility: pin the
    # contact forces to the cone-projected unconstrained optimum (pushed
    # strictly inside the cone), solve the equality system for the
    # torques that realize them, and widen each instance's bounds to
    # cover that certificate point.
    # exact Euclidean cone projection of the unconstrained optimum's
    # forces (the cone is closed, so the projected point certifies
    # feasibility while perturbing the problem distribution minimally)
    lam_star = x_star[:, nv + nu + nh : nv + nu + nh + nc]
    lam3 = lam_star.reshape(B, n_cones, 3)
    nxy = np.linalg.norm(lam3[..., :2], axis=-1)
    fz = lam3[..., 2]
    mu_c = model.mu
    inside = mu_c * fz >= nxy
    polar = fz + mu_c * nxy < 0
    t = (mu_c * nxy + fz) / (mu_c * mu_c + 1.0)
    sc = np.where(
        inside, 1.0,
        np.where(polar, 0.0, t * mu_c / np.maximum(nxy, 1e-12)),
    )
    fz_p = np.where(inside, fz, np.where(polar, 0.0, t))
    lam_feas = np.concatenate(
        [lam3[..., :2] * sc[..., None], fz_p[..., None]], axis=-1
    ).reshape(B, nc)
    # equality solve with the cone segment pinned
    P = np.zeros((nc, n))
    P[np.arange(nc), nv + nu + nh + np.arange(nc)] = 1.0
    N2 = n + m + nc
    K2 = np.zeros((B, N2, N2))
    K2[:, :n, :n] = Q
    K2[:, :n, n : n + m] = np.swapaxes(A, -1, -2)
    K2[:, n : n + m, :n] = A
    K2[:, :n, n + m :] = np.broadcast_to(P.T, (B, n, nc))
    K2[:, n + m :, :n] = np.broadcast_to(P, (B, nc, n))
    rhs2 = np.concatenate([-b, beq, lam_feas], axis=-1)
    try:
        x_feas = np.linalg.solve(K2, rhs2[..., None])[:, :n, 0]
    except np.linalg.LinAlgError:
        # batched solve raises if ANY instance is singular; fall back
        # to per-instance lstsq so one degenerate instance cannot void
        # the feasibility certificate of the whole batch
        x_feas = np.stack(
            [
                np.linalg.lstsq(K2[i], rhs2[i], rcond=None)[0][:n]
                for i in range(B)
            ],
            axis=0,
        )
    u_feas = np.abs(x_feas[:, nv : nv + nu])
    u_max = np.maximum(u_max, 1.02 * u_feas)                   # (B, nu)

    lb = np.full((B, n), -np.inf)
    ub = np.full((B, n), np.inf)
    lb[:, nv : nv + nu] = -u_max
    ub[:, nv : nv + nu] = u_max

    fc = np.full(n_cones, model.mu)
    return [
        dict(
            Q=Q[i], b=b[i], A_eq=A[i], b_eq=beq[i],
            friction_coeffs=fc, lb=lb[i], ub=ub[i],
        )
        for i in range(B)
    ]
