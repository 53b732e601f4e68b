"""The benchmark's data: a synthetic whole-body-control walking log,
made on the device from a seed.

A frozen, vectorised copy of the program's `models/osc.py`
`generate_osc_sequence`: the same arguments, structure and
distributions (a stance/swing gait of period ``gait_period``, low-pass
random-walk drivers at rate ``smoothness``, actuator bounds at the
``bound_quantile`` of the unconstrained optimum's |u| pooled over the
log), but every draw of a driver is made at once for all steps, on the
device, with a `torch.Generator` seeded from ``seed``. The draw order
therefore differs from the NumPy original, which steps each driver in
turn: for the same seed the two give different walks of the same
distribution. The robot itself (mass matrix, Jacobians, task weights)
is not drawn from the run's seed: it is the original's robot at the
configuration's ``structure_seed``, drawn as the original draws it
(`robot`), so every run of a cell solves the same robot's QPs and the
seed changes the walk alone. The random walks are evaluated in closed form, blocked
over time (`smooth_walk`), which rounds differently from the original's
step-by-step recurrence by a few units in the last place.

Returns batch-leading f64 tensors under the reference npz schema's keys
(``Q, b, A_eq, b_eq, friction_coeffs, lb, ub``), step t in row t.
"""

from __future__ import annotations

import math

import numpy as np
import torch

KEYS = ("Q", "b", "A_eq", "b_eq", "friction_coeffs", "lb", "ub")
# steps per block of the closed-form random walk
WALK_BLOCK = 128
# steps per batched equality solve of the bound calibration
SOLVE_BLOCK = 8192


def dims(model: dict) -> dict:
    """The QP's sizes for a configuration's ``model`` group: n, m, the
    contact-force segment and the cone count."""
    nv, nu, nh = model["nv_dof"], model["nu"], model["nh"]
    nc, ncr, nsl = model["nc"], model["nc_rows"], model["n_slack"]
    return dict(n=nv + nu + nh + nc + nsl, m=nv + nh + ncr, nc=nc,
                ls=nv + nu + nh, n_cones=nc // 3)


def generator(seed: int, device) -> torch.Generator:
    """A `torch.Generator` on ``device`` seeded from any whole number
    (taken modulo 2**64)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def smooth_walk(g, T: int, shape, alpha: float, scale: float, device):
    """``T`` steps of the low-pass random walk x_t = (1 - alpha) x_{t-1}
    + alpha * scale * n_t, started at its stationary distribution; row t
    is the walk after t + 1 steps (the value the original's ``step()``
    returns at step t). Evaluated in blocks of `WALK_BLOCK` steps: a
    lower-triangular matrix of powers of (1 - alpha) within a block, the
    same for the carries between blocks."""
    f64 = torch.float64
    D = math.prod(shape)
    c = 1.0 - alpha
    x0 = (torch.randn((D,), generator=g, dtype=f64, device=device)
          * scale * math.sqrt(alpha / (2.0 - alpha)))
    L = WALK_BLOCK
    nb = -(-T // L)
    u = torch.randn((nb * L, D), generator=g, dtype=f64, device=device)
    u = (alpha * scale) * u
    j = torch.arange(L, device=device, dtype=f64)
    diff = j[:, None] - j[None, :]
    tri = torch.where(diff >= 0, c ** diff.clamp_min(0), 0.0)
    local = tri @ u.view(nb, L, D)                      # (nb, L, D)
    bj = torch.arange(nb, device=device, dtype=f64)
    bd = bj[:, None] - bj[None, :]
    cL = c ** L
    tri_b = torch.where(bd >= 0, cL ** bd.clamp_min(0), 0.0)
    # e_b: the walk at the end of block b
    ends = tri_b @ local[:, -1] + (cL ** (bj + 1))[:, None] * x0
    starts = torch.cat([x0[None], ends[:-1]])           # (nb, D)
    x = (c ** (j + 1))[None, :, None] * starts[:, None, :] + local
    return x.reshape(nb * L, *shape)[:T]


def robot(model: dict, structure_seed: int) -> dict:
    """The robot's fixed structure (the mass matrix M0, the Jacobians
    Jh0, Jc0, Jt0 and the task weights), drawn exactly as the original
    draws it first from ``numpy.random.default_rng(structure_seed)``: the
    same robot as the original's log at that seed. NumPy f64 arrays."""
    rng = np.random.default_rng(structure_seed)
    nv, nh, nc = model["nv_dof"], model["nh"], model["nc"]
    U, _ = np.linalg.qr(rng.normal(size=(nv, nv)))
    eigs = np.exp(rng.uniform(0, np.log(50.0), size=nv))
    M0 = (U * eigs) @ U.T
    Jh0 = rng.normal(size=(nh, nv)) if nh else np.zeros((0, nv))
    Jc0 = rng.normal(size=(nc, nv))
    n_task = min(nv, 12)
    Jt0 = rng.normal(size=(n_task, nv))
    w_task = np.exp(rng.uniform(0, 2, size=n_task))
    return dict(M0=M0, Jh0=Jh0, Jc0=Jc0, Jt0=Jt0, w_task=w_task)


def equality_optimum(Q, b, A, beq):
    """x of the equality-constrained QP min 1/2 x'Qx + b'x, Ax = beq,
    for every step (one batched KKT solve per `SOLVE_BLOCK` steps)."""
    T, n = b.shape
    m = beq.shape[1]
    out = torch.empty_like(b)
    for s in range(0, T, SOLVE_BLOCK):
        e = min(T, s + SOLVE_BLOCK)
        K = torch.zeros((e - s, n + m, n + m), dtype=b.dtype, device=b.device)
        K[:, :n, :n] = Q[s:e]
        K[:, :n, n:] = A[s:e].transpose(1, 2)
        K[:, n:, :n] = A[s:e]
        rhs = torch.cat([-b[s:e], beq[s:e]], dim=1)
        out[s:e] = torch.linalg.solve(K, rhs)[:, :n]
    return out


def walking_log(model: dict, params: dict, T: int, g: torch.Generator,
                device) -> dict:
    """A T-step walking log of the robot ``model`` (a configuration's
    ``model`` group) under the generator ``params`` (its ``generator``
    group: gait_period, w_u, w_l, w_slack, smoothness, f_normal,
    cone_activity, bound_quantile, structure_seed), its walk drawn from
    ``g``. Returns a dict of
    batch-leading f64 tensors on ``device`` keyed by `KEYS`."""
    f64 = torch.float64
    kw = dict(dtype=f64, device=device)
    nv, nu, nh = model["nv_dof"], model["nu"], model["nh"]
    nc, ncr, nsl = model["nc"], model["nc_rows"], model["n_slack"]
    mu = float(model["mu"])
    d = dims(model)
    n, m, n_cones = d["n"], d["m"], d["n_cones"]
    a = float(params["smoothness"])
    f_normal = float(params["f_normal"])
    w_u, w_l, w_slack = (float(params[k]) for k in ("w_u", "w_l", "w_slack"))

    # the robot: fixed by the configuration, not by the run's seed
    fixed = {k: torch.from_numpy(v).to(device) for k, v in robot(
        model, int(params["structure_seed"])).items()}
    M0, Jh0, Jc0, Jt0 = (fixed[k] for k in ("M0", "Jh0", "Jc0", "Jt0"))
    w_task = fixed["w_task"]
    n_task = min(nv, 12)

    # smooth drivers, all steps at once
    walk = lambda shape, alpha, scale: smooth_walk(g, T, shape, alpha,
                                                   scale, device)
    dM = walk((nv, nv), 0.4 * a, 0.02)
    dJh = walk((nh, nv), 0.5 * a, 0.05)
    dJc = walk((nc, nv), 0.5 * a, 0.05)
    dJt = walk((n_task, nv), 0.5 * a, 0.05)
    dydd = walk((n_task,), a, 1.0)
    dC = walk((nv,), a, 1.0)
    dbias_h = walk((nh,), a, 0.2)
    dbias_c = walk((ncr,), a, 0.2)
    dtan = walk((n_cones, 2), 0.5 * a, 1.0)

    t = torch.arange(T, **kw)
    phase = 2 * math.pi * t / float(params["gait_period"])       # (T,)
    eye_nv = torch.eye(nv, **kw)
    Mt = M0 + dM
    Mt = 0.5 * (Mt + Mt.transpose(1, 2)) + 1e-3 * eye_nv
    Jh = Jh0 + dJh
    Jc = Jc0 + dJc
    Jt = Jt0 + dJt
    k = torch.arange(n_task, **kw)
    yddot = dydd + 3.0 * torch.sin(phase[:, None] + k)

    # desired stance/swing contact forces: alternating legs
    ci = torch.arange(n_cones, **kw)
    leg_phase = phase[:, None] + math.pi * torch.remainder(ci, 2)
    stance = torch.clamp_min(torch.sin(leg_phase), 0.0) ** 0.7
    fz = f_normal * stance                                       # (T, K)
    frac = float(params["cone_activity"]) * (
        0.5 + 0.5 * torch.sin(0.5 * phase[:, None] + ci))
    dirn = dtan / (torch.linalg.vector_norm(dtan, dim=-1, keepdim=True)
                   + 1e-9)
    f_des = torch.cat([(frac * mu * fz)[..., None] * dirn, fz[..., None]],
                      dim=-1).reshape(T, nc)
    C = (torch.einsum("tcv,tc->tv", Jc, f_des)
         + dC * math.sqrt(f_normal))

    # cost
    Q = torch.zeros((T, n, n), **kw)
    JtW = Jt * w_task[None, :, None]
    Q[:, :nv, :nv] = Jt.transpose(1, 2) @ JtW + 1e-6 * eye_nv
    diag = torch.zeros((n,), **kw)
    diag[nv:nv + nu] = w_u
    diag[nv + nu:nv + nu + nh + nc] = w_l
    diag[nv + nu + nh + nc:] = w_slack
    idx = torch.arange(n, device=device)
    Q[:, idx, idx] += diag
    b = torch.zeros((T, n), **kw)
    b[:, :nv] = -(JtW.transpose(1, 2) @ yddot[..., None])[..., 0]
    b[:, nv + nu + nh:nv + nu + nh + nc] = -w_l * f_des

    # equality constraints: dynamics, holonomic, contact (+ slacks)
    A = torch.zeros((T, m, n), **kw)
    beq = torch.zeros((T, m), **kw)
    A[:, :nv, :nv] = Mt
    A[:, nv - nu:nv, nv:nv + nu] = -torch.eye(nu, **kw)
    if nh:
        A[:, :nv, nv + nu:nv + nu + nh] = -Jh.transpose(1, 2)
        A[:, nv:nv + nh, :nv] = Jh
        beq[:, nv:nv + nh] = -dbias_h
    A[:, :nv, nv + nu + nh:nv + nu + nh + nc] = -Jc.transpose(1, 2)
    beq[:, :nv] = -C
    A[:, nv + nh:, :nv] = Jc[:, :ncr]
    if nsl:
        A[:, nv + nh:, nv + nu + nh + nc:] = torch.eye(ncr, nsl, **kw)
    beq[:, nv + nh:] = -dbias_c

    # actuator bounds from the unconstrained optima, pooled over the log
    u_star = equality_optimum(Q, b, A, beq)[:, nv:nv + nu]
    u_max = torch.quantile(u_star.abs().reshape(-1),
                           float(params["bound_quantile"]))
    u_max = torch.clamp_min(u_max, 1e-3)
    lb = torch.full((T, n), -math.inf, **kw)
    ub = torch.full((T, n), math.inf, **kw)
    lb[:, nv:nv + nu] = -u_max
    ub[:, nv:nv + nu] = u_max
    fc = torch.full((T, n_cones), mu, **kw)
    return dict(Q=Q, b=b, A_eq=A, b_eq=beq, friction_coeffs=fc, lb=lb,
                ub=ub)
