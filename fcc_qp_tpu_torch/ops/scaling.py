"""Cone-aware Ruiz equilibration for batched FCCQP problems.

Port of `fcc_qp_tpu/ops/scaling.py`. Scaled problem, with diagonal D
(variables), E (equality rows), cost scalar c and x = D x~:

    Q~ = c D Q D,  b~ = c D b,  A~ = E A D,  b_eq~ = E b_eq,
    lb~ = D^-1 lb, ub~ = D^-1 ub,

with the tangential pair of every friction cone sharing one scale so the
scaled cone is again a Lorentz cone with ``mu~ = mu d_z / d_t``.
Convergence tolerances stay in UNSCALED units (the solver weights the
scaled residuals by D).

The factors are computed in f32 FROM THE f32-ROUNDED DATA, exactly as
the JAX engine computes them from the hi words of its double-single
data, and rounded to powers of two: the port's factors are therefore
bit-equal to the JAX package's, and applying them to the f64 data is an
exact change of variables (continuous or f64-computed factors regress
the equality residuals).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fcc_qp_tpu_torch.config import ProblemShape
from fcc_qp_tpu_torch.ops.projections import sqrt_rn

_TINY = 1e-12


def _pow2_round(x: torch.Tensor) -> torch.Tensor:
    """Round positive scale factors to the nearest power of two (f32)."""
    return torch.exp2(torch.round(torch.log2(x)))


class Scaling(NamedTuple):
    """Batched diagonal scaling, batch-last.

    d: (n, B) variable scale — unscaled x = d * x_scaled.
    e: (m, B) equality-row scale.
    c: (B,)  cost scale (objective multiplied by c).
    """

    d: torch.Tensor
    e: torch.Tensor
    c: torch.Tensor


def _pair_cone_tangentials(dd: torch.Tensor, ls: int, nc: int):
    """Force d_x == d_y within every cone triple (geometric mean)."""
    if nc == 0:
        return dd
    n = dd.shape[0]
    seg = dd[ls:ls + nc].reshape(nc // 3, 3, -1)
    g = sqrt_rn(seg[:, 0] * seg[:, 1])
    seg = torch.stack([g, g, seg[:, 2]], dim=1).reshape(nc, -1)
    return torch.cat([dd[:ls], seg, dd[ls + nc:]], dim=0)[:n]


def ruiz_scaling(
    Qh: torch.Tensor,
    Ah: torch.Tensor,
    bh: torch.Tensor,
    shape: ProblemShape,
    iters: int = 8,
) -> Scaling:
    """Modified-Ruiz scale factors for a batch (f32, batch-last).

    Qh (n, n, B), Ah (m, n, B), bh (n, B): the problem data rounded to
    f32 (callers pass ``x.float()``). Equilibrates the KKT matrix
    [[Q, A'],[A, 0]] toward unit inf-norms, with OSQP-style cost
    normalization folded in.
    """
    Qh, Ah, bh = Qh.float(), Ah.float(), bh.float()
    n, _, B = Qh.shape
    m = Ah.shape[0]
    ls, nc = shape.lambda_c_start, shape.nc
    kw = dict(dtype=torch.float32, device=Qh.device)

    d, e, c = identity_scaling(n, m, B, device=Qh.device)
    Qa = Qh.abs()
    Aa = Ah.abs()
    ba = bh.abs()

    for _ in range(iters):
        rn = Qa.amax(dim=1)  # (n, B)
        if m:
            rn = torch.maximum(rn, Aa.amax(dim=0))
            re = Aa.amax(dim=1)  # (m, B)
        dd = torch.where(
            rn > _TINY, 1.0 / sqrt_rn(torch.clamp_min(rn, _TINY)), 1.0
        )
        dd = _pow2_round(_pair_cone_tangentials(dd, ls, nc))
        Qa = Qa * dd[:, None, :] * dd[None, :, :]
        ba = ba * dd
        d = d * dd
        if m:
            ee = torch.where(
                re > _TINY, 1.0 / sqrt_rn(torch.clamp_min(re, _TINY)), 1.0
            )
            ee = _pow2_round(ee)
            Aa = Aa * ee[:, None, :] * dd[None, :, :]
            e = e * ee

        # cost normalization: gamma = 1 / max(mean_i max_j |Q~|, ||b~||_inf);
        # the mean is summed row by row in index order so its rounding
        # (and with it the power-of-two choice) is the JAX engine's
        cmax = Qa.amax(dim=1)
        colnorm = cmax[0].clone() if n else torch.zeros((B,), **kw)
        for i in range(1, n):
            colnorm = colnorm + cmax[i]
        colnorm = colnorm / max(n, 1)  # (B,)
        bnorm = ba.amax(dim=0) if n else torch.zeros((B,), **kw)
        g = torch.maximum(colnorm, bnorm)
        g = _pow2_round(
            torch.where(g > _TINY, 1.0 / torch.clamp_min(g, _TINY), 1.0)
        )
        Qa = Qa * g[None, None, :]
        ba = ba * g[None, :]
        c = c * g

    return Scaling(d=d, e=e, c=c)


def identity_scaling(n: int, m: int, B: int, dtype=torch.float32,
                     device=None) -> Scaling:
    """The unit `Scaling` of a batch of ``B`` (batch-last), on ``device``
    (default CUDA; raises when there is no card)."""
    from fcc_qp_tpu_torch.core.ds_engine import resolve_device

    kw = dict(dtype=dtype, device=resolve_device(device))
    return Scaling(d=torch.ones((n, B), **kw), e=torch.ones((m, B), **kw),
                   c=torch.ones((B,), **kw))


def _scale_bounds(bound: torch.Tensor, inv_d: torch.Tensor) -> torch.Tensor:
    """Bounds divide by d; +-inf entries pass through untouched."""
    return torch.where(
        torch.isfinite(bound), bound * inv_d.double(), bound
    )


def apply_scaling(qp, scaling: Scaling, shape: ProblemShape):
    """Scale a `QPBatchDS` (f64 data times exact power-of-two f32
    factors). Returns the scaled batch, with `friction_coeffs` replaced
    by the per-cone effective coefficients mu~ = mu * d_z / d_t."""
    d, e, c = scaling
    ls, nc = shape.lambda_c_start, shape.nc
    inv_d = 1.0 / d

    Qs = qp.Q * (c[None, None, :] * d[:, None, :] * d[None, :, :]).double()
    bs = qp.b * (c[None, :] * d).double()
    As = qp.A_eq * (e[:, None, :] * d[None, :, :]).double()
    beqs = qp.b_eq * e.double()
    lbs = _scale_bounds(qp.lb, inv_d)
    ubs = _scale_bounds(qp.ub, inv_d)

    if nc:
        dseg = d[ls:ls + nc].reshape(nc // 3, 3, -1)
        mu_eff = qp.friction_coeffs * (dseg[:, 2] / dseg[:, 0]).double()
    else:
        mu_eff = qp.friction_coeffs

    return qp._replace(
        Q=Qs, b=bs, A_eq=As, b_eq=beqs, lb=lbs, ub=ubs,
        friction_coeffs=mu_eff,
    )

