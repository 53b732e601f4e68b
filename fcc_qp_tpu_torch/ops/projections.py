"""Feasible-set projections and violation metrics (branchless).

Port of `fcc_qp_tpu/ops/projections.py`, plus `project_cone_ds` of
`fcc_qp_tpu/core/ds_engine.py`, which the JAX package evaluates in
double-single and this package in native f64.

Conventions (batch-leading functions)
-------------------------------------
* A stacked contact-force vector ``f`` has shape ``(..., nc)`` with
  ``nc % 3 == 0``; cone ``i`` occupies ``f[..., 3i:3i+3] = (fx, fy, fz)``.
* ``mu`` holds one friction coefficient per cone, shape ``(..., nc // 3)``.
* All functions preserve the input dtype and broadcast over leading batch
  dimensions.
"""

from __future__ import annotations

import torch


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root in the dtype of ``x``.

    PyTorch's vectorized CPU sqrt for f32 is not correctly rounded (it
    differs from IEEE sqrt in the last bit for ~0.7% of inputs), while
    the CUDA kernels, XLA and numpy round correctly. An f32 input is
    therefore rooted in f64 and rounded once to f32, which is exact
    (f64 carries more than twice f32's precision); f64 inputs use
    `torch.sqrt` directly."""
    if x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def project_to_bounds(x: torch.Tensor, lb, ub) -> torch.Tensor:
    """Elementwise projection onto ``[lb, ub]`` (reference
    ``project_to_bounds``)."""
    return torch.clamp(x, lb, ub)


def project_to_friction_cone(f: torch.Tensor, mu) -> torch.Tensor:
    """Exact Euclidean projection of stacked 3-D forces onto friction
    cones ``K = {f : mu * fz >= ||fxy||}``: identity inside, zero in the
    polar cone, otherwise the closed-form surface point
    ``t = (mu*||fxy|| + fz) / (1 + mu^2)``, ``p = (t mu fxy/||fxy||, t)``.

    Args:
      f: ``(..., nc)`` stacked forces, ``nc % 3 == 0``.
      mu: ``(..., nc // 3)`` per-cone friction coefficients.
    """
    if f.shape[-1] == 0:
        return f
    mu = torch.as_tensor(mu, dtype=f.dtype, device=f.device)
    f3 = f.reshape(*f.shape[:-1], -1, 3)
    fxy = f3[..., :2]
    fz = f3[..., 2]
    norm_xy = torch.sqrt(torch.sum(fxy * fxy, dim=-1))

    inside = mu * fz >= norm_xy
    polar = fz < -mu * norm_xy

    t = (mu * norm_xy + fz) / (1.0 + mu * mu)
    safe_norm = torch.where(norm_xy > 0, norm_xy, torch.ones_like(norm_xy))
    scale = t * mu / safe_norm
    surf = torch.cat([scale[..., None] * fxy, t[..., None]], dim=-1)

    out = torch.where(
        inside[..., None], f3,
        torch.where(polar[..., None], torch.zeros_like(f3), surf),
    )
    return out.reshape(f.shape)


def calc_friction_cone_violation(f: torch.Tensor, mu) -> torch.Tensor:
    """Summed cone violation ``sum_i max(0, ||fxy_i|| - mu_i * fz_i)``
    over the trailing (cone) axis."""
    if f.shape[-1] == 0:
        return torch.zeros(f.shape[:-1], dtype=f.dtype, device=f.device)
    mu = torch.as_tensor(mu, dtype=f.dtype, device=f.device)
    f3 = f.reshape(*f.shape[:-1], -1, 3)
    norm_xy = torch.sqrt(torch.sum(f3[..., :2] ** 2, dim=-1))
    viol = torch.clamp_min(norm_xy - mu * f3[..., 2], 0.0)
    return torch.sum(viol, dim=-1)


def calc_bound_violation(x: torch.Tensor, lb, ub) -> torch.Tensor:
    """L2 norm of the out-of-bounds component, ``||x - clip(x, lb, ub)||``."""
    d = x - project_to_bounds(x, lb, ub)
    return torch.sqrt(torch.sum(d * d, dim=-1))


def validate_bounds(lb: torch.Tensor, ub: torch.Tensor) -> torch.Tensor:
    """True iff ``lb[i] <= ub[i]`` for all i (per batch element)."""
    return torch.all(lb <= ub, dim=-1)


def project_cone_ds(f: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """Friction-cone projection, batch-LAST: f (nc, B), mu (nc/3, B).

    Same branchless closed form as `project_to_friction_cone`, with the
    branch tests written as the JAX engine writes them
    (``mu fz - ||fxy|| >= 0`` inside, ``fz + mu ||fxy|| < 0`` polar).
    The JAX package evaluates it in double-single; here it runs in the
    dtype of ``f``: f64 on the solver path, f32 in the approach-phase
    chunk's plain version (whose operation order the CUDA kernel
    repeats).
    """
    nc, B = f.shape
    if nc == 0:
        return f
    f3 = f.reshape(nc // 3, 3, B)
    fx, fy, fz = f3[:, 0], f3[:, 1], f3[:, 2]
    norm = sqrt_rn(fx * fx + fy * fy)
    inside = mu * fz - norm >= 0
    polar = fz + mu * norm < 0
    t = (mu * norm + fz) / (mu * mu + 1.0)
    safe = torch.where(norm > 0, norm, torch.ones_like(norm))
    scale = t * mu / safe
    zero = torch.zeros_like(fx)

    def sel(surf, orig):
        return torch.where(inside, orig, torch.where(polar, zero, surf))

    return torch.stack(
        [sel(scale * fx, fx), sel(scale * fy, fy), sel(t, fz)], dim=1
    ).reshape(nc, B)
