"""The least time one NVIDIA H100 could take for the ADMM chunk kernels'
work, from the shapes of a cell and the iterations its solves report.

Peaks: NVIDIA's H100 SXM data sheet, dense rates, at the card's full
power limit of 700 W (the benchmark prints the limit of the card it ran
on beside every share): FP64 34 TFLOP/s and FP32 67 TFLOP/s outside the
tensor cores (the kernels use none), HBM3 3.35 TB/s.

Work, per instance-iteration of one ADMM step on k rows (k = the
constrained coordinates on the reduced layout, n on the full layout):
one dense k x k mat-vec (2 k^2 flops), 16 k flops of vector updates and
residual norms, 12 flops a cone projection. Bytes: each input read once
and each output written once per instance and per precision phase (the
operator and per-instance data, the state in and out), however the port
splits the iterations into launches. The count is a function of what
the inputs need (the iterations each instance ran), so a kernel that
runs fewer iterations, or a fused one, keeps the same yardstick.

The least time is the larger of operations over peak (f32 and f64 work
against their own units, which run side by side, so the larger of the
two) and bytes over bandwidth.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f64": 34e12, "f32": 67e12}
WORD = {"f64": 8, "f32": 4}


def flops_per_iteration(k: int, n_cones: int) -> int:
    """Operations of one ADMM iteration of one instance on k rows."""
    return 2 * k * k + 16 * k + 12 * n_cones


def reduced_bytes(k: int, kb: int, n_cones: int, prec: str) -> int:
    """Bytes one instance moves through a reduced-layout phase in
    ``prec``: the k x k operator, x_const, the residual weights, the
    box bounds of the kb bounded rows, the cone coefficients and rho
    read once; the state (x, s, mu, v and four norms, three counters)
    read once and written once."""
    w = WORD[prec]
    data = (k * k + 2 * k + 2 * kb + n_cones + 1) * w
    state = (4 * k + 4) * w + 3 * 4
    return data + 2 * state


def full_bytes(n: int, nc: int, prec: str) -> int:
    """Bytes one instance moves through the full layout in ``prec``: the
    n x n operator, x_const, lb, ub, the cone coefficients and rho read
    once; the state (x, x_bar, mu_x, v; lam_bar, mu_lam on the nc cone
    rows; four norms, three counters) read once and written once."""
    w = WORD[prec]
    data = (n * n + 3 * n + nc // 3 + 1) * w
    state = (4 * n + 2 * nc + 4) * w + 3 * 4
    return data + 2 * state


def least_seconds(phases) -> dict:
    """The least time for a list of phases, each a dict with ``prec``
    ('f32' or 'f64'), ``flops`` and ``bytes``: the larger of the
    precisions' operation times and the bandwidth time. Returns
    ``{"seconds", "bound_by", "flops_f32", "flops_f64", "bytes"}``."""
    flops = {"f32": 0, "f64": 0}
    nbytes = 0
    for p in phases:
        flops[p["prec"]] += p["flops"]
        nbytes += p["bytes"]
    t_ops = max(flops[q] / PEAK_FLOPS[q] for q in flops)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return dict(seconds=max(t_ops, t_bytes),
                bound_by="bytes" if t_bytes > t_ops else "operations",
                flops_f32=flops["f32"], flops_f64=flops["f64"], bytes=nbytes)


def reduced_work(k: int, kb: int, n_cones: int, iters_f32, iters_f64):
    """The phases of reduced-layout solves (`admm_chunk_f32` approach
    and polish rounds, `admm_chunk_f64` endgame) from each instance's
    reported iterations in each precision (sequences of ints). An
    instance moves a phase's bytes only if it ran an iteration there."""
    f = flops_per_iteration(k, n_cones)
    out = []
    for prec, its in (("f32", iters_f32), ("f64", iters_f64)):
        its = [int(i) for i in its]
        active = sum(1 for i in its if i > 0)
        out.append(dict(prec=prec, flops=f * sum(its),
                        bytes=active * reduced_bytes(k, kb, n_cones, prec)))
    return out


def full_iterations(n_iter: int, max_iter: int) -> int:
    """The iterations the full-layout kernel runs for a solve that
    reports ``n_iter``: the reference's count stops one short of the
    iteration whose residuals pass (it counts from 0), so a converged
    solve ran ``n_iter + 1``, one at the cap ``max_iter``."""
    return n_iter + 1 if n_iter < max_iter else max_iter


def full_work(n: int, nc: int, iters, prec: str = "f64"):
    """The phase of full-layout solves (`admm_chunk_full_f64`) from the
    iterations each instance ran (`full_iterations`)."""
    its = [int(i) for i in iters]
    active = sum(1 for i in its if i > 0)
    return [dict(prec=prec, flops=flops_per_iteration(n, nc // 3) * sum(its),
                 bytes=active * full_bytes(n, nc, prec))]
