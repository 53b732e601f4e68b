"""OSQP-style active-set polishing for the reduced ADMM engine.

Port of `fcc_qp_tpu/ops/polish.py` (see its module docstring for the
algorithm): run ADMM only to a coarse tolerance, classify every
constrained coordinate by the projection branch of ``t = s + mu`` (box
at lower / upper bound; each friction cone interior, on its surface or
at its apex), solve the equality-KKT of that active set with the cone
surface rows linearized and re-linearized (a primal-dual active-set /
SQP loop of up to ``newton_steps`` solves), and accept an instance only
if the polished point passes the same projection-consistency and
equality residual test the ADMM loop uses, at full eps.

Precision follows the JAX package with f64 in place of its
double-single: the inverse seeds of the (row-replaced, pinned) KKT are
f32 Newton-Schulz iterates; refinement, reconstructed duals and
acceptance residuals are f64; the classification and Newton-steering
quantities the JAX package reads from hi words are f32 here too.

Layouts follow the JAX package: problem data, state and masks are
batch-LAST; the f32 seeds ``(B, N2, N2)`` are batch-leading. The
capacity gathers of the continuation (``argsort(-mask, stable=True)[:C]``)
stay on the device.

``static=True`` reads nothing back: each gathered loop (the seed
rebuild, the continuation's passes) runs the bound its shapes fix, each
pass a `ops.device_branch.branch` on whether work is pending, and the
full-batch second step is a branch on the pool's size; the results are
the eager ones bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from fcc_qp_tpu_torch.ops.device_branch import branch, gathered_loop
from fcc_qp_tpu_torch.ops.ds_linalg import (
    gather_capacity,
    index_tensor,
    matvec_ds,
    pass_count,
    transpose_ds,
)
from fcc_qp_tpu_torch.ops.projections import project_cone_ds, sqrt_rn
from fcc_qp_tpu_torch.utils.timing import StageClock


class PolishResult(NamedTuple):
    x: torch.Tensor       # (n, B) polished primal, scaled space
    mu: torch.Tensor      # (k, B) reconstructed scaled ADMM duals
    s: torch.Tensor       # (k, B) projected slack at the polished point
    accept: torch.Tensor  # (B,) bool — passed the full-eps residual check
    x_res: torch.Tensor   # (B,) weighted box residual of the polished point
    lam_res: torch.Tensor  # (B,) weighted cone residual
    seed: torch.Tensor    # (B, N2, N2) f32 inverse seed (reused by retries)
    cls: torch.Tensor     # (2*kb + 2*ncones, B) bool — the classification
    #                       the seed was last refreshed against


class _PCtx(NamedTuple):
    """Batch-dependent data of the polish helpers; every leaf has the
    batch as its LAST axis, so a sub-batch is one trailing-axis index."""

    Q: torch.Tensor
    b: torch.Tensor
    A_eq: torch.Tensor
    b_eq: torch.Tensor
    fc: torch.Tensor       # friction coefficients (ncones, B)
    lbc: torch.Tensor      # (kb, B)
    ubc: torch.Tensor
    wk: torch.Tensor       # (k, B) f32 unscaling weights
    rho: torch.Tensor      # (B,) f32
    e_scale: torch.Tensor  # (m, B) f32


def _gather_ctx(c: _PCtx, idx) -> _PCtx:
    return _PCtx(*(f[..., idx] for f in c))


def pack_classification(low, up, surf, apex) -> torch.Tensor:
    """Pack the four active-set masks into one (2*kb+2*ncones, B) bool."""
    return torch.cat([low, up, surf, apex], dim=0)


def unpack_classification(cls: torch.Tensor, kb: int, ncones: int):
    return (
        cls[:kb],
        cls[kb:2 * kb],
        cls[2 * kb:2 * kb + ncones],
        cls[2 * kb + ncones:],
    )


def _cone_geometry(lam3: torch.Tensor):
    """Per-cone tangential norm and unit direction, lam3 (ncones, 3, B);
    returns (nxy, gx, gy) with the safe-norm guard for the apex."""
    fx, fy = lam3[:, 0], lam3[:, 1]
    nxy = torch.sqrt(fx * fx + fy * fy)
    safe = torch.where(nxy > 0, nxy, torch.ones_like(nxy))
    return nxy, fx / safe, fy / safe


def classify_branch(t, lbc, ubc, mu_eff, kb: int, nc: int, wk,
                    inflate: float = 0.0):
    """Active-set classification from the PRE-projection point
    ``t = s + mu``: the projection branch of t is the active set (primal
    activity and dual sign in one test). Evaluated in f32 on the
    f32-rounded data, as the JAX package reads its hi words.

    ``inflate``: proximity margin in unscaled units (weights ``wk``),
    used only for the initial read from a coarse ADMM state.

    Returns (low, up, surf, apex): low/up (kb, B); surf/apex (ncones, B).
    """
    B = t.shape[-1]
    dev = t.device
    t = t.float()
    if kb:
        tb = t[:kb]
        lb, ub = lbc.float(), ubc.float()
        m = inflate / wk[:kb] if inflate else 0.0
        low = torch.isfinite(lb) & (tb < lb + m)
        up = torch.isfinite(ub) & (tb > ub - m) & ~low
    else:
        low = torch.zeros((0, B), dtype=torch.bool, device=dev)
        up = torch.zeros((0, B), dtype=torch.bool, device=dev)
    if nc:
        ncones = nc // 3
        t3 = t[kb:].reshape(ncones, 3, B)
        wt = wk[kb:].reshape(ncones, 3, B)
        fx, fy, fz = t3[:, 0], t3[:, 1], t3[:, 2]
        mu_f = mu_eff.float()
        nxy = sqrt_rn(fx * fx + fy * fy)
        m = inflate / wt[:, 2] if inflate else 0.0
        inside = mu_f * fz - nxy >= m
        apex = ~inside & (fz + mu_f * nxy < 0)
        surf = ~inside & ~apex
    else:
        apex = torch.zeros((0, B), dtype=torch.bool, device=dev)
        surf = torch.zeros((0, B), dtype=torch.bool, device=dev)
    return low, up, surf, apex


def _curvature_augmented_q(Q, eta, lam3, surf, ls: int):
    """Q + sum_j eta_j * grad^2 g_j(lambda_j), the Lagrangian Hessian of
    the linearized cone-surface rows (four tangential entries per active
    cone; eta clamped at 0). The term only steers the Newton path, so it
    is formed in f32 like the JAX package's hi-word update."""
    ncones = lam3.shape[0]
    nxy, gx, gy = _cone_geometry(lam3)
    nxy, gx, gy = nxy.float(), gx.float(), gy.float()
    safe_nxy = torch.where(nxy > 1e-20, nxy, torch.ones_like(nxy))
    c = torch.where(surf, torch.clamp_min(eta, 0.0) / safe_nxy, 0.0)
    pxx = c * (1.0 - gx * gx)
    pyy = c * (1.0 - gy * gy)
    pxy = -c * gx * gy
    ix = index_tensor(ls + np.arange(ncones) * 3, Q.device)
    iy = ix + 1
    Qa = Q.clone()
    Qa[ix, ix] += pxx.double()
    Qa[iy, iy] += pyy.double()
    Qa[ix, iy] += pxy.double()
    Qa[iy, ix] += pxy.double()
    return Qa


def _surf_rows(lam3, mu_eff, surf, n: int, ls: int):
    """Masked cone-SURFACE rows (ncones, n, B) linearized at lam3:
    row j = (gx, gy, -mu) at cone j's coordinates when surf_j, else 0."""
    ncones, _, B = lam3.shape
    _, gx, gy = _cone_geometry(lam3)
    R = lam3.new_zeros((ncones, n, B))
    r0 = torch.arange(ncones, device=lam3.device)
    c0 = ls + 3 * r0
    zero = torch.zeros_like(gx)
    for dc, blk in ((0, gx), (1, gy), (2, -mu_eff)):
        R[r0, c0 + dc] = torch.where(surf, blk, zero)
    return R


def _assemble_m2_masked(Qh_aug, pin, A2h, Dtail):
    """Batch-leading (B, N2, N2) f32 assembly of the ROW-REPLACED pinned
    KKT  [[Z_r Q + diag(pin), Z_r A2'], [A2, -diag(Dtail)]]  with
    Z_r = diag(1 - pin): a pinned coordinate's row becomes e_i while its
    column stays intact. Inputs batch-last f32."""
    n, _, B = Qh_aug.shape
    m2 = A2h.shape[0]
    dev = Qh_aug.device
    Qb = Qh_aug.permute(2, 0, 1)
    A2b = A2h.permute(2, 0, 1)
    pinb = pin.transpose(0, 1)
    Db = Dtail.transpose(0, 1)
    zr = (1.0 - pinb)[:, :, None]
    eye_n = torch.eye(n, dtype=torch.float32, device=dev)
    Mb = Qb.new_zeros((B, n + m2, n + m2))
    Mb[:, :n, :n] = zr * Qb + pinb[:, :, None] * eye_n
    Mb[:, :n, n:] = zr * A2b.transpose(1, 2)
    Mb[:, n:, :n] = A2b
    Mb[:, n:, n:] = -Db[:, :, None] * torch.eye(
        m2, dtype=torch.float32, device=dev
    )
    return Mb


# the polish's Newton-Schulz chains: iterations of a cold seed, steps of
# a carried seed's guarded refresh
NS_SEED_ITERS = 40
NS_REFRESH_STEPS = 2
# chains of a batch at least this large run in the `polish_ns` kernel,
# smaller ones in batched cuBLAS products (the plain version), by mode: a
# chain holds one SM in the kernel, where cuBLAS spreads a small batch's
# products over the card. Captured, a cold seed of B <= 32 chains runs
# faster in cuBLAS, of B >= 64 in the kernel; the refresh runs faster in
# the kernel at every B, B = 1 included (PERF.md section 3)
NS_KERNEL_MIN_BATCH = {"seed": 64, "refresh": 1}
# the largest N2 whose chain fits a thread block (`fits` in
# csrc/polish_ns.cu: 16 x 16 threads of an 8 x 8 tile); past it every
# chain takes the cuBLAS chain (`polish_ns_plain`) at every batch, as
# talos_mc's N2 = 196 does
NS_KERNEL_MAX_N2 = 128

_ns_lib = None
ns_build_info: dict = {}


def _ns_resid(P):
    """||P - I||_inf per instance, inf where it is not finite."""
    eye = torch.eye(P.shape[-1], dtype=P.dtype, device=P.device)
    r = (P - eye).abs().sum(dim=-1).amax(dim=-1)
    return torch.where(torch.isfinite(r), r, torch.full_like(r, float("inf")))


def polish_ns_plain(Mb, X=None, steps: int = NS_REFRESH_STEPS, *, out=None,
                    idx=None, keep=None):
    """The plain version of `polish_ns`, in batched products.

    Seed (``X`` None): X0 = Mb' / ||Mb||_F^2 (valid for the indefinite and
    the row-replaced asymmetric KKT alike), then `NS_SEED_ITERS`
    iterations of X <- X (2I - Mb X). Returns the seed, or with ``out``
    (the batch's seeds), ``idx`` and ``keep`` (a rebuild pass on the
    gathered ``Mb = M[idx]``) writes it into ``out[idx]`` where ``keep``,
    in place, and returns ``out``.

    Refresh (``X`` a carried seed): ``steps`` guarded Newton-Schulz steps
    against the moved KKT, keeping the best-residual iterate per instance
    and restarting from it where the residual ||Mb X - I||_inf is not
    below 1; the restart product Mb X_best is taken where X is not X_best
    already (elsewhere it is Mb X bit for bit). Returns ``(X_best,
    r_best)``, X_best a tensor of its own.

    Full-f32 products throughout: a reduced-precision pass does not
    contract at all."""
    N2 = Mb.shape[-1]
    eye2 = 2.0 * torch.eye(N2, dtype=Mb.dtype, device=Mb.device)
    if X is None:
        fro2 = (Mb * Mb).sum(dim=(-1, -2))
        X = Mb.transpose(-1, -2) / torch.clamp_min(fro2, 1e-30)[:, None, None]
        for _ in range(NS_SEED_ITERS):
            X = X @ (eye2 - Mb @ X)
        if out is None:
            return X
        out[idx] = torch.where(keep[:, None, None], X, out[idx])
        return out
    X_in = X
    P = Mb @ X
    r_best = r = _ns_resid(P)
    X_best = X
    same = torch.ones_like(r, dtype=torch.bool)   # X is X_best
    for _ in range(steps):
        restart = (~(r < 1.0) & ~same)[:, None, None]
        X = torch.where(restart, X_best, X)
        P = torch.where(restart, Mb @ X_best, P)
        X = X @ (eye2 - P)
        P = Mb @ X
        r = _ns_resid(P)
        same = r < r_best
        X_best = torch.where(same[:, None, None], X, X_best)
        r_best = torch.minimum(r, r_best)
    return (X_best.clone() if X_best is X_in else X_best), r_best


def ns_kernel_takes(B: int, N2: int, mode: str) -> bool:
    """Whether `polish_ns` runs a batch of ``B`` chains at ``N2`` in the
    kernel on the card, ``mode`` "seed" or "refresh": ``B`` at least the
    mode's `NS_KERNEL_MIN_BATCH` and a chain fits a thread block
    (``N2 <= NS_KERNEL_MAX_N2``)."""
    return B >= NS_KERNEL_MIN_BATCH[mode] and 1 <= N2 <= NS_KERNEL_MAX_N2


def build_polish_ns():
    """Compile `csrc/polish_ns.cu` (`ops.pallas_admm.build_library`, the
    ADMM kernels' flags) and load it; the compile seconds, the compiler's
    log and its register/spill report go into `ns_build_info`."""
    global _ns_lib
    if _ns_lib is not None:
        return _ns_lib
    import ctypes
    import pathlib

    from fcc_qp_tpu_torch.ops.pallas_admm import build_library, ptxas_report

    source = (pathlib.Path(__file__).resolve().parent.parent / "csrc"
              / "polish_ns.cu")
    so, log, seconds = build_library(source)
    ns_build_info.update(seconds=seconds, library=str(so), log=log,
                         ptxas=ptxas_report(log))
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.polish_ns.argtypes = [p] * 7 + [i] * 4 + [p]
    lib.polish_ns.restype = i
    lib.polish_ns_init.restype = i
    err = lib.polish_ns_init()
    if err != 0:
        raise RuntimeError(f"polish_ns: CUDA error {err} setting its shared "
                           f"memory limit")
    _ns_lib = lib
    return lib


def polish_ns(Mb, X=None, steps: int = NS_REFRESH_STEPS, *, out=None,
              idx=None, keep=None, clock=None):
    """The polish's Newton-Schulz chains on the pinned, row-replaced KKT
    ``Mb`` (B, N2, N2) f32: a cold seed (``X`` None; with ``out``,
    ``idx``, ``keep`` a masked rebuild pass) or the guarded refresh of a
    carried seed ``X``. Arguments and results as `polish_ns_plain`.

    CPU tensors take `polish_ns_plain`; so do batches the kernel does not
    take on the card (`ns_kernel_takes`). Otherwise one launch of the
    hand kernel (`csrc/polish_ns.cu`, a chain per thread block, counted in
    ``polish_ns.launches``); a masked pass skips the chains it would throw
    away. ``clock`` (`utils.timing.StageClock`) counts the chains the
    kernel computed (``n_polish_ns_live``) and skipped by the mask
    (``n_polish_ns_skipped``). Either path runs inside the stage clock's
    sub-stage ``polish_chain`` (`StageClock.begin`), whose site records
    the chains' ``mode`` ("seed", "rebuild" or "refresh"), ``n2``,
    ``chains`` (the batch B) and ``path`` ("kernel" or "cublas")."""
    B, N2 = Mb.shape[0], Mb.shape[-1]
    mode = "seed" if X is None else "refresh"
    kernel = Mb.device.type != "cpu" and ns_kernel_takes(B, N2, mode)
    clock = clock or StageClock()
    site = clock.begin("polish_chain",
                       mode="rebuild" if out is not None else mode, n2=N2,
                       chains=B, path="kernel" if kernel else "cublas")
    res = (_polish_ns_kernel(Mb, X, steps, out, idx, keep, clock) if kernel
           else polish_ns_plain(Mb, X, steps, out=out, idx=idx, keep=keep))
    clock.end(site)
    return res


def _polish_ns_kernel(Mb, X, steps, out, idx, keep, clock):
    """`polish_ns` in one launch of the hand kernel."""
    import ctypes

    B, N2 = Mb.shape[0], Mb.shape[-1]
    clock.count("n_polish_ns_live", B if keep is None else keep)
    clock.count("n_polish_ns_skipped", 0 if keep is None else ~keep)
    f32 = torch.float32
    if not (Mb.dtype == f32 and Mb.dim() == 3 and Mb.shape[1] == N2):
        raise ValueError(f"polish_ns: Mb must be a (B, N2, N2) f32 tensor, "
                         f"got {tuple(Mb.shape)} {Mb.dtype}")
    Mb = Mb.contiguous()
    dev = Mb.device
    ptr = lambda t: None if t is None else t.data_ptr()
    if X is None:
        den = torch.clamp_min((Mb * Mb).sum(dim=(-1, -2)), 1e-30)
        if out is None:
            out = torch.empty_like(Mb)
        else:
            ok = (out.dtype == f32 and out.is_contiguous()
                  and out.shape[1:] == Mb.shape[1:]
                  and idx.dtype == torch.int64 and idx.shape == (B,)
                  and keep.dtype == torch.bool and keep.shape == (B,))
            if not ok:
                raise ValueError("polish_ns: a rebuild pass takes out (B', "
                                 "N2, N2) f32 and idx (int64) / keep (bool) "
                                 "of length B")
            idx, keep = idx.contiguous(), keep.contiguous()
        args = (Mb, den, None, out, None, idx, keep)
    else:
        if not (X.dtype == f32 and X.shape == Mb.shape):
            raise ValueError(f"polish_ns: X must be an f32 tensor of Mb's "
                             f"shape, got {tuple(X.shape)}")
        X = X.contiguous()
        out = torch.empty_like(Mb)
        r_best = torch.empty((B,), dtype=f32, device=dev)
        args = (Mb, None, X, out, r_best, None, None)
    err = build_polish_ns().polish_ns(
        *(ptr(t) for t in args), B, N2, NS_SEED_ITERS, steps,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"polish_ns: CUDA error {err} at launch")
    polish_ns.launches += 1
    return out if X is None else (out, r_best)


polish_ns.launches = 0


def _seed_refresh_or_rebuild(seed, Mb, steps: int, clock=None,
                             static: bool = False):
    """Refresh a carried seed; instances whose refresh does not contract
    (residual > 0.3) get a cold rebuild, capacity-gathered
    (`ops.ds_linalg.gather_capacity` per pass) and looping until every
    one is rebuilt (``static``: the ``ceil(B / C)`` passes that cover the
    batch, each a branch on whether any is left). ``clock``
    (`utils.timing.StageClock`) counts the rebuilt instances
    (``n_polish_rebuild``) and the chains (`polish_ns`)."""
    B = Mb.shape[0]
    X, r = polish_ns(Mb, seed, steps, clock=clock)
    rem = r > 0.3
    if clock is not None:
        clock.count("n_polish_rebuild", rem)
    C = gather_capacity(B)

    def rebuild(X, rem):
        # in place: a pass with nothing pending writes nothing
        idx = torch.argsort(-rem.float(), stable=True)[:C]
        X = polish_ns(Mb[idx], out=X, idx=idx, keep=rem[idx], clock=clock)
        rem.index_fill_(0, idx, False)
        return X, rem

    X, _ = gathered_loop(static, pass_count(B, C), lambda X, rem: rem,
                         rebuild, X, rem)
    return X


def _solve_structured_masked(X32, Q, pin, A2, A2t, Dtail, r1, r2,
                             passes: int = 3):
    """Refined solve of the row-replaced pinned KKT, applying the blocks
    and masks directly (the (N2, N2) f64 matrix is never formed): the
    f32 seed gives each correction, every residual is f64.

    Returns ``(x, y, raw)`` with ``raw = Q x + A2' y`` from the final
    pass (evaluated at the pre-final-correction iterate) — the
    stationarity term that recovers the pinned coordinates' multipliers.
    """
    n = Q.shape[0]
    pin_on = pin > 0

    def apply32(t, b):
        v = torch.cat([t, b], dim=0).float()            # (N2, B)
        out = (X32 @ v.T[:, :, None])[:, :, 0].T.double()
        return out[:n], out[n:]

    x, y = apply32(r1, r2)
    raw = None
    for _ in range(passes):
        raw = matvec_ds(Q, x) + matvec_ds(A2, y)
        top = torch.where(pin_on, x, raw)
        bot = matvec_ds(A2t, x) - y * Dtail.double()
        dx, dy = apply32(r1 - top, r2 - bot)
        x = x + dx
        y = y + dy
    return x, y, raw


def polish_reduced(
    qps,                    # scaled QPBatchDS
    shape,
    ci: np.ndarray,         # (k,) constrained coordinate indices
    kb: int,                # box-constrained count (cone tail follows)
    s: torch.Tensor,        # (k, B) projected slack (scaled)
    mu_dual: torch.Tensor,  # (k, B) scaled ADMM duals
    rho: torch.Tensor,      # (B,) f32 scaled-space penalty
    wk: torch.Tensor,       # (k, B) f32 unscaling weights d[ci]
    lbc: torch.Tensor,      # (kb, B) scaled bounds
    ubc: torch.Tensor,
    e_scale: torch.Tensor,  # (m, B) f32 equality-row scales
    eps_bound: float,
    eps_fcone: float,
    act_tol: float,
    newton_steps: int = 2,
    seed: Optional[torch.Tensor] = None,
    init_class: Optional[torch.Tensor] = None,
    clock=None,
    static: bool = False,
) -> PolishResult:
    """Attempt an active-set polish of every instance in the batch.

    All inputs and outputs live in the SCALED problem space; acceptance
    residuals are weighted back to unscaled units (``wk``, ``e_scale``).
    ``seed``: (B, N2, N2) f32 inverse seed of a previous attempt
    (`PolishResult.seed`), refreshed instead of rebuilt.
    ``init_class``: packed classification to use for the first assembly
    instead of a fresh inflated read (must accompany a carried seed).
    ``clock``: a `utils.timing.StageClock` that counts the seed rebuilds.
    ``static``: read-free (the module docstring).
    """
    nv, nc, ls = shape.num_vars, shape.nc, shape.lambda_c_start
    m = qps.A_eq.shape[0]
    B = s.shape[-1]
    dev = s.device
    f64 = torch.float64
    ncones = nc // 3 if nc else 0
    mu_eff = qps.friction_coeffs
    ci = np.asarray(ci)
    ci_t = index_tensor(ci, dev)
    ci_box = ci_t[:kb]
    C2 = gather_capacity(B)

    t0 = s + mu_dual
    if init_class is None:
        low, up, surf, apex = classify_branch(
            t0, lbc, ubc, mu_eff, kb, nc, wk, inflate=act_tol
        )
    else:
        low, up, surf, apex = unpack_classification(init_class, kb, ncones)

    ctx = _PCtx(
        Q=qps.Q, b=qps.b, A_eq=qps.A_eq, b_eq=qps.b_eq, fc=mu_eff,
        lbc=lbc, ubc=ubc, wk=wk, rho=rho, e_scale=e_scale,
    )

    def build_pins(c: _PCtx, low, up, apex):
        """Pin mask (f32) and pinned values (f64) over the n coordinates:
        active box coordinates pinned to their bound, apex cones' three
        coordinates pinned to 0."""
        Bc = c.b.shape[-1]
        pin = torch.zeros((nv, Bc), dtype=torch.float32, device=dev)
        pv = torch.zeros((nv, Bc), dtype=f64, device=dev)
        if kb:
            act = low | up
            pin[ci_box] = act.float()
            zero = torch.zeros_like(c.lbc)
            vb = torch.where(low, c.lbc, torch.where(up, c.ubc, zero))
            pv[ci_box] = torch.where(act, vb, zero)
        if nc:
            pin[ls:ls + nc] += apex.float()[:, None, :].expand(
                ncones, 3, Bc).reshape(nc, Bc)
        return pin, pv

    def reconstruct_duals(c: _PCtx, x, y, raw, low, up, surf, apex):
        """rho * mu = lambda at the ADMM fixed point: surface multipliers
        from the solve's y tail, pinned coordinates' from the
        stationarity term (y_pin = -(raw + b))."""
        Bc = c.b.shape[-1]
        w = raw + c.b
        if kb:
            lam_box = torch.where(
                low | up, -w[ci_box], torch.zeros((kb, Bc), dtype=f64, device=dev)
            )
        else:
            lam_box = torch.zeros((0, Bc), dtype=f64, device=dev)
        if nc:
            lam_fin = x[ls:ls + nc].reshape(ncones, 3, Bc)
            _, gx, gy = _cone_geometry(lam_fin)
            eta_f = y[m:]
            w3 = w[ls:ls + nc].reshape(ncones, 3, Bc)
            zero = torch.zeros((ncones, Bc), dtype=f64, device=dev)

            def cone_coord(i, g):
                return torch.where(
                    surf, eta_f * g, torch.where(apex, -w3[:, i], zero)
                )

            lam_cone = torch.stack(
                [cone_coord(0, gx), cone_coord(1, gy), cone_coord(2, -c.fc)],
                dim=1,
            ).reshape(nc, Bc)
            lam_all = torch.cat([lam_box, lam_cone], dim=0)
        else:
            lam_all = lam_box
        return lam_all * (1.0 / c.rho)[None, :].double()

    if nc:
        lam_lin = s[kb:].reshape(ncones, 3, B)
        # initial surface-multiplier estimate from the ADMM duals
        mu3 = mu_dual[kb:].float().reshape(ncones, 3, B)
        _, gx0, gy0 = _cone_geometry(lam_lin)
        mf = mu_eff.float()
        dot0 = mu3[:, 0] * gx0.float() + mu3[:, 1] * gy0.float() - mu3[:, 2] * mf
        eta = rho[None, :] * dot0 / (1.0 + mf * mf)
    else:
        lam_lin = None
        eta = None

    def assemble(c: _PCtx, low, up, surf, apex, lam_lin, eta):
        Bc = c.b.shape[-1]
        if nc:
            Rsurf = _surf_rows(lam_lin, c.fc, surf, nv, ls)
            Q_aug = _curvature_augmented_q(c.Q, eta, lam_lin, surf, ls)
            Dtail = torch.cat(
                [torch.zeros((m, Bc), dtype=torch.float32, device=dev),
                 1.0 - surf.float()],
                dim=0,
            )
        else:
            Rsurf = torch.zeros((0, nv, Bc), dtype=f64, device=dev)
            Q_aug = c.Q
            Dtail = torch.zeros((m, Bc), dtype=torch.float32, device=dev)
        pin, pv = build_pins(c, low, up, apex)
        A2 = torch.cat([c.A_eq, Rsurf], dim=0)
        r1 = torch.where(pin > 0, pv, -c.b)
        r2 = torch.cat(
            [c.b_eq, torch.zeros((ncones, Bc), dtype=f64, device=dev)], dim=0
        )
        return Q_aug, pin, A2, transpose_ds(A2), Dtail, r1, r2

    def next_classification(c: _PCtx, x, y, mu_new, lam_lin, eta):
        Bc = c.b.shape[-1]
        t_s = x[ci_t] + mu_new
        nlow, nup, nsurf, napex = classify_branch(
            t_s, c.lbc, c.ubc, c.fc, kb, nc, c.wk, inflate=0.0
        )
        if nc:
            nlam = x[ls:ls + nc].reshape(ncones, 3, Bc)
            neta = y[m:].float()
        else:
            nlam, neta = lam_lin, eta
        return nlow, nup, nsurf, napex, nlam, neta

    def changed_per_instance(c: _PCtx, low, up, surf, apex, lam_lin,
                             nlow, nup, nsurf, napex, nlam):
        """(Bc,) bool: classification flipped, or a cone linearization
        point moved by more than 1e-4 (unscaled)."""
        Bc = c.b.shape[-1]
        flips = torch.zeros((Bc,), dtype=torch.bool, device=dev)
        if kb:
            flips = flips | (nlow != low).any(dim=0) | (nup != up).any(dim=0)
        if nc:
            flips = flips | (nsurf != surf).any(dim=0) | (napex != apex).any(dim=0)
            wl3 = c.wk[kb:].reshape(ncones, 3, Bc)
            moved = (
                ((nlam.float() - lam_lin.float()).abs() * wl3).amax(dim=1)
                > 1e-4
            ).any(dim=0)
            flips = flips | moved
        return flips

    def accept_eval(c: _PCtx, x, mu_new):
        """Projection-consistency + equality acceptance residuals of a
        candidate (x, mu) — the ADMM loop's test at full eps, in f64,
        weighted back to unscaled units. Returns (s_new, x_res, lam_res,
        eq_res, score) with score the max residual/eps ratio (inf for
        non-finite candidates)."""
        Bc = c.b.shape[-1]
        zb = torch.zeros((Bc,), dtype=f64, device=dev)
        xc = x[ci_t]
        t = xc + mu_new
        parts = []
        if kb:
            parts.append(torch.clamp(t[:kb], c.lbc, c.ubc))
        if nc:
            parts.append(project_cone_ds(t[kb:], c.fc))
        s_new = torch.cat(parts, dim=0)
        wres = (xc - s_new).abs() * c.wk.double()
        x_res = wres[:kb].amax(dim=0) if kb else zb
        lam_res = wres[kb:].amax(dim=0) if nc else zb
        r_eq = matvec_ds(transpose_ds(c.A_eq), x) - c.b_eq
        eq_res = (
            (r_eq.abs() / c.e_scale.double()).amax(dim=0) if m else zb
        )
        finite = torch.isfinite(x).all(dim=0) & torch.isfinite(mu_new).all(dim=0)
        score = torch.maximum(
            torch.maximum(x_res / eps_bound, lam_res / eps_fcone),
            eq_res / eps_bound,
        )
        score = torch.where(finite, score, torch.full_like(score, float("inf")))
        return s_new, x_res, lam_res, eq_res, score

    def pdas_step(c: _PCtx, low, up, surf, apex, lam_lin, eta, X):
        """One solve of the current active-set guess: assemble, refresh
        (or build) the seed, refined solve, duals, acceptance."""
        Q_aug, pin, A2, A2t, Dtail, r1, r2 = assemble(
            c, low, up, surf, apex, lam_lin, eta
        )
        Mb = _assemble_m2_masked(Q_aug.float(), pin, A2.float(), Dtail)
        X = (polish_ns(Mb, clock=clock) if X is None
             else _seed_refresh_or_rebuild(X, Mb, NS_REFRESH_STEPS, clock,
                                           static))
        x, y, raw = _solve_structured_masked(X, Q_aug, pin, A2, A2t, Dtail, r1, r2)
        mu_new = reconstruct_duals(c, x, y, raw, low, up, surf, apex)
        s_new, x_res, lam_res, _, score = accept_eval(c, x, mu_new)
        return X, x, y, mu_new, s_new, x_res, lam_res, score

    # first solve, FULL batch (seed build / carried-seed refresh)
    X32, x, y, mu_new, s_new, x_res, lam_res, score = pdas_step(
        ctx, low, up, surf, apex, lam_lin, eta, seed
    )
    used_cls = pack_classification(low, up, surf, apex)
    # per-instance best iterate over the PDAS steps
    best = [x, mu_new, s_new, used_cls, x_res, lam_res, score]

    if newton_steps > 1:
        nlow, nup, nsurf, napex, nlam, neta = next_classification(
            ctx, x, y, mu_new, lam_lin, eta
        )
        changed = changed_per_instance(
            ctx, low, up, surf, apex, lam_lin, nlow, nup, nsurf, napex, nlam
        ) & (score > 1.0)
        steps = torch.ones((B,), dtype=torch.int32, device=dev)

        # commit the post-solve-1 re-classification for still-changing
        # instances before the continuation (the carry0 fix: otherwise
        # the first continuation pass re-solves the identical system)
        chN = changed[None, :]
        low = torch.where(chN, nlow, low)
        up = torch.where(chN, nup, up)
        surf = torch.where(chN, nsurf, surf)
        apex = torch.where(chN, napex, apex)
        if nc:
            lam_lin = torch.where(changed[None, None, :], nlam, lam_lin)
            eta = torch.where(chN, neta, eta)
        seed_cls = used_cls

        carry = (X32, best, low, up, surf, apex, lam_lin, eta, seed_cls,
                 steps, changed)

        # step 2 runs FULL-batch when the pool exceeds the gather capacity
        # (static: a branch on that flag)
        rem = changed & (steps < newton_steps)

        def full_step(X32, best, low, up, surf, apex, lam_lin, eta,
                      seed_cls, steps, changed):
            X32, fx, fy, fmu, f_snew, f_xr, f_lr, f_score = pdas_step(
                ctx, low, up, surf, apex, lam_lin, eta, X32
            )
            f_cls = pack_classification(low, up, surf, apex)
            better = rem & (f_score < best[6])
            bN = better[None, :]
            best = [
                torch.where(bN, fx, best[0]),
                torch.where(bN, fmu, best[1]),
                torch.where(bN, f_snew, best[2]),
                torch.where(bN, f_cls, best[3]),
                torch.where(better, f_xr, best[4]),
                torch.where(better, f_lr, best[5]),
                torch.where(better, f_score, best[6]),
            ]
            nlow, nup, nsurf, napex, nlam, neta = next_classification(
                ctx, fx, fy, fmu, lam_lin, eta
            )
            changed_n = changed_per_instance(
                ctx, low, up, surf, apex, lam_lin,
                nlow, nup, nsurf, napex, nlam,
            ) & (f_score > 1.0)
            remN = rem[None, :]
            low = torch.where(remN, nlow, low)
            up = torch.where(remN, nup, up)
            surf = torch.where(remN, nsurf, surf)
            apex = torch.where(remN, napex, apex)
            if nc:
                lam_lin = torch.where(rem[None, None, :], nlam, lam_lin)
                eta = torch.where(remN, neta, eta)
            seed_cls = torch.where(remN, f_cls, seed_cls)
            steps = steps + rem.int()
            changed = torch.where(rem, changed_n, changed)
            return (X32, best, low, up, surf, apex, lam_lin, eta, seed_cls,
                    steps, changed)

        if static:
            carry = branch(rem.sum() > C2, full_step, *carry)
        elif int(rem.sum()) > C2:
            carry = full_step(*carry)

        def gathered_step(X32, best, low, up, surf, apex, lam_lin, eta,
                          seed_cls, steps, changed):
            rem = changed & (steps < newton_steps)
            idx = torch.argsort(-rem.float(), stable=True)[:C2]
            sel = rem[idx]
            c = _gather_ctx(ctx, idx)
            s_low, s_up = low[:, idx], up[:, idx]
            s_surf, s_apex = surf[:, idx], apex[:, idx]
            s_lam = lam_lin[..., idx] if nc else lam_lin
            s_eta = eta[:, idx] if nc else eta
            sX, sx, sy, smu, s_snew, s_xr, s_lr, s_score = pdas_step(
                c, s_low, s_up, s_surf, s_apex, s_lam, s_eta, X32[idx]
            )
            s_cls = pack_classification(s_low, s_up, s_surf, s_apex)

            bscore = best[6]
            better = sel & (s_score < bscore[idx])
            bN = better[None, :]

            def put(full, sub):
                full = full.clone()
                full[..., idx] = sub
                return full

            def upd(full, sub, mask):
                return put(full, torch.where(mask, sub, full[..., idx]))

            inf = torch.full_like(s_score, float("inf"))
            best = [
                upd(best[0], sx, bN),
                upd(best[1], smu, bN),
                upd(best[2], s_snew, bN),
                upd(best[3], s_cls, bN),
                upd(best[4], s_xr, better),
                upd(best[5], s_lr, better),
                put(bscore, torch.minimum(torch.where(sel, s_score, inf),
                                          bscore[idx])),
            ]

            nlow_s, nup_s, nsurf_s, napex_s, nlam_s, neta_s = (
                next_classification(c, sx, sy, smu, s_lam, s_eta)
            )
            changed_s = changed_per_instance(
                c, s_low, s_up, s_surf, s_apex, s_lam,
                nlow_s, nup_s, nsurf_s, napex_s, nlam_s,
            ) & (s_score > 1.0)

            selN = sel[None, :]
            low, up = upd(low, nlow_s, selN), upd(up, nup_s, selN)
            surf, apex = upd(surf, nsurf_s, selN), upd(apex, napex_s, selN)
            if nc:
                lam_lin = upd(lam_lin, nlam_s, sel[None, None, :])
                eta = upd(eta, neta_s, selN)
            # the static seed is the polish's own (made in the first
            # solve); a pass with nothing pending rewrites what it read
            if not static:
                X32 = X32.clone()
            X32[idx] = torch.where(sel[:, None, None], sX, X32[idx])
            seed_cls = upd(seed_cls, s_cls, selN)
            steps = put(steps, steps[idx] + sel.int())
            changed = upd(changed, changed_s, sel)
            return (X32, best, low, up, surf, apex, lam_lin, eta, seed_cls,
                    steps, changed)

        # steps 3+ on capacity-gathered sub-batches of the pool. Bound of
        # the static form: an instance takes part in at most
        # newton_steps - 1 passes (steps starts at 1, each pass it is in
        # adds one, and it leaves the pool at newton_steps); a pass with
        # more than C2 pending takes C2 of the at most B (newton_steps - 1)
        # steps left, and the pool only shrinks, so such passes come
        # first and number at most ceil(B (newton_steps - 1) / C2) (none
        # when B <= C2); once C2 or fewer are pending every pass takes
        # them all, and newton_steps - 1 passes empty the pool
        bound = newton_steps - 1
        if B > C2:
            bound += pass_count(B * (newton_steps - 1), C2)
        carry = gathered_loop(
            static, bound, lambda *c: c[-1] & (c[-2] < newton_steps),
            gathered_step, *carry)
        (X32, best, low, up, surf, apex, lam_lin, eta, seed_cls, steps,
         changed) = carry
        used_cls = seed_cls

    x, mu_new, s_new, _best_cls, x_res, lam_res, score = best
    return PolishResult(
        x=x, mu=mu_new, s=s_new, accept=score < 1.0, x_res=x_res,
        lam_res=lam_res, seed=X32, cls=used_cls,
    )
