"""Batched dense linear algebra of the reduced engine's operator build.

Port of the hybrid-factorization part of `fcc_qp_tpu/ops/ds_linalg.py`.
The name is kept so each function's counterpart is easy to find, but
nothing here is double-single: where the JAX package carries f32 hi/lo
pairs (because the TPU has no f64 ALU) this module computes in native
f64, and where the JAX package is plain f32 (the Newton-Schulz inverse
seeds) it stays f32 with full-precision matmuls (TF32 is pinned off at
package import; a 10-bit-mantissa product leaves the seeds
non-contracting, the same trap as the TPU's single bf16 pass).

Layouts: problem data and ADMM-operator blocks are batch-LAST like the
JAX package's (``(n, m, B)`` matrices, ``(n, B)`` vectors). The dense
KKT matrices and f32 seeds that only feed batched matmuls are kept
batch-LEADING ``(B, N, N)``, which is what `torch.matmul` batches over
(the JAX package moves them to batch-leading around each matmul too).

``static=True`` makes the f64 Schur route read-free (the form a CUDA
graph can hold): each shift level and the extra refinement is a
`ops.device_branch.branch` on its device flag (an IF node under a
capture, a select otherwise); the results are the eager ones bit for
bit. Index tensors built from host column lists are cached per device
(`index_tensor`), so a solve that repeats a classification makes no
host-to-device copy.
"""

from __future__ import annotations

import numpy as np
import torch

from fcc_qp_tpu_torch.ops.device_branch import branch


# never evicted: a captured graph reads its index tensors by address, so
# one freed and reallocated would corrupt every later replay. It grows by
# one entry per distinct index list and device, a few per classification
# (a list of at most n indices each).
_INDEX_CACHE: dict = {}


def index_tensor(idx, device) -> torch.Tensor:
    """A long tensor of the host index list ``idx`` on ``device``, made
    once per (indices, device) and cached: built outside a graph
    capture, it is reused inside one without a host-to-device copy."""
    key = (tuple(int(i) for i in idx), str(torch.device(device)))
    t = _INDEX_CACHE.get(key)
    if t is None:
        t = torch.as_tensor(np.asarray(key[0], dtype=np.int64),
                            device=device)
        _INDEX_CACHE[key] = t
    return t


# the floor of every capacity gather of the reduced path: a gathered
# pass takes ``min(B, max(CAPACITY_FLOOR, B // 8))`` instances
# (`gather_capacity`: the cold seed rebuilds, the polish continuation,
# the retry rounds) or ``min(B, CAPACITY_FLOOR)`` (`exact_capacity`: the
# lazy exact build). The capacities are the JAX package's, and they set
# the sub-batch each batched product rounds in; read at call time, so a
# test may lower the floor
CAPACITY_FLOOR = 128


def gather_capacity(B: int) -> int:
    """Instances a gathered pass takes from a batch of ``B``."""
    return min(B, max(CAPACITY_FLOOR, B // 8))


def exact_capacity(B: int) -> int:
    """Instances a pass of the lazy exact build takes."""
    return min(B, CAPACITY_FLOOR)


def pass_count(B: int, C: int) -> int:
    """Gathered passes that cover a batch of ``B`` at ``C`` a pass."""
    return -(-B // C)


def matvec_ds(F: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Mat-vec, batch-last: F (n_j, n_i, B) j-major, v (n_j, B) ->
    (n_i, B) with ``y[i] = sum_j F[j, i] v[j]``."""
    return torch.einsum("jib,jb->ib", F, v)


def transpose_ds(X: torch.Tensor) -> torch.Tensor:
    """Swap the two leading (feature) axes; the batch axis stays last."""
    return X.transpose(0, 1)


def _rho_vec(rho: torch.Tensor, n: int) -> torch.Tensor:
    """Per-coordinate penalty, batch-leading (B, n): rho may be (B,)
    uniform or (n, B) per-coordinate (partial splitting)."""
    if rho.dim() == 1:
        return rho[:, None].expand(rho.shape[0], n)
    return rho.transpose(0, 1)


def assemble_kkt_ds(Q: torch.Tensor, A: torch.Tensor, rho: torch.Tensor):
    """Full KKT matrix [[Q + diag(rho), A'],[A, 0]] in the dtype of Q
    (f64 here), from batch-last Q (n, n, B) / A (m, n, B); returned
    batch-LEADING (B, n+m, n+m). rho (B,) uniform or (n, B)."""
    n, _, B = Q.shape
    m = A.shape[0]
    Qb = Q.permute(2, 0, 1)
    Ab = A.permute(2, 0, 1)
    M = Q.new_zeros((B, n + m, n + m))
    M[:, :n, :n] = Qb
    idx = torch.arange(n, device=Q.device)
    M[:, idx, idx] += _rho_vec(rho, n).to(Q.dtype)
    M[:, :n, n:] = Ab.transpose(1, 2)
    M[:, n:, :n] = Ab
    return M


# ---------------------------------------------------------------------------
# hybrid f32-seed factorization: batched f32 matmuls build an inverse seed
# of the KKT, then f64 refinement of only the blocks the ADMM loop needs.
# ---------------------------------------------------------------------------


def spd_inverse_ns_f32(H: torch.Tensor, iters: int = 30) -> torch.Tensor:
    """Batched f32 SPD inverse by Newton-Schulz iteration (batch-leading
    (B, n, n)): X0 = H' / ||H||_F^2, then X <- X (2I - H X). Linear until
    the residual drops below ~1, then quadratic."""
    n = H.shape[-1]
    fro2 = (H * H).sum(dim=(-1, -2))
    X = H.transpose(-1, -2) * (1.0 / torch.clamp_min(fro2, 1e-30))[:, None, None]
    eye2 = 2.0 * torch.eye(n, dtype=H.dtype, device=H.device)
    for _ in range(iters):
        X = X @ (eye2 - H @ X)
    return X


def _resid_inf(P: torch.Tensor, eye: torch.Tensor) -> torch.Tensor:
    """``||I - M X||_inf`` from P = M X; non-finite products report inf."""
    r = (P - eye).abs().sum(dim=-1).amax(dim=-1)
    return torch.where(torch.isfinite(r), r, torch.full_like(r, float("inf")))


def _ns_polish_guarded(X: torch.Tensor, Mb: torch.Tensor, steps: int):
    """Guarded Newton-Schulz polish of an f32 inverse iterate against Mb
    (batch-leading). Keeps the best-residual iterate per instance (NS
    squares the residual UP when >= 1) and returns ``(X_best, resid)``."""
    N = Mb.shape[-1]
    eye = torch.eye(N, dtype=Mb.dtype, device=Mb.device)
    eye2 = 2.0 * eye
    P = Mb @ X
    r_best = _resid_inf(P, eye)
    X_best = X
    for _ in range(steps):
        X = X @ (eye2 - P)
        P = Mb @ X
        r = _resid_inf(P, eye)
        better = r < r_best
        X_best = torch.where(better[:, None, None], X, X_best)
        r_best = torch.minimum(r, r_best)
    return X_best, r_best


def kkt_inverse_f32_seed(
    Q: torch.Tensor, A: torch.Tensor, rho: torch.Tensor, delta: float = 1e-2
):
    """f32 inverse SEED of the KKT [[Q + diag(rho), A'],[A, 0]].

    Q (n, n, B), A (m, n, B) batch-last (any float dtype; rounded to
    f32), rho (B,) or (n, B) f32. Returns ``(X, resid)``: X (B, N, N) f32
    batch-LEADING, and the per-instance inf-norm estimate of ``I - M X``
    against the TRUE KKT, so callers can route non-contracting instances
    to a robust fallback.

    The Schur route inverts a DELTA-REGULARIZED KKT (the (1,1) block of
    an OSC problem can be near-singular while the full KKT is not) with
    two Newton-Schulz SPD inverses, then three guarded NS steps against
    the true KKT polish the delta away.
    """
    n, _, B = Q.shape
    Qb = Q.permute(2, 0, 1).float()
    Ab = A.permute(2, 0, 1).float()
    dvec = _rho_vec(rho, n).float()
    eye_n = torch.eye(n, dtype=torch.float32, device=Q.device)
    H = Qb + dvec[:, :, None] * eye_n
    dscale = delta * H.abs().amax(dim=(-1, -2))
    H = H + dscale[:, None, None] * eye_n

    Hinv = spd_inverse_ns_f32(H)
    At = Ab.transpose(-1, -2)
    W = Hinv @ At                        # (B, n, m)
    S = Ab @ W                           # (B, m, m)
    Sinv = spd_inverse_ns_f32(S)
    T = Sinv @ W.transpose(-1, -2)       # (B, m, n)
    F = Hinv - W @ T
    G = T.transpose(-1, -2)
    X = torch.cat(
        [torch.cat([F, G], dim=-1), torch.cat([T, -Sinv], dim=-1)], dim=-2
    )

    return _ns_polish_guarded(X, _kkt_f32(Qb, Ab, dvec), steps=3)


def _kkt_f32(Qb: torch.Tensor, Ab: torch.Tensor, dvec: torch.Tensor):
    """The true (unregularized) f32 KKT [[Q + diag(rho), A'],[A, 0]],
    batch-leading (B, N, N), from batch-leading f32 Qb (B, n, n), Ab
    (B, m, n) and dvec (B, n)."""
    B, n, _ = Qb.shape
    m = Ab.shape[1]
    eye_n = torch.eye(n, dtype=torch.float32, device=Qb.device)
    Mb = Qb.new_zeros((B, n + m, n + m))
    Mb[:, :n, :n] = Qb + dvec[:, :, None] * eye_n
    Mb[:, :n, n:] = Ab.transpose(-1, -2)
    Mb[:, n:, :n] = Ab
    return Mb


def kkt_inverse_f32_refresh(
    X_prev: torch.Tensor, Q: torch.Tensor, A: torch.Tensor,
    rho: torch.Tensor, steps: int = 3,
):
    """Refresh a carried f32 KKT inverse seed against the CURRENT
    (unregularized) KKT: the warm-operator path of sequential replay
    (`fcc_qp_tpu.ops.ds_linalg.kkt_inverse_f32_refresh`).

    A control-rate replay moves (Q, A_eq) by ~0.1% a step, so the
    previous step's inverse has an NS residual far below 1, and a few
    guarded Newton-Schulz steps restore it to the f32 floor in place of
    the Schur seed build. X_prev (B, N, N) f32 batch-LEADING; Q, A, rho
    as for `kkt_inverse_f32_seed`, whose contract this shares: returns
    ``(X, resid)``, and callers route instances with a large residual
    (the data jumped) to the same fallback.
    """
    n = Q.shape[0]
    Mb = _kkt_f32(Q.permute(2, 0, 1).float(), A.permute(2, 0, 1).float(),
                  _rho_vec(rho, n).float())
    return _ns_polish_guarded(X_prev, Mb, steps=steps)


def refine_inverse_columns_ds(
    X32: torch.Tensor, M: torch.Tensor, cols, passes: int = 2
) -> torch.Tensor:
    """Selected columns of M^{-1} to f64 accuracy from an f32 seed.

    Per pass the residual R = E_cols - M C is computed in f64 (it carries
    the correction) and the correction X32 @ R runs as one f32 matmul.
    X32 (B, N, N) f32, M (B, N, N) f64 -> C (B, N, k) f64.
    """
    cols_t = index_tensor(cols, M.device)
    N = M.shape[-1]
    C = X32[:, :, cols_t].double()
    E = torch.eye(N, dtype=M.dtype, device=M.device)[:, cols_t]
    for _ in range(passes):
        R = E - M @ C
        C = C + (X32 @ R.float()).double()
    return C


def solve_from_seed_ds(
    X32: torch.Tensor, M: torch.Tensor, r: torch.Tensor, passes: int = 2
) -> torch.Tensor:
    """f64-accurate solve M x = r via the f32 inverse seed + iterative
    refinement with f64 residuals. X32/M batch-leading (B, N, N); r and
    the result batch-last (N, B)."""

    def apply32(v: torch.Tensor) -> torch.Tensor:
        return (X32 @ v.float().transpose(0, 1)[:, :, None])[:, :, 0].T

    x = apply32(r).double()
    for _ in range(passes):
        resid = r - (M @ x.T[:, :, None])[:, :, 0].T
        x = x + apply32(resid).double()
    return x


# ---------------------------------------------------------------------------
# f64 Schur-Cholesky fallback for instances the hybrid seed cannot serve
# (the JAX package's all-ds Schur route, `kkt_inverse_blocks_refined_ds`).
# ---------------------------------------------------------------------------


def _jacobi_kkt_scales(H: torch.Tensor, A: torch.Tensor, sweeps: int = 3):
    """Ruiz equilibration scales (d (B, n), e (B, m)) of [[H, A'],[A, 0]]
    from batch-leading H (B, n, n), A (B, m, n): each sweep divides by
    the sqrt of the scaled column max-abs norm over the full KKT column."""
    B, n, _ = H.shape
    m = A.shape[1]
    absH, absA = H.abs(), A.abs()
    d = H.new_ones((B, n))
    e = H.new_ones((B, m))
    for _ in range(sweeps):
        ch = (absH * d[:, None, :]).amax(dim=2) * d
        if m:
            ca = (absA * e[:, :, None]).amax(dim=1) * d
            c = torch.maximum(ch, ca)
            g = (absA * d[:, None, :]).amax(dim=2) * e
            e = e * torch.where(g > 0, torch.rsqrt(torch.clamp_min(g, 1e-30)), 1.0)
        else:
            c = ch
        d = d * torch.where(c > 0, torch.rsqrt(torch.clamp_min(c, 1e-30)), 1.0)
    return d, e


def _chol_regularized(H: torch.Tensor, static: bool = False):
    """Batched Cholesky with escalating relative diagonal shifts; the
    last level (2n) makes the shifted matrix diagonally dominant, so a
    factor always exists. Pivot-based detection: a factor whose squared
    pivots fall below 1e-11 * scale counts as failed. ``static``: each
    level is a branch on whether any instance still needs it. Returns
    ``(L, shifted)``."""
    B, n, _ = H.shape
    scale = torch.clamp_min(H.abs().amax(dim=(-1, -2)), 1.0)
    eye = torch.eye(n, dtype=H.dtype, device=H.device)

    def factor(shift):
        L, info = torch.linalg.cholesky_ex(H + shift[:, None, None] * eye)
        dg = torch.diagonal(L, dim1=-2, dim2=-1)
        ok = (
            (info == 0)
            & torch.isfinite(L).all(dim=(-1, -2))
            & (dg * dg > 1e-11 * scale[:, None]).all(dim=-1)
        )
        return L, ok

    L, ok = factor(torch.zeros_like(scale))
    shifted = torch.zeros_like(ok)
    for delta in (1e-10, 1e-8, 1e-6, 1e-4, 1e-2, 2.0 * n):
        need = ~ok

        def level(L, ok, shifted, need=need, delta=delta):
            L2, ok2 = factor(torch.where(need, delta * scale, 0.0))
            return (torch.where(need[:, None, None], L2, L), ok | (need & ok2),
                    shifted | need)

        if static:
            L, ok, shifted = branch(need.any(), level, L, ok, shifted)
        elif bool(need.any()):
            L, ok, shifted = level(L, ok, shifted)
        else:
            break
    return L, shifted


def _kkt_inverse_core(H: torch.Tensor, A: torch.Tensor, refine_steps: int,
                      static: bool = False):
    """Full inverse of [[H, A'],[A, 0]] (batch-leading, f64) by Schur
    factorization plus fixed-preconditioner refinement against the true
    KKT; six extra passes on the whole batch when any instance needed a
    shift (``static``: a branch on that flag)."""
    B, n, _ = H.shape
    m = A.shape[1]
    L, sh_H = _chol_regularized(H, static)
    Hinv = _chol_inverse(L)
    W = Hinv @ A.transpose(1, 2)                     # (B, n, m)
    S = A @ W
    Ls, sh_S = _chol_regularized(S, static)
    Sinv = _chol_inverse(Ls)
    T = Sinv @ W.transpose(1, 2)                     # (B, m, n)
    X = torch.cat(
        [torch.cat([Hinv - W @ T, T.transpose(1, 2)], dim=-1),
         torch.cat([T, -Sinv], dim=-1)],
        dim=-2,
    )
    M = H.new_zeros((B, n + m, n + m))
    M[:, :n, :n] = H
    M[:, :n, n:] = A.transpose(1, 2)
    M[:, n:, :n] = A
    eye = torch.eye(n + m, dtype=H.dtype, device=H.device)
    X0 = X
    for _ in range(refine_steps):
        X = X + X0 @ (eye - M @ X)

    def extra(X):
        for _ in range(6):
            X = X + X0 @ (eye - M @ X)
        return (X,)

    shifted = (sh_H | sh_S).any()
    (X,) = branch(shifted if static else bool(shifted), extra, X)
    return X


def _chol_inverse(L: torch.Tensor) -> torch.Tensor:
    """``(L L')^{-1}`` from the batched lower factor L, as ``L^{-T}
    L^{-1}`` by one batched triangular solve (cuBLAS on the card; the
    library's `cholesky_inverse` runs one cuSOLVER call per instance
    there, three graph nodes and ~50 us each)."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    return Linv.transpose(-1, -2) @ Linv


def chol_solve(L: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """``(L L')^{-1} R`` from the batched lower factor L by two batched
    triangular solves (cuBLAS on the card; the library's
    `cholesky_solve` runs one cuSOLVER call per instance there, as
    `cholesky_inverse` does)."""
    Y = torch.linalg.solve_triangular(L, R, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), Y, upper=True)


def kkt_inverse_blocks_refined_ds(
    Q: torch.Tensor, A: torch.Tensor, rho: torch.Tensor, refine_steps: int = 1,
    static: bool = False,
):
    """Inverse blocks (F, G) of [[Q + diag(rho), A'],[A, 0]]: F =
    M^{-1}[:n, :n], G = M^{-1}[:n, n:], batch-last like the inputs
    (Q (n, n, B), A (m, n, B), f64). Internal Jacobi equilibration keeps
    the route robust to unequilibrated data; this is the fallback for
    instances whose f32 seed did not contract."""
    n = Q.shape[0]
    Hb = Q.permute(2, 0, 1).clone()
    idx = torch.arange(n, device=Q.device)
    Hb[:, idx, idx] += _rho_vec(rho, n).to(Q.dtype)
    Ab = A.permute(2, 0, 1)
    d, e = _jacobi_kkt_scales(Hb, Ab)
    Hs = d[:, :, None] * Hb * d[:, None, :]
    As = e[:, :, None] * Ab * d[:, None, :]
    Xs = _kkt_inverse_core(Hs, As, refine_steps, static)
    p = torch.cat([d, e], dim=1)
    X = p[:, :, None] * Xs * p[:, None, :]
    F = X[:, :n, :n].permute(1, 2, 0)
    G = X[:, :n, n:].permute(1, 2, 0)
    return F, G


def kkt_solve_refined_ds(Q: torch.Tensor, A: torch.Tensor, r: torch.Tensor,
                         s: torch.Tensor, delta_rel: float = 1e-6,
                         refine_steps: int = 8,
                         static: bool = False) -> torch.Tensor:
    """Accurate f64 solve of the UNREGULARIZED KKT system for x,

        [[Q, A'],[A, 0]] [x; y] = [r; s]

    (the reference presolve; port of the JAX package's
    `kkt_solve_refined_ds`). The raw Schur route loses the solve when
    kappa(S) >> kappa(KKT), so this factors a delta-regularized KKT
    (``Q + delta_rel * max(max|Q|, 1) * I``, a benign Schur complement)
    behind Jacobi equilibration and runs ``refine_steps`` steps of vector
    iterative refinement against the TRUE KKT, contracting at about
    ``delta * ||KKT^{-1}||`` per step. Batch-last like the problem data:
    Q (n, n, B), A (m, n, B), r (n, B), s (m, B) -> x (n, B)."""
    n = Q.shape[0]
    Qb = Q.permute(2, 0, 1)
    Ab = A.permute(2, 0, 1)
    d, e = _jacobi_kkt_scales(Qb, Ab)
    Qs = d[:, :, None] * Qb * d[:, None, :]
    As = e[:, :, None] * Ab * d[:, None, :]
    rs = (r.T * d)[:, :, None]                       # (B, n, 1)
    ss = (s.T * e)[:, :, None]                       # (B, m, 1)

    scale = torch.clamp_min(Qs.abs().amax(dim=(-1, -2)), 1.0)
    eye = torch.eye(n, dtype=Q.dtype, device=Q.device)
    L, _ = _chol_regularized(Qs + (delta_rel * scale)[:, None, None] * eye,
                             static)
    At = As.transpose(1, 2)
    W = chol_solve(L, At)                            # (B, n, m)
    Ls, _ = _chol_regularized(As @ W, static)

    def solve_delta(rv, sv):
        u = chol_solve(L, rv)
        y = chol_solve(Ls, As @ u - sv)
        return u - W @ y, y

    x, y = solve_delta(rs, ss)
    for _ in range(refine_steps):
        dx, dy = solve_delta(rs - (Qs @ x + At @ y), ss - As @ x)
        x, y = x + dx, y + dy
    return (x[:, :, 0] * d).T.contiguous()
