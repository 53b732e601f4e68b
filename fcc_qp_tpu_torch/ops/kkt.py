"""KKT assembly and Schur-complement factorization of the f64 parity
engine (port of `fcc_qp_tpu/ops/kkt.py`).

The reference factors the dense symmetric-indefinite KKT matrix

    M = [[Q (+ rho*I),  A_eq^T],
         [A_eq,         0     ]]

once per solve and back-substitutes every ADMM iteration. The parity
engine instead forms the explicit inverse blocks by the Schur complement
(A_eq of full row rank):

    H = Q + rho*I,  S = A H^{-1} A^T,
    M^{-1} = [[F, G], [G^T, -S^{-1}]],
    W = H^{-1} A^T,  G = W S^{-1},  F = H^{-1} - W S^{-1} W^T

so that every ADMM primal update is one mat-vec ``x = x_const + rho F v``.
Where the reference falls back from LDLT to a rank-revealing
factorization, a Cholesky factor that does not exist is retried with
escalating diagonal shifts per instance, and a shifted factor is healed
by refinement against the true KKT.

All functions are batch-LEADING f64 (``(B, n, n)``, ``(B, n)``): the JAX
package writes them for one instance and vmaps them. `torch.linalg.
cholesky_ex` is the library factorization, as the JAX package leaves it
to XLA; the solves with its factors are batched triangular solves
(`ops.ds_linalg.chol_solve`, `_chol_inverse`), because the library's
`cholesky_solve` runs one cuSOLVER call per instance on the card.

``static=True`` makes a function read-free (the form a CUDA graph can
hold): each shift level after the first and the refinement is a
`ops.device_branch.branch` on its device flag (an IF node under a
capture, computed and selected otherwise); the results are the eager
ones bit for bit.
"""

from __future__ import annotations

import torch

from fcc_qp_tpu_torch.ops.device_branch import branch
from fcc_qp_tpu_torch.ops.ds_linalg import _chol_inverse, chol_solve


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _rho_col(rho, like: torch.Tensor) -> torch.Tensor:
    """rho as a (B, 1, 1) tensor (a scalar or (B,) per instance); a
    Python scalar is filled on the device, not copied from the host."""
    if not isinstance(rho, torch.Tensor):
        return torch.full((), rho, dtype=like.dtype, device=like.device)
    r = rho.to(like.device, like.dtype)
    return r.reshape(-1, 1, 1) if r.dim() else r


def assemble_kkt(Q: torch.Tensor, A_eq: torch.Tensor, rho) -> torch.Tensor:
    """``[[Q + rho*I, A'],[A, 0]]``, batch-leading (B, n+m, n+m)."""
    B, n, _ = Q.shape
    m = A_eq.shape[-2]
    M = Q.new_zeros((B, n + m, n + m))
    M[:, :n, :n] = Q + _rho_col(rho, Q) * _eye(n, Q)
    M[:, :n, n:] = A_eq.transpose(-1, -2)
    M[:, n:, :n] = A_eq
    return M


def _chol_or_regularized(M: torch.Tensor, return_shifted: bool = False,
                         static: bool = False):
    """Cholesky factor of each M, escalating Tikhonov shifts
    ``eps * {0, 1e2, 1e5, 1e8} * max(max|M|, 1)`` until it exists.

    A factor counts only if its squared pivots exceed ``1e3 * eps *
    scale``: an exactly singular M (the Schur complement of a
    rank-deficient A_eq) has roundoff pivots of either sign, and a
    positive one would pass as a finite factor of infinite condition.
    Instances that fail at every shift get zeros. With
    ``return_shifted`` also returns the per-instance flag that a shift
    was taken (or all failed). ``static``: each level after the first is
    a branch on whether any instance still needs it (no host read ends
    the escalation)."""
    B, n, _ = M.shape
    eps = torch.finfo(M.dtype).eps
    scale = torch.clamp_min(M.abs().amax(dim=(-1, -2)), 1.0)
    floor = 1e3 * eps * scale
    eye = _eye(n, M)

    def factor(shift):
        L, info = torch.linalg.cholesky_ex(M + shift[:, None, None] * eye)
        dg = torch.diagonal(L, dim1=-2, dim2=-1)
        ok = ((info == 0) & torch.isfinite(L).all(dim=(-1, -2))
              & (dg * dg > floor[:, None]).all(dim=-1))
        return L, ok

    def level(L, ok, attempts, mult):
        need = ~ok
        Lk, okk = factor(scale * eps * mult)
        return (torch.where(need[:, None, None], Lk, L), ok | (need & okk),
                attempts + need.int())

    # the unshifted factor: every instance needs it
    L, ok, attempts = level(
        torch.zeros_like(M), torch.zeros((B,), dtype=torch.bool,
                                         device=M.device),
        torch.zeros((B,), dtype=torch.int32, device=M.device), 0.0)
    for mult in (1e2, 1e5, 1e8):
        need = ~ok
        if static:
            L, ok, attempts = branch(
                need.any(), lambda *c, m=mult: level(*c, m), L, ok, attempts)
        elif bool(need.any()):
            L, ok, attempts = level(L, ok, attempts, mult)
        else:
            break
    L = torch.where(ok[:, None, None], L, torch.zeros_like(L))
    if return_shifted:
        # one attempt means the unshifted factor succeeded
        return L, (attempts > 1) | ~ok
    return L


def kkt_factor_blocks(Q: torch.Tensor, A_eq: torch.Tensor, rho,
                      static: bool = False):
    """Schur-complement factorization of the KKT matrix: the explicit
    inverse blocks ``F = M^{-1}[:n, :n]`` (B, n, n) and ``G =
    M^{-1}[:n, n:]`` (B, n, m). Instances whose factors took a shift are
    refined by four fixed-preconditioner Richardson steps against the
    true KKT (the shift's null-space error stays in the dual-dual block,
    which F and G never read; ``static``: a branch on whether any
    instance took a shift)."""
    B, n, _ = Q.shape
    m = A_eq.shape[-2]
    H = Q + _rho_col(rho, Q) * _eye(n, Q)
    L_H, sh_H = _chol_or_regularized(H, return_shifted=True, static=static)
    Hinv = _chol_inverse(L_H)
    At = A_eq.transpose(-1, -2)
    W = chol_solve(L_H, At)
    S = A_eq @ W
    L_S, sh_S = _chol_or_regularized(S, return_shifted=True, static=static)
    T = chol_solve(L_S, W.transpose(-1, -2))          # (B, m, n)
    F = Hinv - W @ T
    G = T.transpose(-1, -2)
    sh = sh_H | sh_S

    def refine(F, G):
        X0 = torch.cat([torch.cat([F, G], dim=-1),
                        torch.cat([T, -_chol_inverse(L_S)], dim=-1)], dim=-2)
        M = assemble_kkt(Q, A_eq, rho)
        eyeN = _eye(n + m, Q)
        X = X0
        for _ in range(4):
            X = X + X0 @ (eyeN - M @ X)
        sel = sh[:, None, None]
        return (torch.where(sel, X[:, :n, :n], F),
                torch.where(sel, X[:, :n, n:], G))

    F, G = branch(sh.any() if static else bool(sh.any()), refine, F, G)
    # row-major whichever block was taken (a selection is row-major, G a
    # transposed view), so that the products reading F and G round alike
    # on every path, a static solve's included
    return F.contiguous(), G.contiguous()


def kkt_solve(Q: torch.Tensor, A_eq: torch.Tensor, rho, r: torch.Tensor,
              s: torch.Tensor, static: bool = False) -> torch.Tensor:
    """Solve ``[[Q + rho*I, A'],[A, 0]] [x; y] = [r; s]`` for x (B, n):
    the single right-hand-side Schur solve of the presolve. Instances
    whose factors took a shift get four vector refinement steps against
    the true KKT (``static``: a branch on whether any instance took a
    shift, selected per instance)."""
    n = Q.shape[-1]
    H = Q + _rho_col(rho, Q) * _eye(n, Q)
    L_H, sh_H = _chol_or_regularized(H, return_shifted=True, static=static)
    mv = lambda M_, v_: (M_ @ v_[..., None])[..., 0]
    At = A_eq.transpose(-1, -2)
    W = chol_solve(L_H, At)
    S = A_eq @ W
    L_S, sh_S = _chol_or_regularized(S, return_shifted=True, static=static)

    def solve_once(rv, sv):
        u = chol_solve(L_H, rv[..., None])[..., 0]
        y = chol_solve(L_S, (mv(A_eq, u) - sv)[..., None])[..., 0]
        return u - mv(W, y), y

    x, y = solve_once(r, s)
    sh = sh_H | sh_S

    def refine(x):
        xv, yv = x, y
        for _ in range(4):
            rr = r - (mv(H, xv) + mv(At, yv))
            rs = s - mv(A_eq, xv)
            dx, dy = solve_once(rr, rs)
            xv, yv = xv + dx, yv + dy
        return (torch.where(sh[:, None], xv, x),)

    (x,) = branch(sh.any() if static else bool(sh.any()), refine, x)
    return x


def admm_operator(Q: torch.Tensor, b: torch.Tensor, A_eq: torch.Tensor,
                  b_eq: torch.Tensor, rho, static: bool = False):
    """The per-solve ADMM primal-update operator ``(F, x_const)`` (B, n,
    n) / (B, n): every iteration's primal update is ``x = x_const + rho F
    v`` with v = slack - dual, because the KKT right-hand side is ``[-b +
    rho v; b_eq]`` and only its first block changes."""
    F, G = kkt_factor_blocks(Q, A_eq, rho, static=static)
    mv = lambda M_, v_: (M_ @ v_[..., None])[..., 0]
    return F, -mv(F, b) + mv(G, b_eq)
