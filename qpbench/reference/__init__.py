"""The plain reference: the friction-cone QP solved by a primal-dual
interior-point method in plain PyTorch, batched, in a dtype of the
caller's choice.

    minimize    1/2 z'Qz + b'z
    subject to  A_eq z = b_eq
                lb <= z <= ub                       (finite entries only)
                ||(z[3i], z[3i+1])|| <= mu_i z[3i+2]  for the contact
                triples of z[ls:ls + nc]

This is the program's problem (the reference npz schema), solved by an
independent method: no ADMM, no scaling, no polish. The cone constraints
are second-order cones of the variables (mu f_z, f_x, f_y), the bounds a
nonnegative orthant; the iteration is the standard Mehrotra
predictor-corrector with Nesterov-Todd scaling (Vandenberghe, "The
CVXOPT linear and quadratic cone program solvers", 2010, sections 1-4),
one LU factorization of the reduced KKT matrix per iteration. Instances
that converge are frozen; an instance whose iterate turns non-finite (a
low-precision run at its floor) keeps its last finite iterate.

Imports nothing but torch.
"""

from __future__ import annotations

import dataclasses

import torch

# an instance stops when its relative residuals and relative gap are
# below TOL, and counts as solved when its best iterate is below SOLVED:
# the f64 iteration's floor on these problems lies at 1e-11 to 2e-8 (a
# cone at its apex)
TOL = 1e-11
SOLVED = 1e-7
MAX_ITER = 60
# fraction of the step to the boundary of the cone
STEP = 0.99


@dataclasses.dataclass
class Result:
    z: torch.Tensor          # (B, n) in the dtype of the solve
    converged: torch.Tensor  # (B,) bool: residual below SOLVED
    # (B,) the returned iterate's largest relative residual or gap
    residual: torch.Tensor


class _Cone:
    """Index maps of one problem shape: which variables carry finite
    upper / lower bounds, and the (f_z, f_x, f_y) index of each cone."""

    def __init__(self, lb, ub, ls: int, nc: int):
        fu = torch.isfinite(ub)
        fl = torch.isfinite(lb)
        if not (bool((fu == fu[:1]).all()) and bool((fl == fl[:1]).all())):
            raise ValueError("every instance must bound the same variables")
        dev = lb.device
        self.iu = torch.nonzero(fu[0]).flatten()
        self.il = torch.nonzero(fl[0]).flatten()
        self.p = len(self.iu) + len(self.il)
        k = nc // 3
        base = ls + 3 * torch.arange(k, device=dev)
        # a cone's s vector is (mu f_z, f_x, f_y)
        self.ic = torch.stack([base + 2, base, base + 1], dim=1)  # (K, 3)
        self.K = k


def _jordan(u_l, u_c, v_l, v_c):
    """The Jordan product u o v, linear part and cone part."""
    w0 = (u_c * v_c).sum(-1, keepdim=True)
    w1 = u_c[..., :1] * v_c[..., 1:] + v_c[..., :1] * u_c[..., 1:]
    return u_l * v_l, torch.cat([w0, w1], dim=-1)


def _jordan_div(lam_l, lam_c, r_l, r_c):
    """u with lam o u = r."""
    l0, l1 = lam_c[..., :1], lam_c[..., 1:]
    r0, r1 = r_c[..., :1], r_c[..., 1:]
    det = l0 * l0 - (l1 * l1).sum(-1, keepdim=True)
    u0 = (l0 * r0 - (l1 * r1).sum(-1, keepdim=True)) / det
    u1 = (r1 - u0 * l1) / l0
    return r_l / lam_l, torch.cat([u0, u1], dim=-1)


def _step_to_boundary(s_l, s_c, d_l, d_c):
    """The largest alpha >= 0 with s + alpha d in the cone (inf where
    none binds), per instance."""
    big = torch.full(s_l.shape[:1], float("inf"), dtype=s_l.dtype,
                     device=s_l.device)
    if s_l.shape[1]:
        a_l = torch.where(d_l < 0, -s_l / d_l, torch.full_like(s_l, float("inf")))
        big = torch.minimum(big, a_l.amin(-1))
    s0, s1 = s_c[..., 0], s_c[..., 1:]
    d0, d1 = d_c[..., 0], d_c[..., 1:]
    a = d0 * d0 - (d1 * d1).sum(-1)
    bh = s0 * d0 - (s1 * d1).sum(-1)
    c = s0 * s0 - (s1 * s1).sum(-1)
    disc = bh * bh - a * c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    q = -(bh + torch.where(bh >= 0, sq, -sq))
    inf = torch.full_like(a, float("inf"))
    r1 = torch.where(a != 0, q / torch.where(a != 0, a, 1.0), inf)
    r2 = torch.where(q != 0, c / torch.where(q != 0, q, 1.0), inf)
    pos = lambda r: torch.where(r > 0, r, inf)
    roots = torch.minimum(pos(r1), pos(r2))
    roots = torch.where(disc >= 0, roots, inf)
    lin = torch.where(d0 < 0, -s0 / torch.where(d0 < 0, d0, -1.0), inf)
    per_cone = torch.minimum(roots, lin)
    if per_cone.shape[1]:
        big = torch.minimum(big, per_cone.amin(-1))
    return big


class _Problem:
    """The problem's operators in one dtype: G, G', h and the objective."""

    def __init__(self, qp: dict, ls: int, nc: int, dtype):
        self.Q = qp["Q"].to(dtype)
        self.q = qp["b"].to(dtype)
        self.A = qp["A_eq"].to(dtype)
        self.beq = qp["b_eq"].to(dtype)
        self.mu = qp["friction_coeffs"].to(dtype)
        lb, ub = qp["lb"], qp["ub"]
        self.cone = _Cone(lb, ub, ls, nc)
        c = self.cone
        self.h_l = torch.cat([ub[:, c.iu], -lb[:, c.il]], dim=1).to(dtype)
        self.B, self.n = self.q.shape
        self.m = self.beq.shape[1]

    def G(self, x):
        """(G x) as (linear part (B, p), cone part (B, K, 3))."""
        c = self.cone
        g_l = torch.cat([x[:, c.iu], -x[:, c.il]], dim=1)
        xc = x[:, c.ic]                                       # (B, K, 3)
        g_c = -torch.cat([self.mu[..., None] * xc[..., :1], xc[..., 1:]],
                         dim=-1)
        return g_l, g_c

    def Gt(self, v_l, v_c):
        """G' v, (B, n)."""
        c = self.cone
        out = torch.zeros((self.B, self.n), dtype=v_l.dtype,
                          device=v_l.device)
        nu = len(c.iu)
        out[:, c.iu] += v_l[:, :nu]
        out[:, c.il] -= v_l[:, nu:]
        vc = torch.cat([self.mu[..., None] * v_c[..., :1], v_c[..., 1:]],
                       dim=-1)
        out.scatter_add_(1, c.ic.reshape(1, -1).expand(self.B, -1),
                         -vc.reshape(self.B, -1))
        return out

    def objective(self, x):
        return 0.5 * (x * (self.Q @ x[..., None])[..., 0]).sum(-1) + (
            self.q * x).sum(-1)


def _nt_scaling(s_c, z_c):
    """Nesterov-Todd scaling of each cone: W, W^{-1} (B, K, 3, 3) and
    lambda = W z."""
    J = torch.tensor([1.0, -1.0, -1.0], dtype=s_c.dtype, device=s_c.device)

    def jnorm2(u):
        # u0^2 - |u1|^2 as a product, which keeps its relative accuracy
        # near the cone's boundary
        r = torch.linalg.vector_norm(u[..., 1:], dim=-1, keepdim=True)
        return (u[..., :1] - r) * (u[..., :1] + r)

    sJs = jnorm2(s_c)
    zJz = jnorm2(z_c)
    sb = s_c / torch.sqrt(sJs)
    zb = z_c / torch.sqrt(zJz)
    gamma = torch.sqrt((1.0 + (sb * zb).sum(-1, keepdim=True)) / 2.0)
    wb = (sb + J * zb) / (2.0 * gamma)
    beta = torch.sqrt(torch.sqrt(sJs / zJz))                  # (B, K, 1)
    v = wb.clone()
    v[..., 0] += 1.0
    v = v / torch.sqrt(2.0 * (wb[..., :1] + 1.0))
    Jm = torch.diag(J)
    vv = v[..., :, None] * v[..., None, :]
    W = beta[..., None] * (2.0 * vv - Jm)
    Jv = J * v
    Winv = (2.0 * Jv[..., :, None] * Jv[..., None, :] - Jm) / beta[..., None]
    lam = (W @ z_c[..., None])[..., 0]
    return W, Winv, lam


def solve(qp: dict, ls: int, nc: int, dtype=torch.float64,
          tol: float = TOL, max_iter: int = MAX_ITER) -> Result:
    """Solve every QP of the batch-leading dict ``qp`` (the reference
    npz schema's keys, tensors on one device) in ``dtype``. ``ls`` /
    ``nc``: the contact-force segment ``z[ls:ls + nc]``."""
    P = _Problem(qp, ls, nc, dtype)
    c = P.cone
    B, n, m, p, K = P.B, P.n, P.m, c.p, c.K
    dev = P.q.device
    one_c = torch.zeros((B, K, 3), dtype=dtype, device=dev)
    one_c[..., 0] = 1.0
    deg = float(p + K)
    nu = len(c.iu)
    D = torch.cat([P.mu[..., None], torch.ones((B, K, 2), dtype=dtype,
                                               device=dev)], dim=-1)

    def kkt(H):
        M = torch.zeros((B, n + m, n + m), dtype=dtype, device=dev)
        M[:, :n, :n] = H
        M[:, :n, n:] = P.A.transpose(1, 2)
        M[:, n:, :n] = P.A
        return torch.linalg.lu_factor(M)

    def kkt_solve(F, rx, ry):
        sol = torch.linalg.lu_solve(*F, torch.cat([rx, ry], 1)[..., None])
        return sol[:, :n, 0], sol[:, n:, 0]

    def hessian(wl2inv, Winv2):
        """Q + G' W^{-2} G."""
        H = P.Q.clone()
        d = torch.zeros((B, n), dtype=dtype, device=dev)
        d[:, c.iu] += wl2inv[:, :nu]
        d[:, c.il] += wl2inv[:, nu:]
        H = H + torch.diag_embed(d)
        blk = D[..., :, None] * Winv2 * D[..., None, :]       # (B, K, 3, 3)
        ii = c.ic[:, :, None].expand(K, 3, 3).reshape(-1)
        jj = c.ic[:, None, :].expand(K, 3, 3).reshape(-1)
        H[:, ii, jj] += blk.reshape(B, -1)
        return H

    # start: the least-squares point of the slacks, shifted into the cone
    F0 = kkt(hessian(torch.ones((B, p), dtype=dtype, device=dev),
                     torch.eye(3, dtype=dtype, device=dev).expand(B, K, 3,
                                                                  3)))
    x, y = kkt_solve(F0, -P.q + P.Gt(P.h_l, one_c * 0.0), P.beq)
    g_l, g_c = P.G(x)
    s_l, s_c = P.h_l - g_l, -g_c

    def shift(v_l, v_c):
        mins = [v_c[..., 0] - torch.linalg.vector_norm(v_c[..., 1:], dim=-1)]
        if v_l.shape[1]:
            mins.append(v_l)
        mn = torch.cat(mins, dim=1).amin(1)
        a = torch.clamp_min(1.0 - mn, 0.0)[:, None]
        return v_l + a, v_c + a[..., None] * one_c

    s_l, s_c = shift(s_l, s_c)
    z_l, z_c = torch.ones_like(s_l), one_c.clone()
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    scale_q = 1.0 + P.q.abs().amax(1)
    scale_b = 1.0 + P.beq.abs().amax(1)
    scale_h = 1.0 + (P.h_l.abs().amax(1) if p else 0.0)
    best = torch.full((B,), float("inf"), dtype=dtype, device=dev)
    best_x = x
    for it in range(max_iter + 1):
        g_l, g_c = P.G(x)
        rx = (P.Q @ x[..., None])[..., 0] + P.q + (
            P.A.transpose(1, 2) @ y[..., None])[..., 0] + P.Gt(z_l, z_c)
        ry = (P.A @ x[..., None])[..., 0] - P.beq
        rz_l = g_l + s_l - P.h_l
        rz_c = g_c + s_c
        gap = (s_l * z_l).sum(1) + (s_c * z_c).sum((1, 2))
        obj = P.objective(x).abs()
        res = torch.stack([
            rx.abs().amax(1) / scale_q, ry.abs().amax(1) / scale_b,
            torch.cat([rz_l.abs().amax(1, keepdim=True) if p else
                       torch.zeros((B, 1), dtype=dtype, device=dev),
                       rz_c.abs().amax((1, 2))[:, None]], 1).amax(1)
            / scale_h,
            gap / (1.0 + obj)], 1)
        res = res.amax(1)
        # the iteration can wander near its floor: keep each instance's
        # best iterate
        better = res < best
        best = torch.where(better, res, best)
        best_x = torch.where(better[:, None], x, best_x)
        done = done | (res < tol)
        if it == max_iter or bool(done.all()):
            break
        mu_gap = gap / deg

        wl = torch.sqrt(s_l / z_l)
        lam_l = torch.sqrt(s_l * z_l)
        W, Winv, lam_c = _nt_scaling(s_c, z_c)
        Winv2 = Winv @ Winv
        F = kkt(hessian(1.0 / (wl * wl), Winv2))

        def direction(bs_l, bs_c):
            # rhs: (-rx, -ry, -rz, bs); returns (dx, dy, dz, ds)
            u_l, u_c = _jordan_div(lam_l, lam_c, bs_l, bs_c)
            t_l = -rz_l - wl * u_l
            t_c = -rz_c - (W @ u_c[..., None])[..., 0]
            w2t_l = t_l / (wl * wl)
            w2t_c = (Winv2 @ t_c[..., None])[..., 0]
            dx, dy = kkt_solve(F, -rx + P.Gt(w2t_l, w2t_c), -ry)
            gd_l, gd_c = P.G(dx)
            dz_l = (gd_l - t_l) / (wl * wl)
            dz_c = (Winv2 @ (gd_c - t_c)[..., None])[..., 0]
            # the slack step from the linear equation G dx + ds = -rz,
            # which keeps the primal residual at rounding where W is
            # badly conditioned (a cone at its apex)
            ds_l = -rz_l - gd_l
            ds_c = -rz_c - gd_c
            return dx, dy, dz_l, dz_c, ds_l, ds_c

        ll_l, ll_c = _jordan(lam_l, lam_c, lam_l, lam_c)
        a_dx, a_dy, a_dzl, a_dzc, a_dsl, a_dsc = direction(-ll_l, -ll_c)
        alpha = torch.minimum(_step_to_boundary(s_l, s_c, a_dsl, a_dsc),
                              _step_to_boundary(z_l, z_c, a_dzl, a_dzc))
        alpha = torch.clamp(alpha, max=1.0)[:, None]
        mu_aff = ((s_l + alpha * a_dsl) * (z_l + alpha * a_dzl)).sum(1) + (
            (s_c + alpha[..., None] * a_dsc)
            * (z_c + alpha[..., None] * a_dzc)).sum((1, 2))
        sigma = torch.clamp(mu_aff / gap, 0.0, 1.0) ** 3
        # the second-order term in the scaled coordinates
        ws_l = a_dsl / wl
        ws_c = (Winv @ a_dsc[..., None])[..., 0]
        wz_l = wl * a_dzl
        wz_c = (W @ a_dzc[..., None])[..., 0]
        cr_l, cr_c = _jordan(ws_l, ws_c, wz_l, wz_c)
        sm = (sigma * mu_gap)[:, None]
        dx, dy, dzl, dzc, dsl, dsc = direction(
            -ll_l - cr_l + sm, -ll_c - cr_c + sm[..., None] * one_c)
        alpha = torch.minimum(_step_to_boundary(s_l, s_c, dsl, dsc),
                              _step_to_boundary(z_l, z_c, dzl, dzc))
        alpha = torch.clamp(STEP * alpha, max=1.0)
        a1, a2 = alpha[:, None], alpha[:, None, None]
        new = (x + a1 * dx, y + a1 * dy, s_l + a1 * dsl, s_c + a2 * dsc,
               z_l + a1 * dzl, z_c + a2 * dzc)
        ok = ~done
        for v in new:
            ok = ok & torch.isfinite(v.reshape(B, -1)).all(1)
        done = done | ~torch.isfinite(alpha)
        keep1, keep2 = ok[:, None], ok[:, None, None]
        x = torch.where(keep1, new[0], x)
        y = torch.where(keep1, new[1], y)
        s_l = torch.where(keep1, new[2], s_l)
        s_c = torch.where(keep2, new[3], s_c)
        z_l = torch.where(keep1, new[4], z_l)
        z_c = torch.where(keep2, new[5], z_c)
        # a low-precision run stops where its iterate would leave the
        # finite numbers
        done = done | ~ok
    return Result(z=best_x, converged=best < SOLVED, residual=best)
