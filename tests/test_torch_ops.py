"""Port parity of the operator-level modules on a Cassie batch (B=64):
projections, Ruiz scaling, the f32 KKT seed, the f64 refinement of
inverse columns and constant term, and the polish classification.

The same numpy data (the JAX package's generator, seed fixed) goes to
both packages; JAX gets its double-single hi/lo split, the port f64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fcc_qp_tpu.ops.ds as ds
from fcc_qp_tpu.core import ds_engine as jeng
from fcc_qp_tpu.models.osc import CASSIE, generate_osc_batch
from fcc_qp_tpu.ops import ds_linalg as jlin
from fcc_qp_tpu.ops import polish as jpol
from fcc_qp_tpu.ops import projections as jproj
from fcc_qp_tpu.ops import scaling as jscal
from fcc_qp_tpu.utils.io import stack_qp_dicts
from fcc_qp_tpu_torch import FCCQPOptions as TOpts
from fcc_qp_tpu_torch.core import ds_engine as teng
from fcc_qp_tpu_torch.ops import ds_linalg as tlin
from fcc_qp_tpu_torch.ops import polish as tpol
from fcc_qp_tpu_torch.ops import projections as tproj
from fcc_qp_tpu_torch.ops import scaling as tscal

# torch's CPU thread pool runs the port's small batched products many
# times slower at its default thread count than at one or two, and the
# suite's test workers share the cores
torch.set_num_threads(1)

SHAPE = CASSIE.shape
RHO = 0.05


@pytest.fixture(scope="module")
def data():
    stacked = stack_qp_dicts(generate_osc_batch(CASSIE, 64, seed=2))
    jqp = jeng.to_ds_batch(stacked)
    tqp = teng.to_ds_batch(stacked, device="cpu")
    return stacked, jqp, tqp


@pytest.fixture(scope="module")
def scaled(data):
    """Both packages' scaled problems plus the reduced-splitting rho."""
    _, jqp, tqp = data
    opts = TOpts(scaling=True, splitting="constrained", presolve="operator")
    jqs, jsc = jeng._scale_reduced(jqp, SHAPE, opts)
    tqs, tsc = teng._scale_reduced(tqp, SHAPE, opts)
    ci = np.asarray(teng.constrained_indices(tqp, SHAPE), np.int64)
    mask = np.zeros(SHAPE.num_vars, np.float32)
    mask[ci] = 1.0
    rho = np.full(64, RHO, np.float32)
    rho_diag = rho[None, :] * mask[:, None]
    return jqs, jsc, tqs, tsc, ci, mask, rho, rho_diag


def _f64(x):
    return np.asarray(ds.to_f64(x)) if isinstance(x, ds.DS) else np.asarray(x)


def test_box_and_cone_projections_match(rng):
    f = rng.normal(size=(64, 12)) * 50.0
    mu = rng.uniform(0.3, 1.2, size=(64, 4))
    x = rng.normal(size=(64, 60)) * 3.0
    lb, ub = -np.abs(rng.normal(size=60)), np.abs(rng.normal(size=60))
    tf, tmu, tx = (torch.from_numpy(a) for a in (f, mu, x))
    pairs = [
        (jproj.project_to_friction_cone(f, mu),
         tproj.project_to_friction_cone(tf, tmu)),
        (jproj.calc_friction_cone_violation(f, mu),
         tproj.calc_friction_cone_violation(tf, tmu)),
        (jproj.project_to_bounds(x, lb, ub),
         tproj.project_to_bounds(tx, torch.from_numpy(lb), torch.from_numpy(ub))),
        (jproj.calc_bound_violation(x, lb, ub),
         tproj.calc_bound_violation(tx, torch.from_numpy(lb), torch.from_numpy(ub))),
    ]
    for a, b in pairs:
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(
        tproj.validate_bounds(torch.from_numpy(lb), torch.from_numpy(ub)).numpy(),
        np.asarray(jproj.validate_bounds(lb, ub)),
    )
    # batch-last cone projection: JAX evaluates it in double-single
    fl, ml = f.T.copy(), mu.T.copy()
    j = jeng.project_cone_ds(jeng._split64(fl), jeng._split64(ml))
    t = tproj.project_cone_ds(torch.from_numpy(fl), torch.from_numpy(ml))
    np.testing.assert_allclose(t.numpy(), _f64(j), rtol=0, atol=1e-11)


def test_ruiz_scales_bit_equal(data):
    _, jqp, tqp = data
    j = jscal.ruiz_scaling(jqp.Q.hi, jqp.A_eq.hi, jqp.b.hi, SHAPE)
    t = tscal.ruiz_scaling(tqp.Q.float(), tqp.A_eq.float(), tqp.b.float(), SHAPE)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_scaled_problem_matches(scaled):
    jqs, _, tqs, _, *_ = scaled
    for a, b in zip(jqs, tqs):
        finite = np.isfinite(b.numpy())
        np.testing.assert_array_equal(finite, np.isfinite(np.asarray(a.hi)))
        np.testing.assert_allclose(
            b.numpy()[finite], _f64(a)[finite], rtol=1e-13, atol=0
        )


def test_kkt_seed_contraction_flags_match(scaled):
    jqs, _, tqs, _, ci, mask, rho, rho_diag = scaled
    _, jres = jlin.kkt_inverse_f32_seed(jqs.Q, jqs.A_eq, jnp.asarray(rho_diag))
    _, tres = tlin.kkt_inverse_f32_seed(tqs.Q, tqs.A_eq, torch.from_numpy(rho_diag))
    np.testing.assert_array_equal(tres.numpy() > 0.5, np.asarray(jres) > 0.5)
    # healthy equilibrated seeds land far below the 0.5 gate in both
    assert np.median(tres.numpy()) < 0.1 and np.median(np.asarray(jres)) < 0.1


def test_refinement_matches_ds(scaled):
    """Same f32 seed into both: the f64 refinement of the inverse
    columns and of the constant-term solve agrees with the JAX ds
    refinement to 1e-9 relative."""
    jqs, _, tqs, _, ci, mask, rho, rho_diag = scaled
    X32j, _ = jlin.kkt_inverse_f32_seed(jqs.Q, jqs.A_eq, jnp.asarray(rho_diag))
    Mj = jlin.assemble_kkt_ds(jqs.Q, jqs.A_eq, jnp.asarray(rho_diag))
    Cj = _f64(jlin.refine_inverse_columns_ds(X32j, Mj, ci, passes=2))
    r = jeng._concat0(ds.neg(jqs.b), jqs.b_eq)
    xj = _f64(jlin.solve_from_seed_ds(X32j, Mj, r, passes=2))

    X32t = torch.from_numpy(np.moveaxis(np.asarray(X32j), -1, 0).copy())
    Mt = tlin.assemble_kkt_ds(tqs.Q, tqs.A_eq, torch.from_numpy(rho_diag))
    np.testing.assert_allclose(
        Mt.numpy(), np.moveaxis(_f64(Mj), -1, 0), rtol=1e-13, atol=0
    )
    Ct = tlin.refine_inverse_columns_ds(X32t, Mt, ci, passes=2).numpy()
    xt = tlin.solve_from_seed_ds(
        X32t, Mt, torch.cat([-tqs.b, tqs.b_eq], dim=0), passes=2
    ).numpy()
    Cj_b = np.moveaxis(Cj, -1, 0)
    rel_c = np.abs(Ct - Cj_b).max() / np.abs(Cj_b).max()
    rel_x = np.abs(xt - xj).max(axis=0) / np.abs(xj).max(axis=0)
    assert rel_c < 1e-9, rel_c
    assert rel_x.max() < 1e-9, rel_x.max()


def test_f64_schur_fallback_is_exact(scaled):
    """The f64 Schur-Cholesky route (the fallback for non-contracting
    seeds) builds the reduced operator of the exact KKT inverse. Bar
    1e-7 relative: the Schur factor of the rho-free (1,1) block starts
    near kappa(H) * eps_f64 and one refinement step squares that error,
    far below the 1e-6 convergence tolerance the operator serves."""
    _, _, tqs, _, ci, mask, rho, rho_diag = scaled
    rho_t, mask_t = torch.from_numpy(rho), torch.from_numpy(mask)
    Fcc, xc_const, Fcolj, x_const = teng._factor_reduced(
        tqs, rho_t, ci, mask_t, refine_steps=1
    )
    Minv = torch.linalg.inv(
        tlin.assemble_kkt_ds(tqs.Q, tqs.A_eq, torch.from_numpy(rho_diag))
    )
    n = SHAPE.num_vars
    ci_t = torch.from_numpy(ci)
    F = Minv[:, :n, :n]
    want = {
        "Fcc": F[:, ci_t][:, :, ci_t].permute(2, 1, 0),
        "Fcolj": F[:, :, ci_t].permute(2, 1, 0),
        "x_const": (Minv @ torch.cat([-tqs.b, tqs.b_eq]).T[:, :, None])[
            :, :n, 0].T,
    }
    for name, got in (("Fcc", Fcc), ("Fcolj", Fcolj), ("x_const", x_const)):
        w = want[name]
        err = (got - w).abs().max() / w.abs().max()
        assert err < 1e-7, (name, float(err))
    np.testing.assert_array_equal(xc_const.numpy(), x_const[ci_t].numpy())


def test_classify_branch_matches(scaled, rng):
    """Equal active-set masks on a coarse ADMM state: the scaled
    constrained coordinates of an equality-QP point plus seeded
    perturbations of the coarse-phase size."""
    jqs, jsc, tqs, tsc, ci, *_ = scaled
    kb = len(ci) - SHAPE.nc
    M = tlin.assemble_kkt_ds(tqs.Q, tqs.A_eq, torch.zeros(64, dtype=torch.float64))
    rhs = torch.cat([-tqs.b, tqs.b_eq], dim=0).T[:, :, None]
    xt = torch.linalg.solve(M, rhs)[:, :, 0].T
    t = xt[torch.from_numpy(ci)].numpy() + rng.normal(size=(len(ci), 64)) * 1e-2
    wk = np.asarray(jsc.d)[ci]
    lbc, ubc = (jeng._gather0(a, ci[:kb]) for a in (jqs.lb, jqs.ub))
    for inflate in (1e-3, 0.0):
        jm = jpol.classify_branch(
            jeng._split64(t), lbc, ubc, jqs.friction_coeffs, kb, SHAPE.nc,
            jnp.asarray(wk), inflate=inflate,
        )
        tm = tpol.classify_branch(
            torch.from_numpy(t), tqs.lb[ci[:kb]], tqs.ub[ci[:kb]],
            tqs.friction_coeffs, kb, SHAPE.nc, torch.from_numpy(wk),
            inflate=inflate,
        )
        for a, b in zip(jm, tm):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        assert sum(int(np.asarray(a).sum()) for a in jm) > 0
