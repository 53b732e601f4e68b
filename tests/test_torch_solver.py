"""Parity of the port's f64 parity engine (`fcc_qp_tpu_torch.solve`,
`solve_batched`, `replay`) with the JAX package's and with the numpy
oracle, on the CPU, at the options of `tests/test_solver.py`.

The port runs its ADMM loop in chunks of the full-layout kernel's plain
version (the wrapper's choice for CPU tensors); the JAX package runs a
vmapped `lax.while_loop`. Bars: per-instance n_iter and status equal,
|dz| <= 1e-9. The module's JAX programs are small (about 25 s of
compiles in all) and compile without the test workers' shared
persistent cache, where a worker running this module has crashed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fcc_qp_tpu as J
import fcc_qp_tpu_torch as T
from oracle import OracleFCCQP
from test_solver import OPTS, SHAPE, random_qp
from test_torch_public_surface import without_shared_cache  # noqa: F401

torch.set_num_threads(1)

TSHAPE = T.ProblemShape(SHAPE.num_vars, SHAPE.num_eq, SHAPE.nc,
                        SHAPE.lambda_c_start)
TOPTS = T.FCCQPOptions(max_iter=OPTS.max_iter, rho=OPTS.rho,
                       eps_fcone=OPTS.eps_fcone, eps_bound=OPTS.eps_bound)


def _stack(ds_):
    return {k: np.stack([d[k] for d in ds_]) for k in ds_[0]}


def _jq(st):
    return J.QPBatch(**{k: jnp.asarray(v) for k, v in st.items()})


def _tq(st):
    return T.QPBatch(**{k: torch.from_numpy(np.asarray(v, np.float64))
                        for k, v in st.items()})


def _oracle(d, warm_start=False, ora=None):
    if ora is None:
        ora = OracleFCCQP(SHAPE.num_vars, SHAPE.num_eq, SHAPE.nc,
                          SHAPE.lambda_c_start)
        ora.max_iter, ora.rho = OPTS.max_iter, OPTS.rho
        ora.eps_fcone, ora.eps_bound = OPTS.eps_fcone, OPTS.eps_bound
    ora.warm_start = warm_start
    return ora.solve(**d), ora


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(11)
    # a mix of bounded and unbounded instances, loose and tight
    return _stack([random_qp(rng, SHAPE, bound=b)
                   for b in (None, 2.0, 0.5, None, 3.0, 1.0)])


@pytest.mark.parametrize("presolve,rho,max_iter", [
    # the options of tests/test_solver.py, where these instances run to
    # the cap, and a rho at which they converge at 39-148 iterations
    ("exact", 1e-3, 200), ("operator", 1e-3, 200),
    ("exact", 10.0, 500), ("operator", 10.0, 500),
])
def test_solve_batched_matches_jax(batch, presolve, rho, max_iter):
    kw = dict(presolve=presolve, rho=rho, max_iter=max_iter)
    jsol, _ = J.solve_batched(_jq(batch), SHAPE, OPTS.replace(**kw),
                              timing=False)
    tsol, _ = T.solve_batched(_tq(batch), TSHAPE, TOPTS.replace(**kw),
                              device="cpu")
    d = tsol.details
    np.testing.assert_array_equal(d.n_iter.numpy(),
                                  np.asarray(jsol.details.n_iter))
    np.testing.assert_array_equal(d.solve_status.numpy(),
                                  np.asarray(jsol.details.solve_status))
    assert np.abs(tsol.z.numpy() - np.asarray(jsol.z)).max() <= 1e-9
    for name in ("admm_residual_bounds", "admm_residual_friction_cone",
                 "bounds_viol", "friction_cone_viol", "equality_viol"):
        np.testing.assert_allclose(getattr(d, name).numpy(),
                                   np.asarray(getattr(jsol.details, name)),
                                   rtol=1e-6, atol=1e-11, err_msg=name)
    assert (d.solve_time > 0).all() and (d.factorization_time > 0).all()
    assert (d.factorization_time <= d.solve_time).all()


@pytest.mark.parametrize("bound", [None, 2.0])
def test_solve_matches_oracle(bound):
    d = random_qp(np.random.default_rng(0), SHAPE, bound=bound)
    ref, _ = _oracle(d)
    sol, _ = T.solve(_tq(d), TSHAPE, TOPTS, device="cpu")
    assert int(sol.details.n_iter) == ref["n_iter"]
    assert int(sol.details.solve_status) == ref["solve_status"]
    np.testing.assert_allclose(sol.z.numpy(), ref["z"], atol=1e-7)
    np.testing.assert_allclose(float(sol.details.admm_residual_bounds),
                               ref["eps_bounds"], atol=1e-9)


def test_warm_sequence_matches_oracle_and_replay():
    """A slowly varying warm-started sequence: `solve` step by step
    matches the oracle, and `replay` matches `solve` and the JAX
    package's `replay`."""
    base = random_qp(np.random.default_rng(4), SHAPE, bound=3.0)
    seq = []
    for t in range(5):
        d = dict(base)
        d["b"] = base["b"] + 0.05 * t
        d["b_eq"] = base["b_eq"] + 0.02 * t
        seq.append(d)
    warm, ora, n_iter = None, None, []
    for t, d in enumerate(seq):
        ref, ora = _oracle(d, t > 0, ora)
        sol, warm = T.solve(_tq(d), TSHAPE, TOPTS, warm=warm,
                            warm_start=t > 0, device="cpu")
        assert int(sol.details.n_iter) == ref["n_iter"], t
        np.testing.assert_allclose(sol.z.numpy(), ref["z"], atol=1e-7)
        n_iter.append(int(sol.details.n_iter))
    st = _stack(seq)
    jsol, _ = J.replay(_jq(st), SHAPE, OPTS)
    tsol, tws = T.replay(_tq(st), TSHAPE, TOPTS, device="cpu")
    np.testing.assert_array_equal(tsol.details.n_iter.numpy(), n_iter)
    np.testing.assert_array_equal(tsol.details.n_iter.numpy(),
                                  np.asarray(jsol.details.n_iter))
    assert np.abs(tsol.z.numpy() - np.asarray(jsol.z)).max() <= 1e-9
    np.testing.assert_array_equal(tws.x.numpy(), tsol.z.numpy()[-1])


def test_batch_freezes_each_instance_like_a_serial_solve():
    """Instances that converge at different iterations keep the results
    of their own serial solves (the per-instance early exit)."""
    rng = np.random.default_rng(1)
    easy = random_qp(rng, SHAPE, bound=100.0)
    hard = random_qp(rng, SHAPE, bound=0.1)
    opts = TOPTS.replace(max_iter=500, rho=10.0)
    bsol, _ = T.solve_batched(_tq(_stack([easy, hard])), TSHAPE, opts,
                              device="cpu")
    n = bsol.details.n_iter.numpy()
    assert n[0] != n[1]
    for i, d in enumerate((easy, hard)):
        sol, _ = T.solve(_tq(d), TSHAPE, opts, device="cpu")
        assert int(sol.details.n_iter) == n[i]
        np.testing.assert_array_equal(sol.z.numpy(), bsol.z.numpy()[i])


def test_equality_constrained_fast_path():
    """No cones and every bound infinite: the presolve is the solution,
    with n_iter 0, cold and warm, and a mixed batch leaves the bounded
    instance to the ADMM loop."""
    shape = J.ProblemShape(num_vars=12, num_eq=5, nc=0, lambda_c_start=0)
    tshape = T.ProblemShape(12, 5, 0, 0)
    rng = np.random.default_rng(0)
    free = random_qp(rng, shape)
    boxed = random_qp(rng, shape, bound=0.3)
    st = _stack([free, boxed])
    for warm_start in (False, True):
        warm = None
        if warm_start:
            _, warm = T.solve_batched(_tq(st), tshape, TOPTS, device="cpu")
        sol, _ = T.solve_batched(_tq(st), tshape, TOPTS, warm=warm,
                                 warm_start=warm_start, device="cpu")
        z = sol.z.numpy()
        assert int(sol.details.n_iter[0]) == 0
        assert int(sol.details.solve_status[0]) == 0
        np.testing.assert_allclose(free["A_eq"] @ z[0], free["b_eq"],
                                   atol=1e-9)
        assert int(sol.details.n_iter[1]) > 0
    jsol, _ = J.solve_batched(_jq(st), shape, OPTS, timing=False)
    np.testing.assert_array_equal(sol.details.n_iter.numpy()[:1],
                                  np.asarray(jsol.details.n_iter)[:1])


def test_max_iterations_status():
    d = random_qp(np.random.default_rng(0), SHAPE, bound=1.0)
    opts = TOPTS.replace(max_iter=2, rho=1e-6, eps_fcone=1e-14,
                         eps_bound=1e-14)
    sol, _ = T.solve(_tq(d), TSHAPE, opts, device="cpu")
    assert int(sol.details.n_iter) == 2
    assert int(sol.details.solve_status) == 1


def test_warm_state_from_the_jax_package():
    """The JAX package's `WarmStart`, converted with
    `warm_start_f64_from_numpy`, warm-starts the next step in both."""
    rng = np.random.default_rng(7)
    d0 = random_qp(rng, SHAPE, bound=2.0)
    d1 = dict(d0, b=d0["b"] + 0.03)
    _, jws = J.solve(_jq(d0), SHAPE, OPTS)
    jsol, _ = J.solve(_jq(d1), SHAPE, OPTS, warm=jws, warm_start=True)
    tws = T.warm_start_f64_from_numpy(np.asarray(jws.x), np.asarray(jws.mu_x),
                                      np.asarray(jws.mu_lambda_c),
                                      device="cpu")
    tsol, _ = T.solve(_tq(d1), TSHAPE, TOPTS, warm=tws, warm_start=True,
                      device="cpu")
    assert int(tsol.details.n_iter) == int(jsol.details.n_iter)
    assert np.abs(tsol.z.numpy() - np.asarray(jsol.z)).max() <= 1e-9
