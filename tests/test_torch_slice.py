"""End-to-end parity of the port's cold batched solve (`solve_batched_ds`)
with the JAX package's, on the CPU.

The JAX side runs its plain XLA chunk bodies (``use_pallas=False``),
which its own tests hold equal to its Pallas kernels; the port runs the
plain versions its kernel wrappers take for CPU tensors. Batches and
options are those of `tests/test_two_phase.py` and `tests/test_polish.py`
(with the bench's 4 polish rounds)."""

import numpy as np
import pytest
import torch

import fcc_qp_tpu_torch as T
from fcc_qp_tpu import FCCQPOptions as JOpts
from fcc_qp_tpu.core.ds_engine import solve_batched_ds as jsolve
from fcc_qp_tpu.core.ds_engine import to_ds_batch as jto
from fcc_qp_tpu.models.osc import CASSIE, generate_osc_batch, generate_osc_sequence
from fcc_qp_tpu.utils.io import stack_qp_dicts

# torch's CPU thread pool runs the port's small batched products many
# times slower at its default thread count than at one or two, and the
# suite's test workers share the cores
torch.set_num_threads(1)

TWO_PHASE = dict(
    max_iter=2000, rho=0.05, eps_fcone=1e-6, eps_bound=1e-6,
    presolve="operator", scaling=True, splitting="constrained",
    polish=False, phase1_tol=1e-2,
)
BENCH = dict(
    max_iter=3000, rho=0.05, eps_fcone=1e-6, eps_bound=1e-6,
    scaling=True, splitting="constrained", presolve="operator",
    polish=True, polish_rounds=4,
)


def _solve_both(stacked, opts, jwarm=None):
    kw = {}
    if jwarm is not None:
        kw = dict(warm=jwarm, warm_start=True)
    jsol, jws = jsolve(jto(stacked), CASSIE.shape, JOpts(**opts),
                       timing=False, **kw)
    tkw = {}
    if jwarm is not None:
        tkw = dict(warm=T.warm_start_from_numpy(
            jwarm.x.hi, jwarm.x.lo, jwarm.mu_x.hi, jwarm.mu_x.lo,
            jwarm.mu_lambda_c.hi, jwarm.mu_lambda_c.lo, jwarm.rho,
            device="cpu",
        ), warm_start=True)
    tsol, _ = T.solve_batched_ds(
        T.to_ds_batch(stacked, device="cpu"), CASSIE.shape,
        T.FCCQPOptions(**opts), device="cpu", **tkw,
    )
    return jsol, jws, tsol


def _d(sol, name):
    v = getattr(sol.details, name)
    return v.numpy() if hasattr(v, "numpy") else np.asarray(v)


def _z(sol):
    return sol.z.numpy() if hasattr(sol.z, "numpy") else np.asarray(sol.z)


def _objective(stacked, z):
    Qz = np.einsum("bij,bj->bi", stacked["Q"], z)
    return 0.5 * np.sum(z * Qz, axis=1) + np.sum(stacked["b"] * z, axis=1)


def _two_phase_bars(jsol, tsol):
    np.testing.assert_array_equal(_d(tsol, "solve_status"),
                                  _d(jsol, "solve_status"))
    assert (_d(tsol, "solve_status") == 0).all()
    assert (_d(tsol, "admm_residual_bounds") <= 1e-6).all()
    assert (_d(tsol, "admm_residual_friction_cone") <= 1e-6).all()
    assert np.max(np.abs(_z(tsol) - _z(jsol))) < 1e-4
    # exact per-instance counts: the f32 phase reads float(f64 operator)
    # where JAX reads the ds hi word, which are the same f32 numbers
    # unless a refined entry sits on an f32 rounding boundary
    np.testing.assert_array_equal(_d(tsol, "n_iter"), _d(jsol, "n_iter"))


def _polish_bars(stacked, jsol, tsol):
    np.testing.assert_array_equal(_d(tsol, "solve_status"),
                                  _d(jsol, "solve_status"))
    np.testing.assert_array_equal(_d(tsol, "polish_accepted"),
                                  _d(jsol, "polish_accepted"))
    zt, zj = _z(tsol), _z(jsol)
    both = (_d(tsol, "polish_accepted") > 0) & (_d(jsol, "polish_accepted") > 0)
    if both.any():
        assert np.max(np.abs(zt[both] - zj[both])) < 1e-6
    # the JAX package's own bar between two valid solutions
    assert np.max(np.abs(zt - zj)) < 5e-3
    rel = np.abs(_objective(stacked, zt) - _objective(stacked, zj))
    rel /= 1.0 + np.abs(_objective(stacked, zj))
    assert np.max(rel) < 1e-5
    eq = np.abs(np.einsum("bij,bj->bi", stacked["A_eq"], zt) - stacked["b_eq"])
    assert np.max(eq) < 1e-9
    assert (_d(tsol, "admm_residual_bounds") <= 1e-6).all()
    assert (_d(tsol, "admm_residual_friction_cone") <= 1e-6).all()


@pytest.fixture(scope="module")
def two_phase_batch():
    return stack_qp_dicts(generate_osc_batch(CASSIE, 16, seed=5))


@pytest.fixture(scope="module")
def walking():
    return stack_qp_dicts(
        generate_osc_sequence(CASSIE, 16, seed=0, smoothness=0.002)
    )


def test_two_phase_checkpoint(two_phase_batch):
    jsol, _, tsol = _solve_both(two_phase_batch, TWO_PHASE)
    _two_phase_bars(jsol, tsol)
    np.testing.assert_array_equal(_d(tsol, "n_iter_f32"), _d(jsol, "n_iter_f32"))
    np.testing.assert_array_equal(_d(tsol, "n_iter_ds"), _d(jsol, "n_iter_ds"))


def test_bench_flags_polish(walking):
    jsol, _, tsol = _solve_both(walking, BENCH)
    _polish_bars(walking, jsol, tsol)
    assert _d(tsol, "polish_accepted").sum() >= 12
    np.testing.assert_array_equal(_d(tsol, "polish_attempts"),
                                  _d(jsol, "polish_attempts"))


def test_forced_rejection_runs_rounds_exact_build_and_endgame(walking):
    """Everything pinned (huge act_tol): every polish attempt is
    rejected, so the retry rounds, the lazy exact build and the f64
    endgame all run."""
    opts = dict(BENCH, polish_act_tol=1e6)
    jsol, _, tsol = _solve_both(walking, opts)
    _polish_bars(walking, jsol, tsol)
    assert _d(tsol, "polish_accepted").sum() == 0
    assert (_d(tsol, "polish_attempts") == 4).all()
    assert (_d(tsol, "n_iter_ds") > 0).all()
    np.testing.assert_array_equal(_d(tsol, "n_iter"), _d(jsol, "n_iter"))


def test_warm_state_carried_across():
    """Step t of a walking log solved cold by JAX; its WarmStartDS,
    converted with `warm_start_from_numpy`, warm-starts step t+1 in both
    packages."""
    log = stack_qp_dicts(
        generate_osc_sequence(CASSIE, 17, seed=0, smoothness=0.002)
    )
    step0 = {k: v[:16] for k, v in log.items()}
    step1 = {k: v[1:] for k, v in log.items()}
    _, jwarm, _ = _solve_both(step0, TWO_PHASE)
    jsol, _, tsol = _solve_both(step1, TWO_PHASE, jwarm=jwarm)
    _two_phase_bars(jsol, tsol)
