"""The port's full-layout ADMM chunk, full-splitting engine and the
remaining problem classes of the reduced path, held against the JAX
package on the CPU.

* The full-layout chunk's plain version (what `admm_chunk_full_f64` runs
  for CPU tensors) against `admm_chunk_pallas` in interpret mode, in the
  layout the full engine calls it in (Cassie, n = 60, the cone segment
  at rows 38-49, B = 128): counters equal, state within 1e-10 (the
  Pallas kernel is double-single), residuals where the instance
  iterated (Pallas restarts them each chunk; ROADMAP.md queue C). The
  same at the humanoid's layout (n = 76, the cone segment at rows 52-75,
  32 instances tiled to one 128-instance Pallas tile), which takes the
  CUDA kernel's third row slot on the card.
* The CUDA wrappers' row limit: 96 rows (k, or n on the full layout)
  pass `check_rows`, 97 raise.
* `solve_batched_ds` on the full engine (the package defaults' path)
  against the JAX package's, at `tests/test_ds_engine.py`'s options and
  batch (exact presolve, with and without adaptive rho: the JAX programs
  that file compiles), at the README's adaptive-rho example (operator
  presolve) and at the package defaults: n_iter and status equal, |dz|
  < 1e-4 (the bar of `tests/test_ds_engine.py`'s Pallas-vs-XLA test);
  and on two humanoid instances at those options with rho = 0.01, where
  both converge.
* The reduced path's remaining classes: the f64 Schur factor
  (``kkt_factor='ds'``), exact presolve and ``splitting='full'`` in one
  solve of a problem without cones (nc = 0), and a problem without any
  constrained coordinate (k = 0): statuses and n_iter equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fcc_qp_tpu_torch as T
from fcc_qp_tpu import FCCQPOptions as JOpts
from fcc_qp_tpu import ProblemShape as JShape
from fcc_qp_tpu.core.ds_engine import _split64
from fcc_qp_tpu.core.ds_engine import solve_batched_ds as jsolve
from fcc_qp_tpu.core.ds_engine import to_ds_batch as jto
from fcc_qp_tpu.models.osc import (CASSIE, HUMANOID, generate_osc_batch,
                                   generate_osc_sequence)
from fcc_qp_tpu.ops import ds
from fcc_qp_tpu.ops.pallas_admm import admm_chunk_pallas
from fcc_qp_tpu.utils.io import stack_qp_dicts
from fcc_qp_tpu_torch.core import ds_engine as teng
from fcc_qp_tpu_torch.ops import pallas_admm as tk
from test_solver import random_qp

torch.set_num_threads(1)

# tests/test_ds_engine.py:15
OPTS = dict(max_iter=300, rho=1.0, eps_fcone=1e-6, eps_bound=1e-6)
# README.md's batched example
README = dict(max_iter=2000, rho=0.05, eps_fcone=1e-6, eps_bound=1e-6,
              adaptive_rho=True, presolve="operator")
TWO_PHASE = dict(max_iter=2000, rho=0.05, eps_fcone=1e-6, eps_bound=1e-6,
                 presolve="operator", scaling=True, splitting="constrained",
                 polish=False, phase1_tol=1e-2)
B_CHUNK, K, MAX_ITER = 128, 32, 2000
EPS = float(np.float32(1e-6))


def _d(sol, name):
    v = getattr(sol.details, name)
    return v.numpy() if hasattr(v, "numpy") else np.asarray(v)


def _z(sol):
    return sol.z.numpy() if hasattr(sol.z, "numpy") else np.asarray(sol.z)


def _solve_both(stacked, shape, opts, **kw):
    jsol, _ = jsolve(jto(stacked), JShape(*shape), JOpts(**opts))
    tsol, _ = T.solve_batched_ds(T.to_ds_batch(stacked, device="cpu"),
                                 T.ProblemShape(*shape),
                                 T.FCCQPOptions(**opts), device="cpu", **kw)
    return jsol, tsol


CASSIE_SHAPE = (60, 38, 12, 38)


@pytest.fixture(scope="module")
def cassie8():
    return stack_qp_dicts(generate_osc_sequence(CASSIE, 8, seed=0))


@pytest.fixture(scope="module")
def chunk_state():
    """The full engine's prepared operator and initial state for a Cassie
    batch."""
    qp = teng.to_ds_batch(
        stack_qp_dicts(generate_osc_batch(CASSIE, B_CHUNK, seed=0)),
        device="cpu")
    prep = teng._prepare_full(qp, None, CASSIE.shape,
                              T.FCCQPOptions(**OPTS), False)
    x0 = prep.x_init
    zb = torch.zeros(B_CHUNK, dtype=torch.float64)
    const = (prep.Fj, prep.x_const, qp.lb, qp.ub, qp.friction_coeffs,
             prep.rho0.double())
    state = (x0, x0.clone(), x0[38:50].contiguous(), prep.mu_x0,
             prep.mu_lam0, x0 - prep.mu_x0,
             torch.zeros(B_CHUNK, dtype=torch.bool),
             torch.full((B_CHUNK,), MAX_ITER, dtype=torch.int32),
             torch.zeros(B_CHUNK, dtype=torch.int32), zb, zb, zb, zb)
    return const, state


@pytest.mark.parametrize("gate", [tk.GATE_OFF, tk.GATE_SPLIT])
def test_full_chunk_matches_pallas(chunk_state, gate):
    const, state = chunk_state
    # 496 iterations first: this batch starts converging at 270 (no
    # gate) and 290 (gate) iterations, and instances converge inside the
    # compared chunk; then some instances are frozen and some put at the
    # iteration cap, so the per-instance masking is exercised too
    state = list(tk.admm_chunk_full_f64_plain(
        *const, EPS, EPS, *state, ls=38, K=496, max_iter=MAX_ITER,
        gate=gate))
    state[6] = state[6].clone()
    state[6][::9] = True
    state[8] = state[8].clone()
    state[8][4::13] = MAX_ITER - 5
    got = tk.admm_chunk_full_f64_plain(
        *const, EPS, EPS, *state, ls=38, K=K, max_iter=MAX_ITER, gate=gate)
    f = lambda a: _split64(a.numpy())
    ref = admm_chunk_pallas(
        *(f(a) for a in const[:5]), jnp.asarray(const[5].numpy()), EPS, EPS,
        *(f(a) for a in state[:6]), jnp.asarray(state[6].numpy()),
        jnp.asarray(state[7].numpy()), jnp.asarray(state[8].numpy()),
        shape=JShape(*CASSIE_SHAPE), K=K, max_iter=MAX_ITER, interpret=True,
        inc_gate=gate == tk.GATE_SPLIT,
    )
    for i in (6, 7, 8):       # done, n_iter, itv
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref[i]))
    converged = got[6].numpy() & ~state[6].numpy()
    assert converged.any()
    for i in range(6):        # x, x_bar, lam_bar, mu_x, mu_lam, v
        np.testing.assert_allclose(got[i].numpy(),
                                   np.asarray(ds.to_f64(ref[i])),
                                   rtol=0, atol=1e-10)
    act = got[8].numpy() > state[8].numpy()
    assert act.sum() > B_CHUNK // 2
    for i in range(9, 13):    # xrn, lrn, prim, dual
        np.testing.assert_allclose(got[i].numpy()[act],
                                   np.asarray(ref[i], np.float64)[act],
                                   rtol=1e-5, atol=1e-12)
    np.testing.assert_array_equal(got[9].numpy()[~act],
                                  state[9].numpy()[~act])


# the humanoid's full layout: n = 76, the cone segment at rows 52-75
HUMANOID_SHAPE = (76, 41, 24, 52)
# `OPTS` at a rho the humanoid's raw data converges at (at rho = 1 every
# instance stops at the 300-iteration cap)
HUMANOID_OPTS = dict(OPTS, rho=0.01)
B_HUM, K_HUM, MAX_ITER_HUM = 32, 16, 4000
# plain-version iterations before the compared chunk, per gate: the
# batch's first instances converge after 36 (no gate) and 1617 (gate)
# iterations. The warm-up runs on B_HUM instances; the compared chunk on
# four copies of them, one Pallas tile of 128, each copy frozen and
# capped at other instances
WARMUP_HUM = {tk.GATE_OFF: 30, tk.GATE_SPLIT: 1610}


@pytest.fixture(scope="module")
def humanoid_chunk_state():
    """The full engine's prepared operator and initial state for a
    humanoid batch."""
    qp = teng.to_ds_batch(
        stack_qp_dicts(generate_osc_batch(HUMANOID, B_HUM, seed=0)),
        device="cpu")
    prep = teng._prepare_full(qp, None, T.ProblemShape(*HUMANOID_SHAPE),
                              T.FCCQPOptions(**OPTS), False)
    x0 = prep.x_init
    zb = torch.zeros(B_HUM, dtype=torch.float64)
    const = (prep.Fj, prep.x_const, qp.lb, qp.ub, qp.friction_coeffs,
             prep.rho0.double())
    state = (x0, x0.clone(), x0[52:76].contiguous(), prep.mu_x0,
             prep.mu_lam0, x0 - prep.mu_x0,
             torch.zeros(B_HUM, dtype=torch.bool),
             torch.full((B_HUM,), MAX_ITER_HUM, dtype=torch.int32),
             torch.zeros(B_HUM, dtype=torch.int32), zb, zb, zb, zb)
    return const, state


@pytest.mark.parametrize("gate", [tk.GATE_OFF, tk.GATE_SPLIT])
def test_full_chunk_matches_pallas_humanoid(humanoid_chunk_state, gate):
    """As `test_full_chunk_matches_pallas`, at the humanoid's n = 76
    (ls = 52, nc = 24): the CUDA kernel's third row slot on the card."""
    const, state = humanoid_chunk_state
    ls = HUMANOID_SHAPE[3]
    state = tk.admm_chunk_full_f64_plain(
        *const, EPS, EPS, *state, ls=ls, K=WARMUP_HUM[gate],
        max_iter=MAX_ITER_HUM, gate=gate)
    tile = lambda a: torch.cat([a] * 4, dim=-1).contiguous()
    const = tuple(tile(a) for a in const)
    state = [tile(a) for a in state]
    state[6][5::9] = True
    state[8] = state[8].clone()
    state[8][4::13] = MAX_ITER_HUM - 5
    got = tk.admm_chunk_full_f64_plain(
        *const, EPS, EPS, *state, ls=ls, K=K_HUM, max_iter=MAX_ITER_HUM,
        gate=gate)
    f = lambda a: _split64(a.numpy())
    ref = admm_chunk_pallas(
        *(f(a) for a in const[:5]), jnp.asarray(const[5].numpy()), EPS, EPS,
        *(f(a) for a in state[:6]), jnp.asarray(state[6].numpy()),
        jnp.asarray(state[7].numpy()), jnp.asarray(state[8].numpy()),
        shape=JShape(*HUMANOID_SHAPE), K=K_HUM, max_iter=MAX_ITER_HUM,
        interpret=True, inc_gate=gate == tk.GATE_SPLIT,
    )
    for i in (6, 7, 8):       # done, n_iter, itv
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref[i]))
    assert (got[6].numpy() & ~state[6].numpy()).any()
    for i in range(6):        # x, x_bar, lam_bar, mu_x, mu_lam, v
        np.testing.assert_allclose(got[i].numpy(),
                                   np.asarray(ds.to_f64(ref[i])),
                                   rtol=0, atol=1e-10)
    act = got[8].numpy() > state[8].numpy()
    assert act.sum() > 2 * B_HUM and (~act).any()
    for i in range(9, 13):    # xrn, lrn, prim, dual
        np.testing.assert_allclose(got[i].numpy()[act],
                                   np.asarray(ref[i], np.float64)[act],
                                   rtol=1e-5, atol=1e-12)
    np.testing.assert_array_equal(got[9].numpy()[~act],
                                  state[9].numpy()[~act])


@pytest.mark.parametrize("rows", [1, 76, 96, 97, 0])
def test_kernel_row_limit(rows):
    """The CUDA wrappers take 1 to 96 rows (k on the reduced path, n on
    the full layout) and raise outside, naming the limit."""
    assert tk.MAX_ROWS == 96
    if 1 <= rows <= 96:
        tk.check_rows(rows, "n")
    else:
        with pytest.raises(ValueError, match="1 to 96 rows"):
            tk.check_rows(rows, "k")


def _full_bars(jsol, tsol):
    np.testing.assert_array_equal(_d(tsol, "solve_status"),
                                  _d(jsol, "solve_status"))
    np.testing.assert_array_equal(_d(tsol, "n_iter"), _d(jsol, "n_iter"))
    assert np.abs(_z(tsol) - _z(jsol)).max() < 1e-4
    np.testing.assert_array_equal(_d(tsol, "n_iter_ds"), _d(tsol, "n_iter"))


@pytest.mark.parametrize("kw", [
    dict(OPTS), dict(OPTS, max_iter=2000, adaptive_rho=True), README, {},
], ids=["exact", "adaptive", "readme_operator", "defaults"])
def test_full_engine_matches_jax(cassie8, kw):
    jsol, tsol = _solve_both(cassie8, CASSIE_SHAPE, kw)
    _full_bars(jsol, tsol)
    if kw.get("adaptive_rho"):
        assert (_d(tsol, "solve_status") == 0).all()
        assert _d(tsol, "admm_residual_bounds").max() < 1e-6
        assert _d(tsol, "admm_residual_friction_cone").max() < 1e-6


def test_full_engine_matches_jax_humanoid():
    """The full engine at the humanoid's n = 76 (the CUDA kernels' third
    row slot) against the JAX package's, two instances at
    `HUMANOID_OPTS`; both converge. The JAX program's compile is most of
    the cost, so the batch is small."""
    st = stack_qp_dicts(generate_osc_batch(HUMANOID, 2, seed=0))
    jsol, tsol = _solve_both(st, HUMANOID_SHAPE, HUMANOID_OPTS)
    _full_bars(jsol, tsol)
    assert (_d(tsol, "solve_status") == 0).all()


def test_full_engine_warm_start_and_stages(cassie8):
    """A warm restart of the identical batch converges at once, and
    ``stage_times`` holds the full engine's three stages and its
    adaptive-rho refactor count."""
    opts = T.FCCQPOptions(**dict(OPTS, max_iter=2000, adaptive_rho=True))
    qp = T.to_ds_batch(cassie8, device="cpu")
    stages = {}
    sol1, warm = T.solve_batched_ds(qp, CASSIE.shape, opts, device="cpu",
                                    stage_times=stages)
    assert set(stages) == {"operator", "iterate", "finalize", "n_refactor"}
    assert stages["n_refactor"] > 0
    sol2, _ = T.solve_batched_ds(qp, CASSIE.shape, opts, warm=warm,
                                 warm_start=True, device="cpu")
    n1, n2 = _d(sol1, "n_iter"), _d(sol2, "n_iter")
    assert np.median(n2) <= np.median(n1) * 0.1 + 2


def _no_cone_batch(bounds):
    shape = JShape(num_vars=12, num_eq=5, nc=0, lambda_c_start=0)
    rng = np.random.default_rng(2)
    ds_ = [random_qp(rng, shape, bound=b) for b in bounds]
    return {k: np.stack([d[k] for d in ds_]) for k in ds_[0]}


def test_no_constrained_coordinate_is_one_kkt_solve():
    """k = 0 (no cones, every bound infinite in every instance)."""
    st = _no_cone_batch([None] * 4)
    jsol, tsol = _solve_both(st, (12, 5, 0, 0), TWO_PHASE)
    for name in ("solve_status", "n_iter"):
        np.testing.assert_array_equal(_d(tsol, name), _d(jsol, name))
    assert (_d(tsol, "n_iter") == 0).all()
    assert np.abs(_z(tsol) - _z(jsol)).max() < 1e-9
    eq = np.einsum("bmn,bn->bm", st["A_eq"], _z(tsol)) - st["b_eq"]
    assert np.abs(eq).max() < 1e-9


def test_reduced_options_without_cones_match_jax():
    """The reduced path's remaining options in one solve: the f64 Schur
    factor (``kkt_factor='ds'``), exact presolve and ``splitting='full'``
    (every coordinate in the splitting), on a problem without cones
    (nc = 0): bounded instances iterate through both phases (an empty
    cone segment), and an instance whose bounds are all infinite takes
    the exact presolve with n_iter 0."""
    st = _no_cone_batch([0.5, None, 1.0, 0.3])
    opts = dict(TWO_PHASE, kkt_factor="ds", presolve="exact",
                splitting="full")
    jsol, tsol = _solve_both(st, (12, 5, 0, 0), opts)
    for name in ("solve_status", "n_iter", "n_iter_f32", "n_iter_ds"):
        np.testing.assert_array_equal(_d(tsol, name), _d(jsol, name), name)
    n = _d(tsol, "n_iter")
    assert n[1] == 0 and (n[[0, 2, 3]] > 0).all()
    assert (_d(tsol, "n_iter_f32")[[0, 2, 3]] > 0).all()
    assert (_d(tsol, "solve_status") == 0).all()
    assert np.abs(_z(tsol) - _z(jsol)).max() < 1e-4
