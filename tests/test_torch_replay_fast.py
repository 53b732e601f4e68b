"""The port's warm replay on the non-lazy hybrid path (polish off, so
every step's carried KKT seed is refreshed, refined in f64 and served by
the f64 endgame), on the CPU, held against itself and the JAX package.

Logs and options are those of `tests/test_ds_engine.py`
(`TestDsReplayAndSharding`, ``FAST_OPTS``), so the JAX programs are the
ones that file compiles.
"""

import numpy as np
import pytest
import torch

import fcc_qp_tpu_torch as T
from fcc_qp_tpu.core import ds_engine as jeng
from fcc_qp_tpu.models.osc import CASSIE, generate_osc_sequence
from fcc_qp_tpu.utils.io import stack_qp_dicts
from test_ds_engine import FAST_OPTS
from test_torch_slice import _d, _z

# torch's CPU thread pool runs the port's small batched products many
# times slower at its default thread count than at one or two, and the
# suite's test workers share the cores
torch.set_num_threads(1)

TOPTS = T.FCCQPOptions(**{
    f: getattr(FAST_OPTS, f) for f in FAST_OPTS.__dataclass_fields__
})


def _log(n):
    return stack_qp_dicts(generate_osc_sequence(CASSIE, n, seed=0))


def _replay(stacked, S):
    return T.replay_ds_streams(
        T.to_ds_batch(stacked, device="cpu"), CASSIE.shape, TOPTS,
        n_streams=S, device="cpu",
    )[0]


@pytest.fixture(scope="module")
def log8():
    return _log(8)


@pytest.fixture(scope="module")
def log12():
    return _log(12)


def test_streams_equal_per_stream_serial_replay(log8):
    """Multi-stream replay (carried seeds) == the serial warm replay of
    each stream (`replay_ds`, no cache)."""
    S, steps = 2, 4
    sols = _replay(log8, S)
    assert (_d(sols, "solve_status") == 0).all()
    for s in range(S):
        sub = {k: v[steps * s:steps * (s + 1)] for k, v in log8.items()}
        ref, _ = T.replay_ds(T.to_ds_batch(sub, device="cpu"), CASSIE.shape,
                             TOPTS, device="cpu")
        rows = slice(steps * s, steps * (s + 1))
        np.testing.assert_array_equal(_d(sols, "n_iter")[rows],
                                      _d(ref, "n_iter"))
        np.testing.assert_allclose(_z(sols)[rows], _z(ref), atol=1e-8)


def test_streams_match_jax(log8):
    S = 2
    jsol, _ = jeng.replay_ds_streams(
        jeng.to_ds_batch(log8), CASSIE.shape, FAST_OPTS, n_streams=S
    )
    tsol = _replay(log8, S)
    np.testing.assert_array_equal(_d(tsol, "solve_status"),
                                  _d(jsol, "solve_status"))
    np.testing.assert_array_equal(_d(tsol, "n_iter"), _d(jsol, "n_iter"))
    np.testing.assert_allclose(_z(tsol), _z(jsol), atol=1e-6)


def test_single_step_streams_equal_cold_solve(log12):
    """S = T: every stream is its cold step 0, the plain cold batch."""
    cold, _ = T.solve_batched_ds(T.to_ds_batch(log12, device="cpu"),
                                 CASSIE.shape, TOPTS, device="cpu")
    sols = _replay(log12, 12)
    np.testing.assert_allclose(_z(sols), _z(cold), atol=0)
    np.testing.assert_array_equal(_d(sols, "n_iter"), _d(cold, "n_iter"))


def test_stage_times_split_cold_and_warm_steps(log8):
    """``stage_times`` receives the cold step's stages apart from the warm
    steps' sums, with the KKT-seed rescue count of the warm steps; the
    solutions are those of an unstaged replay."""
    stages = {}
    sols, _ = T.replay_ds_streams(
        T.to_ds_batch(log8, device="cpu"), CASSIE.shape, TOPTS,
        n_streams=2, device="cpu", stage_times=stages,
    )
    assert set(stages) == {"step0", "warm"}
    for key in ("scaling", "operator", "endgame", "finalize"):
        assert stages["step0"][key] > 0 and stages["warm"][key] > 0
    assert "n_kkt_rescue" not in stages["step0"]
    # the hybrid path refreshes its carried seed and has no rescue
    assert "n_kkt_rescue" not in stages["warm"]
    np.testing.assert_array_equal(_z(sols), _z(_replay(log8, 2)))


def test_warm_steps_cut_iterations(log12):
    S, steps = 2, 6
    cold, _ = T.solve_batched_ds(T.to_ds_batch(log12, device="cpu"),
                                 CASSIE.shape, TOPTS, device="cpu")
    sols = _replay(log12, S)
    assert (_d(sols, "solve_status") == 0).all()
    warm = np.arange(S * steps) % steps != 0
    assert _d(sols, "n_iter")[warm].sum() < _d(cold, "n_iter")[warm].sum()
