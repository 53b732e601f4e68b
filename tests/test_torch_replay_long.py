"""Parity of the port's warm replay with the JAX package's on three
streams of the bench's long walking log (`generate_osc_sequence(CASSIE,
65536, seed=0, smoothness=0.002)` in 4096 streams x 16 steps), on the
CPU, at the bench flags.

These are the streams on which the bench-shape replay on the card
(`chip_smoke.py`, replay phase) found its only polish-accepted warm
steps with an equality residual above 1e-8: each follows a step that
needed polish retries, and its first polish attempt is accepted with a
refined solve only as exact as the acceptance test asks. The JAX
package accepts the same steps in the same way (ROADMAP.md queue C).
Stream 3268 also holds two steps that run hundreds of ADMM iterations,
where the lazy path's f32 operator rounds differently from XLA's.
"""

import numpy as np
import pytest

import fcc_qp_tpu_torch as T
from fcc_qp_tpu.core import ds_engine as jeng
from fcc_qp_tpu.models.osc import CASSIE, generate_osc_sequence
from fcc_qp_tpu.utils.io import stack_qp_dicts
from test_torch_replay import TOPTS
from test_torch_slice import _d
from test_warm_replay_bench import BENCH_OPTS

STREAMS = (1938, 2889, 3268)
STEPS = 16


@pytest.fixture(scope="module")
def replays():
    # the whole log: the generator sets the actuator bounds from a
    # quantile over every step, so a shorter log is other data
    qps = generate_osc_sequence(CASSIE, 65536, seed=0, smoothness=0.002)
    sub = stack_qp_dicts([qps[s * STEPS + t]
                          for s in STREAMS for t in range(STEPS)])
    del qps
    S = len(STREAMS)
    jsol, _ = jeng.replay_ds_streams(jeng.to_ds_batch(sub), CASSIE.shape,
                                     BENCH_OPTS, n_streams=S)
    tsol, _ = T.replay_ds_streams(T.to_ds_batch(sub, device="cpu"),
                                  CASSIE.shape, TOPTS, n_streams=S,
                                  device="cpu")
    return jsol, tsol


def test_loose_warm_acceptances_are_the_references(replays):
    jsol, tsol = replays
    for name in ("solve_status", "polish_accepted", "polish_attempts"):
        np.testing.assert_array_equal(_d(tsol, name), _d(jsol, name))
    assert (_d(tsol, "solve_status") == 0).all()
    acc = _d(tsol, "polish_accepted") > 0
    loose = {}
    for name, sol in (("port", tsol), ("jax", jsol)):
        eq = _d(sol, "equality_viol")
        loose[name] = np.where(acc & (eq > 1e-8))[0]
        print(name, "accepted steps above 1e-8 (row, |A z - b|):",
              [(int(r), float(eq[r])) for r in loose[name]])
        # the acceptance test's own bound
        assert (eq[acc] <= BENCH_OPTS.eps_bound).all()
    np.testing.assert_array_equal(loose["port"], loose["jax"])
    # one such step in each stream, right after a step that retried
    np.testing.assert_array_equal(loose["port"] % STEPS, [15, 12, 8])
    att = _d(tsol, "polish_attempts")
    assert (att[loose["port"] - 1] > 1).all()


def test_n_iter_moves_only_where_the_f32_operator_ran(replays):
    jsol, tsol = replays
    n, nj = _d(tsol, "n_iter"), _d(jsol, "n_iter")
    ran = _d(jsol, "n_iter_f32") > 0
    np.testing.assert_array_equal(n[~ran], nj[~ran])
    print("iterated steps (row, port n_iter, JAX n_iter):",
          [(int(r), int(n[r]), int(nj[r])) for r in np.where(ran)[0]])
    assert (np.abs(n - nj) <= 0.01 * nj).all()
