"""Parity of the port's warm-started replay with the JAX package's, on the
CPU, at the bench flags.

The JAX side runs its plain XLA chunk bodies (``use_pallas=False``),
which its own tests hold equal to its Pallas kernels; the port runs the
plain versions its kernel wrappers take for CPU tensors. The walking log
and the options are those of `tests/test_warm_replay_bench.py` (S = 16
streams x 4 steps).

Every JAX replay here runs step by step through the same compiled
function that the JAX package's `replay_ds_streams` scans over
(`_solve_ds_reduced_jit` with its operator cache, cold for step 0 and
warm after), always on batches of S = 16, so the module compiles two
JAX programs and reuses them for every test.

The long-log tests take three streams of the bench's long walking log
(`generate_osc_sequence(CASSIE, 65536, seed=0, smoothness=0.002)` in
4096 streams x 16 steps): the streams on which the bench-shape replay on
the card (`chip_smoke.py`, replay phase) found its only polish-accepted
warm steps with an equality residual above 1e-8. Each follows a step
that needed polish retries, and its first polish attempt is accepted
with a refined solve only as exact as the acceptance test asks; the JAX
package accepts the same steps in the same way (ROADMAP.md queue C).
Stream 3268 also holds two steps that run hundreds of ADMM iterations,
where the lazy path's f32 operator rounds differently from XLA's.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import fcc_qp_tpu_torch as T
from fcc_qp_tpu.core import ds_engine as jeng
from fcc_qp_tpu.models.osc import (CASSIE, generate_osc_batch,
                                    generate_osc_sequence)
from fcc_qp_tpu.ops.ds_linalg import kkt_inverse_f32_refresh as jrefresh
from fcc_qp_tpu.ops.ds_linalg import kkt_inverse_f32_seed as jseed
from fcc_qp_tpu.utils.io import stack_qp_dicts
from fcc_qp_tpu_torch.core import ds_engine as teng
from fcc_qp_tpu_torch.ops.ds_linalg import kkt_inverse_f32_refresh
from test_torch_slice import _d, _polish_bars, _z
from test_warm_replay_bench import BENCH_OPTS, S, STEPS

TOPTS = T.FCCQPOptions(**{
    f: getattr(BENCH_OPTS, f) for f in BENCH_OPTS.__dataclass_fields__
})
# streams whose warm-step n_iter may differ from the JAX package's
# because the cold step's known f32 drift (ROADMAP.md queue C, "lazy-path
# f32 operator is not bit-identical") carries into them; none so far
DRIFT_STREAMS = ()
LONG_STREAMS = (1938, 2889, 3268)
LONG_STEPS = 16


@pytest.fixture(scope="module")
def log():
    return stack_qp_dicts(
        generate_osc_sequence(CASSIE, S * STEPS, seed=0, smoothness=0.002)
    )


def _step(stacked, t):
    """Step t of every stream (stream s owns rows s*STEPS .. s*STEPS+3)."""
    return {k: v[t::STEPS] for k, v in stacked.items()}


def _np(a):
    return np.array(a)


def _con_idx(stacked):
    return jeng.constrained_indices(jeng.to_ds_batch(stacked), CASSIE.shape)


def _jax_replay(stacked, steps, con_idx):
    """The JAX package's warm replay of ``stacked`` (S = 16 streams of
    ``steps`` consecutive rows), one jitted step at a time: the function
    its `replay_ds_streams` scans over, with the same carried warm state
    and operator cache. Returns the details and z in global row order."""
    sols, ws, cache = [], None, None
    for t in range(steps):
        sol, ws, cache = jeng._solve_ds_reduced_jit(
            jeng.to_ds_batch({k: v[t::steps] for k, v in stacked.items()}),
            ws, CASSIE.shape, BENCH_OPTS, t > 0, con_idx, cache=cache,
            with_cache=True,
        )
        sols.append(sol)

    def glob(get):
        a = np.stack([np.asarray(get(s)) for s in sols], axis=1)
        return a.reshape(-1, *a.shape[2:])

    names = [f for f in sols[0].details.__dataclass_fields__]
    details = {n: glob(lambda s, n=n: getattr(s.details, n)) for n in names}
    return type(sols[0])(details=type(sols[0].details)(**details),
                         z=glob(lambda s: s.z))


def test_kkt_refresh_matches_jax(log):
    """A seed built on step t, refreshed against step t+1 (and, for the
    last four instances, against unrelated QPs, where the refresh cannot
    contract): same good/bad flags, same inverse."""
    qp0 = jeng.to_ds_batch(_step(log, 0))
    far = stack_qp_dicts(generate_osc_batch(CASSIE, 4, seed=3))
    nxt = _step(log, 1)
    for k in nxt:
        nxt[k] = np.concatenate([nxt[k][:12], far[k]])
    qp1 = jeng.to_ds_batch(nxt)
    con_idx = jeng.constrained_indices(jeng.to_ds_batch(log), CASSIE.shape)
    qs0, sc = jeng._scale_reduced(qp0, CASSIE.shape, BENCH_OPTS)
    qs1, _ = jeng._scale_reduced(qp1, CASSIE.shape, BENCH_OPTS, carried=sc)
    mask = np.zeros(CASSIE.shape.num_vars, np.float32)
    mask[list(con_idx)] = 1.0
    rho = (np.float32(BENCH_OPTS.rho) * mask[:, None]
           * np.ones((1, S), np.float32))
    X0, _ = jseed(qs0.Q, qs0.A_eq, rho)
    Xj, rj = jrefresh(X0, qs1.Q, qs1.A_eq, rho)
    Xt, rt = kkt_inverse_f32_refresh(
        torch.from_numpy(np.ascontiguousarray(np.moveaxis(_np(X0), -1, 0))),
        torch.from_numpy(_np(qs1.Q.hi)), torch.from_numpy(_np(qs1.A_eq.hi)),
        torch.from_numpy(rho),
    )
    good = _np(rj) <= 0.5
    np.testing.assert_array_equal(rt.numpy() <= 0.5, good)
    assert good[:12].all() and not good[12:].any()
    Xj = np.moveaxis(_np(Xj), -1, 0)
    scale = np.abs(Xj[good]).max()
    assert np.abs(Xt.numpy()[good] - Xj[good]).max() <= 1e-4 * scale


def test_one_warm_step_from_the_same_carried_state(log):
    """JAX solves step 0 cold with its operator cache; its warm state and
    cache, converted, warm-start step 1 in both packages."""
    con_idx = _con_idx(log)
    step0, step1 = _step(log, 0), _step(log, 1)
    _, jws, jcache = jeng._solve_ds_reduced_jit(
        jeng.to_ds_batch(step0), None, CASSIE.shape, BENCH_OPTS, False,
        con_idx, with_cache=True,
    )
    jsol, _, jcache1 = jeng._solve_ds_reduced_jit(
        jeng.to_ds_batch(step1), jws, CASSIE.shape, BENCH_OPTS, True,
        con_idx, cache=jcache, with_cache=True,
    )
    tws = T.warm_start_from_numpy(
        jws.x.hi, jws.x.lo, jws.mu_x.hi, jws.mu_x.lo, jws.mu_lambda_c.hi,
        jws.mu_lambda_c.lo, jws.rho, device="cpu",
    )
    tcache = T.operator_cache_from_numpy(
        jcache.kkt_seed, jcache.polish_seed, jcache.polish_cls,
        jcache.scales.d, jcache.scales.e, jcache.scales.c, device="cpu",
    )
    tsol, _, tcache1 = teng._solve_ds_reduced(
        T.to_ds_batch(step1, device="cpu"), tws, CASSIE.shape, TOPTS, True,
        con_idx, cache=tcache, with_cache=True,
    )
    for name in ("solve_status", "polish_accepted", "polish_attempts"):
        np.testing.assert_array_equal(_d(tsol, name), _d(jsol, name))
    # n_iter may move by one only where an instance ran approach chunks
    # on the refreshed f32 operator (ROADMAP.md queue C)
    dn = np.abs(_d(tsol, "n_iter") - _d(jsol, "n_iter"))
    iterated = _d(jsol, "n_iter_f32") > 0
    assert (dn[~iterated] == 0).all() and (dn <= 1).all()
    _polish_bars(step1, jsol, tsol)
    np.testing.assert_array_equal(tcache1.polish_cls.numpy(),
                                  _np(jcache1.polish_cls))
    for name in ("d", "e", "c"):
        np.testing.assert_array_equal(
            getattr(tcache1.scales, name).numpy(),
            _np(getattr(jcache1.scales, name)))


@pytest.fixture(scope="module")
def replays(log):
    jsol = _jax_replay(log, STEPS, _con_idx(log))
    tsol, _ = T.replay_ds_streams(
        T.to_ds_batch(log, device="cpu"), CASSIE.shape, TOPTS, n_streams=S,
        device="cpu",
    )
    return jsol, tsol


def test_replay_converges_like_jax(log, replays):
    jsol, tsol = replays
    np.testing.assert_array_equal(_d(tsol, "solve_status"),
                                  _d(jsol, "solve_status"))
    assert (_d(tsol, "solve_status") == 0).all()
    assert _d(tsol, "admm_residual_bounds").max() < 1e-6 + 1e-9
    assert _d(tsol, "admm_residual_friction_cone").max() < 1e-6 + 1e-9
    assert _z(tsol).shape == (S * STEPS, CASSIE.shape.num_vars)
    _polish_bars(log, jsol, tsol)


def test_replay_warm_steps_match_jax(replays):
    jsol, tsol = replays
    acc = _d(tsol, "polish_accepted").reshape(S, STEPS)
    np.testing.assert_array_equal(
        acc, _d(jsol, "polish_accepted").reshape(S, STEPS))
    assert acc[:, 1:].mean() >= 0.90
    n = _d(tsol, "n_iter").reshape(S, STEPS)
    assert np.median(n[:, 1:]) <= 15
    nj = _d(jsol, "n_iter").reshape(S, STEPS)
    keep = np.ones(S, bool)
    keep[list(DRIFT_STREAMS)] = False
    np.testing.assert_array_equal(n[keep, 1:], nj[keep, 1:])


def test_replay_times_stamped(replays):
    _, tsol = replays
    st, ft = _d(tsol, "solve_time"), _d(tsol, "factorization_time")
    assert (st > 0).all() and (st == st[0]).all()
    assert (ft > 0).all() and (ft == ft[0]).all()


@pytest.fixture(scope="module")
def long_replays(log):
    # the whole log: the generator sets the actuator bounds from a
    # quantile over every step, so a shorter log is other data
    qps = generate_osc_sequence(CASSIE, 65536, seed=0, smoothness=0.002)
    sub = stack_qp_dicts([qps[s * LONG_STEPS + t]
                          for s in LONG_STREAMS for t in range(LONG_STEPS)])
    del qps
    n = len(LONG_STREAMS)
    # JAX on S = 16 streams (the three, repeated), the batch its compiled
    # steps take; every instance is solved independently of the others
    reps = -(-S // n)
    rows = np.concatenate([np.arange(n * LONG_STEPS)] * reps)
    jsub = {k: v[rows[:S * LONG_STEPS]] for k, v in sub.items()}
    jfull = _jax_replay(jsub, LONG_STEPS, _con_idx(log))
    keep = slice(0, n * LONG_STEPS)
    jsol = type(jfull)(
        details=type(jfull.details)(**{
            f: getattr(jfull.details, f)[keep]
            for f in jfull.details.__dataclass_fields__}),
        z=jfull.z[keep])
    tsol, _ = T.replay_ds_streams(T.to_ds_batch(sub, device="cpu"),
                                  CASSIE.shape, TOPTS, n_streams=n,
                                  device="cpu")
    return jsol, tsol


def test_loose_warm_acceptances_are_the_references(long_replays):
    jsol, tsol = long_replays
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
    np.testing.assert_array_equal(loose["port"] % LONG_STEPS, [15, 12, 8])
    att = _d(tsol, "polish_attempts")
    assert (att[loose["port"] - 1] > 1).all()


def test_n_iter_moves_only_where_the_f32_operator_ran(long_replays):
    jsol, tsol = long_replays
    n, nj = _d(tsol, "n_iter"), _d(jsol, "n_iter")
    ran = _d(jsol, "n_iter_f32") > 0
    np.testing.assert_array_equal(n[~ran], nj[~ran])
    print("iterated steps (row, port n_iter, JAX n_iter):",
          [(int(r), int(n[r]), int(nj[r])) for r in np.where(ran)[0]])
    assert (np.abs(n - nj) <= 0.01 * nj).all()
