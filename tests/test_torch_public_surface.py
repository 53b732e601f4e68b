"""The port's public helpers and call options that the JAX package has
beside its engines, against the JAX package's on the CPU:

* `types.stack_qps` (from reference-schema dicts and from single
  `QPBatch`es), `QPBatch.batch_shape`, `QPBatch.astype`,
  `ops.scaling.identity_scaling`, `core.ds_engine.pad_batch_last` and
  `core.api.default_dtype`: equal to the JAX package's arrays exactly;
* `utils.timing.timed`: the best of ``reps`` calls, the first not
  counted, the last call's result;
* `solve(rho=, operator=)` and `solve_batched_fast(rho=<one per
  instance>, operator=)`: the same prebuilt operator (the JAX package's
  `admm_operator`, one per instance) given to both packages; status and
  n_iter equal, and per instance |dz| <= 1e-9 (1 + max |z|), the bar
  `tests/test_torch_api.py` holds the f64 engine to on Cassie's raw
  data (|z| reaches 92 here, and up to 2000 iterations in each
  package's operation order carry the last bits to about 4e-9); each
  call equals the port's solve that builds the operator itself to the
  same bar, and bit for bit when given the port's own operator;
* ``timing=False`` on the three batched entry points: the results of the
  ``timing=True`` call bit for bit, with both time fields zero;
* `core.ds_engine.constrained_indices`, which such a call runs on the
  reduced path: the JAX package's coordinates, the bounds read once per
  pair of tensors and read again after an in-place change.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache

import fcc_qp_tpu as J
import fcc_qp_tpu_torch as T
from fcc_qp_tpu.core import api as japi
from fcc_qp_tpu.core.batched import _batched_factor, solve_batched_fast_jit
from fcc_qp_tpu.core.ds_engine import constrained_indices as jcon_idx
from fcc_qp_tpu.core.ds_engine import pad_batch_last as jpad
from fcc_qp_tpu.core.ds_engine import to_ds_batch as jto_ds
from fcc_qp_tpu.models.osc import CASSIE, generate_osc_batch
from fcc_qp_tpu.ops.kkt import admm_operator as jadmm_operator
from fcc_qp_tpu.ops.scaling import identity_scaling as jidentity
from fcc_qp_tpu.types import stack_qps as jstack
from fcc_qp_tpu.utils.io import stack_qp_dicts
from fcc_qp_tpu_torch.core.api import default_dtype
from fcc_qp_tpu_torch.core.ds_engine import constrained_indices as con_idx
from fcc_qp_tpu_torch.core.ds_engine import pad_batch_last
from fcc_qp_tpu_torch.ops.scaling import identity_scaling
from fcc_qp_tpu_torch.parallel.mesh import leaves
from fcc_qp_tpu_torch.types import stack_qps
from fcc_qp_tpu_torch.utils.timing import timed

torch.set_num_threads(1)

KEYS = ("Q", "b", "A_eq", "b_eq", "friction_coeffs", "lb", "ub")
TSHAPE = T.ProblemShape(*(getattr(CASSIE.shape, f) for f in (
    "num_vars", "num_eq", "nc", "lambda_c_start")))
# the parity engine's options of the batched engines' tests (a rho given
# per call replaces opts.rho)
OPTS = dict(max_iter=2000, rho=1.0, eps_fcone=1e-6, eps_bound=1e-6)
# the reduced path as the bench runs it, cut to a short solve
REDUCED = dict(max_iter=200, rho=0.05, eps_fcone=1e-6, eps_bound=1e-6,
               scaling=True, splitting="constrained", presolve="operator",
               polish=True, polish_rounds=2)


@pytest.fixture(autouse=True, scope="module")
def without_shared_cache():
    """This module's JAX programs compile without the persistent cache
    the test workers share: reading it is where workers have died
    (ROADMAP.md queue C, C1). Switched back at the module's end; the
    port's other test modules with JAX compiles of their own import
    it."""
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", True)
    compilation_cache.reset_cache()


@pytest.fixture(scope="module")
def dicts():
    return generate_osc_batch(CASSIE, 16, seed=0)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(z, zj):
    """|dz| <= 1e-9 (1 + max |z|) per instance."""
    z, zj = np.atleast_2d(z), np.atleast_2d(zj)
    bar = 1e-9 * (1.0 + np.abs(zj).max(axis=1))
    assert (np.abs(z - zj).max(axis=1) <= bar).all()


def _tqp(stacked):
    return T.QPBatch(**{k: torch.from_numpy(np.asarray(stacked[k]))
                        for k in KEYS})


def _helper_pairs(name, dicts):
    """(JAX arrays, port tensors) of one helper on the same inputs."""
    singles = dicts[:3]
    if name == "stack_qps_dicts":
        j, t = jstack(singles), stack_qps(singles, device="cpu")
        return [getattr(j, k) for k in KEYS], [getattr(t, k) for k in KEYS]
    if name == "stack_qps_batches":
        j = jstack([J.QPBatch(**{k: jnp.asarray(d[k]) for k in KEYS})
                    for d in singles])
        t = stack_qps([T.QPBatch(**{k: torch.from_numpy(d[k]) for k in KEYS})
                       for d in singles], device="cpu")
        return [getattr(j, k) for k in KEYS], [getattr(t, k) for k in KEYS]
    if name == "batch_shape":
        j, t = jstack(singles), stack_qps(singles, device="cpu")
        return ([np.asarray(j.batch_shape), np.asarray(j.Q[0].shape[:-2])],
                [np.asarray(tuple(t.batch_shape)),
                 np.asarray(tuple(stack_qps(singles[:1], device="cpu").Q[0]
                                  .shape[:-2]))])
    if name == "astype":
        j = jstack(singles).astype(jnp.float32)
        t = stack_qps(singles, device="cpu").astype(torch.float32)
        assert all(getattr(t, k).dtype == torch.float32 for k in KEYS)
        return [getattr(j, k) for k in KEYS], [getattr(t, k) for k in KEYS]
    if name == "identity_scaling":
        j = jidentity(60, 38, 5)
        t = identity_scaling(60, 38, 5, device="cpu")
        assert t.d.dtype == torch.float32
        return list(j), list(t)
    if name == "pad_batch_last":
        rng = np.random.default_rng(3)
        tree = {"a": rng.normal(size=(3, 4, 5)), "b": rng.normal(size=(5,))}
        (jt, jb), (tt, tb) = (
            jpad({k: jnp.asarray(v) for k, v in tree.items()}, 8),
            pad_batch_last({k: torch.from_numpy(v) for k, v in tree.items()},
                           8))
        assert jb == tb == 5 and tt["a"].shape == (3, 4, 8)
        same, b0 = pad_batch_last({"a": torch.zeros(2, 8)}, 8)
        assert b0 == 8 and same["a"].shape == (2, 8)
        return [jt["a"], jt["b"]], [tt["a"], tt["b"]]
    if name == "default_dtype":
        assert default_dtype() == torch.float64
        assert T.FCCQP(60, 38, 12, 38, device="cpu").dtype == default_dtype()
        return ([np.zeros(1, japi.default_dtype())],
                [torch.zeros(1, dtype=default_dtype())])
    raise ValueError(name)


@pytest.mark.parametrize("name", [
    "stack_qps_dicts", "stack_qps_batches", "batch_shape", "astype",
    "identity_scaling", "pad_batch_last", "default_dtype"])
def test_helper_matches_jax(dicts, name):
    js, ts = _helper_pairs(name, dicts)
    assert len(js) == len(ts)
    for j, t in zip(js, ts):
        j, t = np.asarray(j), _np(t)
        assert j.dtype == t.dtype and j.shape == t.shape
        np.testing.assert_array_equal(t, j)


def test_timed_best_of_reps_without_the_first_call():
    sleeps = iter([0.3, 0.06, 0.02, 0.04])
    calls = []

    def fn(x, scale=1.0):
        calls.append(x)
        time.sleep(next(sleeps) * scale)
        return {"n": torch.tensor(len(calls))}

    best, out = timed(fn, 7, reps=3, scale=1.0)
    assert calls == [7] * 4
    assert int(out["n"]) == 4
    assert 0.02 <= best < 0.04


def test_stack_qps_needs_a_card_by_default(dicts, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        stack_qps(dicts[:2])
    with pytest.raises(RuntimeError, match="CUDA"):
        identity_scaling(4, 2, 3)


def test_solve_with_rho_and_operator_matches_jax(dicts):
    """One Cassie instance at a rho of its own and the JAX package's
    operator for that rho, in both packages; the port's call equals its
    solve at ``opts.replace(rho=rho)`` that builds the operator."""
    d = dicts[5]
    rho = 0.7
    jq = J.QPBatch(**{k: jnp.asarray(d[k]) for k in KEYS})
    F, xc = jax.jit(jadmm_operator)(jq.Q, jq.b, jq.A_eq, jq.b_eq,
                                    jnp.asarray(rho))
    jsol, _ = jax.jit(J.solve, static_argnames=("shape", "opts"))(
        jq, shape=CASSIE.shape, opts=J.FCCQPOptions(**OPTS),
        rho=jnp.asarray(rho), operator=(F, xc))
    tq = T.QPBatch(**{k: torch.from_numpy(d[k]) for k in KEYS})
    op = (torch.from_numpy(np.array(F)), torch.from_numpy(np.array(xc)))
    tsol, _ = T.solve(tq, TSHAPE, T.FCCQPOptions(**OPTS), device="cpu",
                      rho=torch.tensor(rho, dtype=torch.float64),
                      operator=op)
    assert int(tsol.details.n_iter) == int(jsol.details.n_iter) < 2000
    assert int(tsol.details.solve_status) == int(jsol.details.solve_status)
    _close(tsol.z.numpy(), np.asarray(jsol.z))
    own, _ = T.solve(tq, TSHAPE, T.FCCQPOptions(**dict(OPTS, rho=rho)),
                     device="cpu")
    assert int(own.details.n_iter) == int(tsol.details.n_iter)
    _close(own.z.numpy(), tsol.z.numpy())
    # the operator the port builds itself, given back: bit for bit
    from fcc_qp_tpu_torch.ops.kkt import admm_operator
    mine = admm_operator(tq.Q[None], tq.b[None], tq.A_eq[None],
                         tq.b_eq[None], rho)
    again, _ = T.solve(tq, TSHAPE, T.FCCQPOptions(**OPTS), device="cpu",
                       rho=rho, operator=mine)
    assert torch.equal(again.z, own.z)


def test_solve_batched_fast_with_rho_vector_and_operator_matches_jax(dicts):
    stacked = stack_qp_dicts(dicts)
    B = len(dicts)
    rho = np.linspace(0.25, 4.0, B)
    jq = J.QPBatch(**{k: jnp.asarray(stacked[k]) for k in KEYS})
    op = jax.jit(_batched_factor)(jq, jnp.asarray(rho))
    jsol, _ = solve_batched_fast_jit(jq, CASSIE.shape, J.FCCQPOptions(**OPTS),
                                     None, False, jnp.asarray(rho), op, False)
    tq = _tqp(stacked)
    top = tuple(torch.from_numpy(np.array(a)) for a in op)
    tsol, _ = T.solve_batched_fast(tq, TSHAPE, T.FCCQPOptions(**OPTS),
                                   rho=torch.from_numpy(rho), operator=top,
                                   device="cpu")
    d = tsol.details
    np.testing.assert_array_equal(d.n_iter.numpy(),
                                  np.asarray(jsol.details.n_iter))
    np.testing.assert_array_equal(d.solve_status.numpy(),
                                  np.asarray(jsol.details.solve_status))
    _close(tsol.z.numpy(), np.asarray(jsol.z))
    assert (d.solve_time > 0).all()
    # rho alone: the port builds the same operator
    own, _ = T.solve_batched_fast(tq, TSHAPE, T.FCCQPOptions(**OPTS),
                                  rho=torch.from_numpy(rho), device="cpu")
    np.testing.assert_array_equal(own.details.n_iter.numpy(),
                                  d.n_iter.numpy())
    _close(own.z.numpy(), tsol.z.numpy())
    # given the port's own operator back: bit for bit
    from fcc_qp_tpu_torch.ops.kkt import admm_operator
    mine = admm_operator(tq.Q, tq.b, tq.A_eq, tq.b_eq, torch.from_numpy(rho))
    again, _ = T.solve_batched_fast(tq, TSHAPE, T.FCCQPOptions(**OPTS),
                                    rho=torch.from_numpy(rho), operator=mine,
                                    device="cpu")
    assert torch.equal(again.z, own.z)


def _untimed_pairs(dicts):
    """(name, timed call, untimed call) of each batched entry point, on 4
    Cassie instances."""
    stacked = stack_qp_dicts(dicts[:4])
    qp = _tqp(stacked)
    ds = T.to_ds_batch(stacked, device="cpu")
    o = T.FCCQPOptions(**OPTS)
    red = T.FCCQPOptions(**REDUCED)
    rho = torch.linspace(0.5, 2.0, 4, dtype=torch.float64)
    return [
        ("solve_batched_ds (reduced)", lambda timing: T.solve_batched_ds(
            ds, TSHAPE, red, device="cpu", timing=timing)),
        ("solve_batched_ds (full)", lambda timing: T.solve_batched_ds(
            ds, TSHAPE, o.replace(max_iter=300), device="cpu",
            timing=timing)),
        ("solve_batched", lambda timing: T.solve_batched(
            qp, TSHAPE, o, device="cpu", timing=timing)),
        ("solve_batched_fast", lambda timing: T.solve_batched_fast(
            qp, TSHAPE, o, rho=rho, device="cpu", timing=timing)),
    ]


def test_timing_false_equals_timed_solves(dicts):
    for name, call in _untimed_pairs(dicts):
        (ts, tw), (us, uw) = call(True), call(False)
        assert torch.equal(us.z, ts.z), name
        for f in ("n_iter", "solve_status", "admm_residual_bounds",
                  "admm_residual_friction_cone", "equality_viol",
                  "polish_accepted"):
            assert torch.equal(getattr(us.details, f),
                               getattr(ts.details, f)), (name, f)
        for a, b in zip(leaves(uw), leaves(tw)):
            assert torch.equal(a, b), name
        for f in ("solve_time", "factorization_time"):
            t = getattr(us.details, f)
            assert t.shape == (4,) and not t.any(), (name, f)
        assert (ts.details.solve_time > 0).all(), name


def test_constrained_indices_read_once_per_bounds(dicts):
    """The coordinates equal the JAX package's; a second call on the same
    bounds returns the first call's tuple itself (nothing read again);
    after an in-place change of ``lb`` the bounds are read again."""
    stacked = stack_qp_dicts(dicts)
    qp = T.to_ds_batch(stacked, device="cpu")
    want = jcon_idx(jto_ds(stacked), CASSIE.shape)
    first = con_idx(qp, TSHAPE)
    assert first == tuple(want)
    assert con_idx(qp, TSHAPE) is first
    free = next(i for i in range(TSHAPE.num_vars) if i not in first)
    qp.lb[free] = -1.0
    again = con_idx(qp, TSHAPE)
    assert again is not first and free in again
    assert again == tuple(sorted(set(first[:-TSHAPE.nc]) | {free})
                          ) + first[-TSHAPE.nc:]
