"""The port's drop-in `FCCQP` against the JAX package's, on the CPU: the
reference loop (`FCCQP(60, 38, 12, 38)`, ``set_warm_start(i > 0)``,
`Solve`, `GetSolution`) over the same walking sequence in both, and the
probes of the verify notes on both engines.

The Cassie loop runs at the options and on the walking log of
`tests/test_timing_api.py`, so the JAX programs are the ones that file
compiles. Bars: the f64 engine gives per-step n_iter and status equal
and |dz| <= 1e-9 on the random QPs of `tests/test_solver.py`; on
Cassie's raw, unequilibrated data the two packages' KKT operators differ
by rounding times the KKT's conditioning, and |dz| <= 1e-9 (1 + max
|z|). The ds engine gives statuses and polish acceptance equal, n_iter
equal except where an instance ran approach iterations on the lazy
path's f32 operator (ROADMAP.md queue C), and |dz| <= 1e-6."""

import numpy as np
import pytest
import torch

import fcc_qp_tpu as J
import fcc_qp_tpu_torch as T
from fcc_qp_tpu.models.osc import CASSIE, generate_osc_sequence
from test_solver import SHAPE, random_qp
from test_timing_api import OPTS as TIMING_OPTS

torch.set_num_threads(1)

CASSIE_OPTS = {f: getattr(TIMING_OPTS, f)
               for f in ("max_iter", "rho", "eps_fcone", "eps_bound")}
RANDOM = dict(max_iter=500, rho=10.0, eps_fcone=1e-8, eps_bound=1e-8)


def _loop(solver, seq):
    out = []
    for i, q in enumerate(seq):
        solver.set_warm_start(i > 0)
        solver.Solve(q["Q"], q["b"], q["A_eq"], q["b_eq"],
                     q["friction_coeffs"], q["lb"], q["ub"])
        out.append(solver.GetSolution())
    return out


def _random_seq():
    base = random_qp(np.random.default_rng(5), SHAPE, bound=2.0)
    return [dict(base, b=base["b"] + 0.05 * t, b_eq=base["b_eq"] + 0.02 * t)
            for t in range(4)]


def _pair(shape, engine, opts):
    j = J.FCCQP(*shape, engine=engine)
    t = T.FCCQP(*shape, engine=engine, device="cpu")
    j.set_options(J.FCCQPOptions(**opts))
    t.set_options(T.FCCQPOptions(**opts))
    return j, t


@pytest.fixture(scope="module")
def walking():
    return generate_osc_sequence(CASSIE, 6, seed=0, smoothness=0.002)


@pytest.mark.parametrize("data", ["random", "cassie"])
def test_f64_engine_matches_jax(walking, data):
    if data == "random":
        seq, opts = _random_seq(), RANDOM
        shape = (SHAPE.num_vars, SHAPE.num_eq, SHAPE.nc, SHAPE.lambda_c_start)
    else:
        seq, opts, shape = walking, CASSIE_OPTS, (60, 38, 12, 38)
    j, t = _pair(shape, "f64", opts)
    assert t.engine == "f64" and T.FCCQP(*shape, device="cpu").engine == "f64"
    for a, b in zip(_loop(j, seq), _loop(t, seq)):
        assert b.details.n_iter == a.details.n_iter
        assert b.details.solve_status == a.details.solve_status
        assert isinstance(b.z, np.ndarray) and b.z.shape == (shape[0],)
        tol = 1e-9 * (1.0 if data == "random" else 1.0 + np.abs(a.z).max())
        assert np.abs(b.z - np.asarray(a.z)).max() <= tol
        assert 0 < b.details.factorization_time <= b.details.solve_time
    assert any(s.details.n_iter < opts["max_iter"] for s in _loop(t, seq))


def test_ds_engine_matches_jax(walking):
    j, t = _pair((60, 38, 12, 38), "ds", CASSIE_OPTS)
    for a, b in zip(_loop(j, walking), _loop(t, walking)):
        assert b.details.solve_status == a.details.solve_status
        assert b.details.polish_accepted == a.details.polish_accepted
        if a.details.n_iter_f32 == 0:
            assert b.details.n_iter == a.details.n_iter
        assert np.abs(b.z - np.asarray(a.z)).max() <= 1e-6


def _probe_qp(shape):
    return random_qp(np.random.default_rng(9), shape, bound=1.0)


@pytest.mark.parametrize("engine", ["f64", "ds"])
def test_probes(engine):
    with pytest.raises(ValueError, match="multiple of 3"):
        T.FCCQP(10, 2, 4, 0, engine=engine, device="cpu")
    shape = T.ProblemShape(18, 8, 6, 10)
    solver = T.FCCQP(18, 8, 6, 10, engine=engine, device="cpu")
    with pytest.raises(RuntimeError, match="Solve"):
        solver.GetSolution()
    q = _probe_qp(SHAPE)
    args = [q[k] for k in ("Q", "b", "A_eq", "b_eq", "friction_coeffs",
                           "lb", "ub")]
    with pytest.raises(ValueError, match="Q must be"):
        solver.Solve(np.eye(17), *args[1:])
    bad = dict(q, lb=q["ub"] + 1.0)
    with pytest.raises(ValueError, match="lb > ub"):
        solver.Solve(*[bad[k] for k in ("Q", "b", "A_eq", "b_eq",
                                        "friction_coeffs", "lb", "ub")])
    assert solver.contact_vars_start() == shape.lambda_c_start
    # an equality-only problem: no cones, every bound infinite
    eq = random_qp(np.random.default_rng(1),
                   J.ProblemShape(12, 5, 0, 0))
    s2 = T.FCCQP(12, 5, 0, 0, engine=engine, device="cpu")
    s2.Solve(*[eq[k] for k in ("Q", "b", "A_eq", "b_eq", "friction_coeffs",
                               "lb", "ub")])
    res = s2.GetSolution()
    assert res.details.n_iter == 0 and res.details.solve_status == 0
    assert np.abs(eq["A_eq"] @ res.z - eq["b_eq"]).max() < 1e-9


def test_setters_and_options():
    s = T.FCCQP(60, 38, 12, 38, device="cpu")
    s.set_rho(0.5)
    s.set_max_iter(77)
    assert s.options.rho == 0.5 and s.options.max_iter == 77
    for bad in (lambda: s.set_rho(0.0), lambda: s.set_max_iter(0)):
        with pytest.raises(ValueError):
            bad()
    with pytest.raises(ValueError, match="engine"):
        T.FCCQP(60, 38, 12, 38, engine="tpu", device="cpu")
