"""The port's pipelined server (`fcc_qp_tpu_torch.FCCQPServer`) equals
the serial drop-in loop (`FCCQP` with ``set_warm_start(i > 0)``), on the
CPU, at the options and bars of the JAX package's server tests
(`tests/test_serving.py`): warm-chained solves, results in submission
order, statuses equal and |dz| <= 1e-9 (ds) / 1e-8 (f64). The drop-in
class itself is held against the JAX package in
`tests/test_torch_api.py`."""

import numpy as np
import pytest
import torch

import fcc_qp_tpu_torch as T
from fcc_qp_tpu_torch.models.osc import CASSIE, generate_osc_sequence

torch.set_num_threads(1)

DS_OPTS = T.FCCQPOptions(
    max_iter=600, rho=0.05, eps_fcone=1e-6, eps_bound=1e-6,
    presolve="operator", scaling=True, splitting="constrained",
    kkt_refine_steps=1, polish=True, polish_rounds=4,
    polish_newton_steps=4,
)
F64_OPTS = T.FCCQPOptions(max_iter=2000, rho=1.0, eps_fcone=1e-6,
                          eps_bound=1e-6)
KEYS = ("Q", "b", "A_eq", "b_eq", "friction_coeffs", "lb", "ub")


@pytest.fixture(scope="module")
def log():
    return generate_osc_sequence(CASSIE, 6, seed=1)


def _serial(log, engine, opts):
    solver = T.FCCQP(60, 38, 12, 38, engine=engine, device="cpu")
    solver.set_options(opts)
    zs, st = [], []
    for i, qp in enumerate(log):
        solver.set_warm_start(i > 0)
        solver.Solve(*(qp[k] for k in KEYS))
        sol = solver.GetSolution()
        zs.append(sol.z)
        st.append(sol.details.solve_status)
    return np.stack(zs), np.asarray(st)


def _served(log, engine, opts, depth):
    server = T.FCCQPServer(CASSIE.shape, opts, depth=depth, engine=engine,
                           device="cpu")
    tickets = [server.submit(*(qp[k] for k in KEYS)) for qp in log]
    results = dict(server.drain())
    assert sorted(results) == tickets
    assert server.in_flight == 0
    zs = np.stack([results[t].z for t in tickets])
    st = np.asarray([results[t].details.solve_status for t in tickets])
    assert all(results[t].details.solve_time > 0 for t in tickets)
    return zs, st


@pytest.mark.parametrize("engine,depth,steps,dz", [
    ("ds", 4, 6, 1e-9), ("ds", 1, 6, 1e-9),
    # four f64 steps at depth 3: the fourth submit retires the first
    ("f64", 3, 4, 1e-8),
])
def test_server_matches_serial_loop(log, engine, depth, steps, dz):
    opts = DS_OPTS if engine == "ds" else F64_OPTS
    z_ref, st_ref = _serial(log[:steps], engine, opts)
    z_srv, st_srv = _served(log[:steps], engine, opts, depth)
    assert (st_ref == 0).any()
    np.testing.assert_array_equal(st_srv, st_ref)
    assert np.abs(z_srv - z_ref).max() <= dz


def test_depth_bounds_inflight(log):
    server = T.FCCQPServer(CASSIE.shape, DS_OPTS, depth=2, engine="ds",
                           device="cpu")
    for qp in log[:4]:
        server.submit(*(qp[k] for k in KEYS))
        assert server.in_flight <= 2
    server.drain()
    assert server.in_flight == 0


def test_result_blocks_and_pops(log):
    server = T.FCCQPServer(CASSIE.shape, DS_OPTS, depth=4, engine="ds",
                           device="cpu")
    t0 = server.submit(*(log[0][k] for k in KEYS))
    sol = server.result(t0)
    assert sol.details.solve_status == 0
    assert sol.z.shape == (60,)
    with pytest.raises(KeyError):
        server.result(t0)
    assert server.poll() == []


def test_reset_warm_start(log):
    server = T.FCCQPServer(CASSIE.shape, DS_OPTS, depth=2, engine="ds",
                           device="cpu")
    sub = lambda: server.submit(*(log[0][k] for k in KEYS))
    na = server.result(sub()).details.n_iter
    nb = server.result(sub()).details.n_iter  # warm re-solve: ~free
    assert nb <= max(2, na // 5)
    server.reset_warm_start()
    nc = server.result(sub()).details.n_iter  # cold again
    assert nc > nb


def test_arguments_checked():
    with pytest.raises(ValueError):
        T.FCCQPServer(CASSIE.shape, DS_OPTS, depth=0, device="cpu")
    with pytest.raises(ValueError):
        T.FCCQPServer(CASSIE.shape, DS_OPTS, engine="f32", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            T.FCCQPServer(CASSIE.shape, DS_OPTS)
