"""The port's static (read-free) solve, the form `core.graphs` captures
as CUDA graphs for `FCCQP` and `FCCQPServer`, on the CPU:

(a) it equals the eager solve bit for bit on both engines (statuses,
    n_iter, z, every diagnostic and the warm state) over a warm-chained
    walking log, at B = 1 through `CapturedSolve` (the code `FCCQP` and
    `FCCQPServer` run) and on one B = 4 batch through the engines'
    functions, at the options of `tests/test_torch_serving.py`;
(b) a server submit loop and a warm `FCCQP.Solve` complete under a
    dispatch mode that raises on every host read of a tensor, with the
    kernels' plain versions exempt (on the card the kernels take their
    place) and the drop-in's input check exempt (the reference asserts
    on the host).

The JAX bars of both classes are held in `tests/test_torch_serving.py`
and `tests/test_torch_api.py`, which now run this path."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode,
    _disable_current_modes,
)

import fcc_qp_tpu_torch as T
from fcc_qp_tpu_torch.core.ds_engine import (
    _solve_ds_reduced,
    constrained_indices,
    to_ds_batch,
)
from fcc_qp_tpu_torch.core.api import MAX_CAPTURES
from fcc_qp_tpu_torch.core.graphs import (
    STATS,
    CapturedSolve,
    SolveBuffers,
    pack_host,
    pack_solution,
)
from fcc_qp_tpu_torch.core.solver import _solve_core
from fcc_qp_tpu_torch.models.osc import CASSIE, generate_osc_sequence
from fcc_qp_tpu_torch.ops import pallas_admm
from fcc_qp_tpu_torch.utils.io import stack_qp_dicts
from test_torch_serving import DS_OPTS, F64_OPTS, KEYS

torch.set_num_threads(1)

OPTS = {"ds": DS_OPTS, "f64": F64_OPTS}


@pytest.fixture(scope="module")
def log():
    return generate_osc_sequence(CASSIE, 6, seed=1)


def _batch(qps, engine):
    """The QPs as one batch in the engine's layout."""
    if engine == "ds":
        return to_ds_batch(stack_qp_dicts(qps), device="cpu")
    st = stack_qp_dicts(qps)
    return T.QPBatch(*(torch.from_numpy(np.asarray(st[k], np.float64))
                       for k in KEYS))


def _solve(engine, qp, warm, static, con_idx):
    """One warm-chained solve of ``qp`` (cold when ``warm`` is None)."""
    if engine == "ds":
        return _solve_ds_reduced(qp, warm, CASSIE.shape, DS_OPTS,
                                 warm is not None, con_idx, static=static)
    return _solve_core(qp, CASSIE.shape, F64_OPTS, warm, warm is not None,
                       static=static)


def _warm_fields(engine, warm):
    names = (("x", "mu_x", "mu_lambda_c", "rho") if engine == "ds"
             else ("x", "mu_x", "mu_lambda_c"))
    return [getattr(warm, k) for k in names]


@pytest.mark.parametrize("engine", ["ds", "f64"])
def test_captured_solve_equals_eager_at_b1(log, engine):
    """`CapturedSolve` (graphs off: the CPU has none) over the log, its
    buffers chaining the warm state, against the eager engine chained
    step by step: packed results and warm buffers bit for bit."""
    con_idx = None
    if engine == "ds":
        con_idx = constrained_indices(_batch(log[:1], "ds"), CASSIE.shape)
    bufs = SolveBuffers(CASSIE.shape, engine, "cpu", OPTS[engine].rho)
    cap = CapturedSolve(CASSIE.shape, OPTS[engine], engine, bufs, con_idx)
    assert not cap.graphs
    warm, statuses = None, []
    for i, qp in enumerate(log):
        pack_host(CASSIE.shape, [qp[k] for k in KEYS], bufs.inp)
        cap.run(warm_start=i > 0)
        sol, warm = _solve(engine, _batch([qp], engine), warm, False, con_idx)
        assert torch.equal(bufs.out, pack_solution(sol)), f"step {i}"
        for a, b in zip(bufs.warm, _warm_fields(engine, warm)):
            assert torch.equal(a, b), f"step {i}: warm state"
        statuses.append(int(sol.details.solve_status[0]))
    assert statuses.count(0) > 0


# the reduced path's other branches the static form converts: adaptive
# rho (rebuilds selected on the device) with the replay's operator cache
# (the warm polish and its gathered retry), and the two-phase path
VARIANTS = {
    "ds": DS_OPTS, "f64": F64_OPTS,
    "ds_adaptive_cache": DS_OPTS.replace(adaptive_rho=True,
                                         adaptive_rho_interval=25),
    "ds_two_phase": DS_OPTS.replace(polish=False, phase1_tol=1e-2),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_static_equals_eager_at_b4(log, variant):
    """Two warm-chained steps of a B = 4 batch: the static solve against
    the eager one, every field bit for bit (and the operator cache where
    it is carried)."""
    engine = "f64" if variant == "f64" else "ds"
    opts = VARIANTS[variant]
    qp0, qp1 = _batch(log[:4], engine), _batch(log[2:6], engine)
    out = {}
    for static in (False, True):
        if engine == "f64":
            sol0, w = _solve_core(qp0, CASSIE.shape, opts, None, False,
                                  static=static)
            sol1, w = _solve_core(qp1, CASSIE.shape, opts, w, True,
                                  static=static)
            out[static] = (sol0, sol1, _warm_fields(engine, w), [])
            continue
        ci = constrained_indices(qp0, CASSIE.shape)
        kw = dict(with_cache=variant == "ds_adaptive_cache", static=static)
        r0 = _solve_ds_reduced(qp0, None, CASSIE.shape, opts, False, ci, **kw)
        cache = r0[2] if kw["with_cache"] else None
        r1 = _solve_ds_reduced(qp1, r0[1], CASSIE.shape, opts, True, ci,
                               cache=cache, **kw)
        carried = [t for t in (r1[2] if kw["with_cache"] else ())
                   if isinstance(t, torch.Tensor)]
        out[static] = (r0[0], r1[0], _warm_fields(engine, r1[1]), carried)
    for s_e, s_s in zip(out[False][:2], out[True][:2]):
        for f in dataclasses.fields(s_e.details):
            assert torch.equal(getattr(s_e.details, f.name),
                               getattr(s_s.details, f.name)), f.name
        assert torch.equal(s_e.z, s_s.z)
    for a, b in zip(out[False][2] + out[False][3],
                    out[True][2] + out[True][3]):
        assert torch.equal(a, b)
    assert (out[True][1].details.solve_status == 0).any()


# what a host read of a tensor dispatches: `bool()`, `int()`, `float()`,
# `.item()`, and the sync points of boolean indexing
_READS = {torch.ops.aten._local_scalar_dense, torch.ops.aten.nonzero,
          torch.ops.aten.is_nonzero, torch.ops.aten.masked_select,
          torch.ops.aten.item}
_PLAIN = ("admm_chunk_f64_plain", "admm_chunk_f32_plain",
          "admm_chunk_full_f64_plain", "admm_chunk_full_f32_plain")


class _NoHostReads(TorchDispatchMode):
    """Raises on every host read of a tensor, except inside the calls
    `exempt` wraps (the mode is suspended there)."""

    @staticmethod
    def exempt(fn):
        def run(*args, **kw):
            with _disable_current_modes():
                return fn(*args, **kw)
        return run

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in _READS:
            raise AssertionError(f"host read in the static path: {func}")
        return func(*args, **(kwargs or {}))


def test_the_mode_catches_a_read():
    with _NoHostReads(), pytest.raises(AssertionError, match="host read"):
        bool(torch.ones(2).sum() > 1)


@pytest.mark.parametrize("engine", ["ds", "f64"])
def test_no_host_read_in_server_and_dropin(log, engine, monkeypatch):
    mode = _NoHostReads()
    for name in _PLAIN:
        monkeypatch.setattr(pallas_admm, name,
                            mode.exempt(getattr(pallas_admm, name)))
    solver = T.FCCQP(60, 38, 12, 38, engine=engine, device="cpu")
    solver.set_options(OPTS[engine])
    solver.Solve(*(log[0][k] for k in KEYS))
    solver._validate = mode.exempt(solver._validate)
    server = T.FCCQPServer(CASSIE.shape, OPTS[engine], depth=4,
                           engine=engine, device="cpu")
    steps = log[1:5] if engine == "ds" else log[1:3]
    with mode:
        solver.set_warm_start(True)
        solver.Solve(*(log[1][k] for k in KEYS))
        tickets = [server.submit(*(qp[k] for k in KEYS)) for qp in steps]
        results = dict(server.drain())
    assert sorted(results) == tickets
    for r in [solver.GetSolution()] + [results[t] for t in tickets]:
        assert np.isfinite(r.z).all() and r.z.shape == (60,)
        assert r.details.solve_status in (0, 1)
        assert set(STATS) <= set(vars(r.details))
    assert any(results[t].details.solve_status == 0 for t in tickets)


def test_dropin_keeps_the_latest_captures(log):
    """`FCCQP` keeps one capture per option set, the `MAX_CAPTURES` used
    last; an option set whose capture was dropped is captured again and
    gives the same solve."""
    rhos = [0.1 * (i + 1) for i in range(MAX_CAPTURES + 2)]
    solver = T.FCCQP(60, 38, 12, 38, engine="f64", device="cpu")
    first = None
    for i, rho in enumerate(rhos + rhos[:1]):
        solver.set_options(F64_OPTS.replace(rho=rho, max_iter=20))
        solver.Solve(*(log[0][k] for k in KEYS))
        if i == 0:
            first = solver.GetSolution()
        assert len(solver._captures) == min(i + 1, MAX_CAPTURES)
    assert [k[0].rho for k in solver._captures] == rhos[3:] + rhos[:1]
    again = solver.GetSolution()
    assert np.array_equal(again.z, first.z)
    assert again.details.n_iter == first.details.n_iter
