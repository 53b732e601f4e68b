"""The read-free (static) forms of the full-layout engines on the CPU: the
form `core.graphs.CapturedBatch` captures as CUDA graphs for the
full-splitting engine (`solve_batched_ds` at the package defaults),
`solve_batched_fast` and the parity engine's `solve_batched` and
`replay` on the card. The CPU has no graphs: every branch of the static
form runs its select form (`ops.device_branch.branch`).

(a) The static form, through `CapturedBatch` (graphs off), equals the
    eager entry point bit for bit (z, every diagnostic but the two times,
    and the warm state) on a Cassie batch of 8, cold and warm-chained
    over three steps of a walking log: the full and batch-level engines
    at options where rho adapts at least twice (the rebuild body runs)
    and where it never changes (the rebuild body is skipped at every due
    check), the parity engine on f64 and f32 data and as a replay.
(b) Each of those static solves runs under a dispatch mode that raises
    on every host read, with the kernels' plain versions exempt.
(c) The slice as a whole against the JAX package: the static full engine
    gives `fcc_qp_tpu`'s statuses and n_iter on the full-engine test's
    batch at its ``adaptive`` options, |dz| < 1e-4 (the same JAX program
    as `test_torch_full_engine.py::test_full_engine_matches_jax[adaptive]`).
(d) The presolves after their move to batched triangular solves:
    `kkt_solve_refined_ds` and the parity `kkt_solve`, eager and static,
    and the parity operator on the rank-deficient batch (every instance
    takes a shift and the refinement branch), against the JAX package at
    `tests/test_torch_kkt.py`'s bars.
"""

import dataclasses

import numpy as np
import pytest
import torch

import fcc_qp_tpu_torch as T
from fcc_qp_tpu.core.ds_engine import solve_batched_ds as jsolve
from fcc_qp_tpu.core.ds_engine import to_ds_batch as jto
from fcc_qp_tpu import FCCQPOptions as JOpts
from fcc_qp_tpu import ProblemShape as JShape
from fcc_qp_tpu_torch.core.batched import Given, fast_stages
from fcc_qp_tpu_torch.core.ds_engine import full_stages
from fcc_qp_tpu_torch.core.graphs import CapturedBatch
from fcc_qp_tpu_torch.core.solver import parity_stages
from fcc_qp_tpu_torch.models.osc import CASSIE, generate_osc_sequence
from fcc_qp_tpu_torch.ops import kkt as tkkt
from fcc_qp_tpu_torch.ops import pallas_admm
from fcc_qp_tpu_torch.ops.device_branch import _leaves
from fcc_qp_tpu_torch.ops.ds_linalg import kkt_solve_refined_ds
from fcc_qp_tpu_torch.utils.io import stack_qp_dicts, to_qpbatch
from test_torch_full_engine import CASSIE_SHAPE, OPTS, _full_bars, cassie8
from test_torch_graph_path import _PLAIN, _NoHostReads
from test_torch_kkt import RHO, _batch, _jax_operator, _rel

torch.set_num_threads(1)

B, STEPS = 8, 3
# the full-engine test's options (exact presolve), adapting every 25
# iterations: rho changes at three or four of the due checks on these
# batches
ADAPT = dict(OPTS, max_iter=2000, adaptive_rho=True)
# `chip_smoke.FAST_ALPHA_OPTS`: over-relaxation, and two rebuilds
ALPHA = dict(ADAPT, alpha=1.6, rho=0.1, adaptive_rho_interval=50)
# checks fall due, but no residual ratio reaches the tolerance
NO_CHANGE = dict(ADAPT, adaptive_rho_tolerance=1e9)
# the parity engine at the JAX sharding tests' options, and on f32 data
# at the f32 engine's rho with the operator presolve (every instance
# converges there)
PARITY = dict(max_iter=300, rho=1.0, eps_fcone=1e-4, eps_bound=1e-4)
PARITY32 = dict(PARITY, max_iter=600, rho=0.05, presolve="operator")
TIMES = ("solve_time", "factorization_time")


@pytest.fixture(scope="module")
def steps():
    """Eight streams of a walking log, three steps each: element t is
    the stacked (batch-leading) dict of every stream's step t."""
    log = generate_osc_sequence(CASSIE, B * STEPS, seed=1)
    return [stack_qp_dicts([log[s * STEPS + t] for s in range(B)])
            for t in range(STEPS)]


def _ds(st):
    return T.to_ds_batch(st, device="cpu")


def _lead(dtype):
    return lambda st: to_qpbatch(st, dtype=dtype, device="cpu")


# engine -> (stage pair, batch conversion, eager solve of one step)
def _engine(kind, opts):
    o = T.FCCQPOptions(**opts)
    shape = CASSIE.shape
    if kind == "full":
        return (full_stages(shape, o), _ds,
                lambda qp, w, ws, st: T.solve_batched_ds(
                    qp, shape, o, warm=w, warm_start=ws, device="cpu",
                    stage_times=st))
    if kind == "fast":
        lead = _lead(torch.float64)
        return (fast_stages(shape, o),
                lambda st: Given(lead(st), torch.full(
                    (B,), o.rho, dtype=torch.float64), None),
                lambda g, w, ws, st: T.solve_batched_fast(
                    g.qp, shape, o, warm=w, warm_start=ws, device="cpu",
                    stage_times=st))
    dt = torch.float32 if kind == "parity32" else torch.float64
    return (parity_stages(shape, o, dt), _lead(dt),
            lambda qp, w, ws, st: T.solve_batched(
                qp, shape, o, warm=w, warm_start=ws, device="cpu"))


CASES = {
    # (engine, options, steps, rebuilds of the first solve: "some" >= 2,
    # 0, or None where the engine does not adapt)
    "full_cold_rebuilds": ("full", ADAPT, 1, "some"),
    "full_warm_chain": ("full", ADAPT, STEPS, "some"),
    "full_no_rebuild": ("full", NO_CHANGE, 1, 0),
    "fast_cold_rebuilds": ("fast", ALPHA, 1, "some"),
    "fast_warm_chain": ("fast", ADAPT, STEPS, "some"),
    "fast_no_rebuild": ("fast", NO_CHANGE, 1, 0),
    "parity_f64_chain": ("parity", PARITY, STEPS, None),
    "parity_f32": ("parity32", PARITY32, 1, None),
}


def _same(tag, got, want):
    for f in dataclasses.fields(want.details):
        if f.name not in TIMES:
            assert torch.equal(getattr(got.details, f.name),
                               getattr(want.details, f.name)), (tag, f.name)
    assert torch.equal(got.z, want.z), tag


def _same_warm(tag, got, want):
    for a, b in zip(_leaves(got, []), _leaves(want, []), strict=True):
        assert torch.equal(a, b), tag


def _no_reads(monkeypatch):
    mode = _NoHostReads()
    for name in _PLAIN:
        monkeypatch.setattr(pallas_admm, name,
                            mode.exempt(getattr(pallas_admm, name)))
    return mode


@pytest.mark.parametrize("case", list(CASES))
def test_static_equals_eager(case, steps, monkeypatch):
    """(a) and (b): the static chain under the no-read mode, bit for bit
    the eager entry point's."""
    kind, opts, n_steps, rebuilds = CASES[case]
    stages, conv, eager_solve = _engine(kind, opts)
    qps = [conv(st) for st in steps[:n_steps]]
    eager, warm, counts = [], None, []
    for t, qp in enumerate(qps):
        stage_times = {}
        sol, warm = eager_solve(qp, warm, t > 0, stage_times)
        eager.append((sol, warm))
        counts.append(stage_times.get("n_refactor"))
    if rebuilds == "some":
        assert counts[0] >= 2, counts
    elif rebuilds == 0:
        assert counts == [0] * n_steps
    cap = CapturedBatch(stages, B, "cpu")
    static = []
    with _no_reads(monkeypatch):
        for t, qp in enumerate(qps):
            cap.load(qp)
            cap.run(t > 0)
            static.append(cap.result())
    for t, ((s_e, w_e), (s_s, w_s)) in enumerate(zip(eager, static)):
        _same(f"{case} step {t}", s_s, s_e)
        _same_warm(f"{case} step {t}", w_s, w_e)
    assert (eager[-1][0].details.solve_status == 0).any()


def test_static_parity_replay(steps, monkeypatch):
    """(a) and (b) for `replay`: the static warm chain over the log (the
    captured replay's form: the cold stage pair at step 0, the warm one
    after) equals the eager `replay` over the same steps."""
    opts = T.FCCQPOptions(**PARITY)
    log = T.QPBatch(*(torch.stack([getattr(to_qpbatch(st, device="cpu"), f)
                                   for st in steps])
                      for f in ("Q", "b", "A_eq", "b_eq", "friction_coeffs",
                                "lb", "ub")))
    eager, final = T.replay(log, CASSIE.shape, opts, device="cpu")
    cap = CapturedBatch(parity_stages(CASSIE.shape, opts), B, "cpu")
    with _no_reads(monkeypatch):
        for t in range(STEPS):
            cap.load(T.QPBatch(*(a[t] for a in dataclasses.astuple(log))))
            cap.run(t > 0)
            sol, warm = cap.result()
            for f in dataclasses.fields(sol.details):
                assert torch.equal(getattr(sol.details, f.name),
                                   getattr(eager.details, f.name)[t]), f.name
            assert torch.equal(sol.z, eager.z[t])
    _same_warm("replay", warm, final)


def test_static_full_engine_matches_jax(cassie8):
    """(c) the static full engine against `fcc_qp_tpu`'s
    `solve_batched_ds`."""
    jsol, _ = jsolve(jto(cassie8), JShape(*CASSIE_SHAPE), JOpts(**ADAPT))
    cap = CapturedBatch(full_stages(T.ProblemShape(*CASSIE_SHAPE),
                                    T.FCCQPOptions(**ADAPT)), 8, "cpu")
    cap.load(T.to_ds_batch(cassie8, device="cpu"))
    cap.run(False)
    tsol, _ = cap.result()
    _full_bars(jsol, tsol)
    assert (tsol.details.solve_status == 0).all()


def _last(a):
    return np.ascontiguousarray(np.moveaxis(a, 0, -1))


@pytest.mark.parametrize("static", [False, True], ids=["eager", "static"])
def test_refined_presolve_matches_jax(static):
    """(d) `kkt_solve_refined_ds` against the JAX package's (double-single
    there), at `test_torch_kkt.py`'s bar."""
    import jax

    from fcc_qp_tpu.core.ds_engine import _split64
    from fcc_qp_tpu.ops import ds
    from fcc_qp_tpu.ops.ds_linalg import kkt_solve_refined_ds as jrefined

    st = _batch("cassie")
    js = jax.jit(jrefined)(
        _split64(_last(st["Q"])), _split64(_last(st["A_eq"])),
        _split64(_last(-st["b"])), _split64(_last(st["b_eq"])))
    tx = kkt_solve_refined_ds(
        *(torch.from_numpy(_last(a))
          for a in (st["Q"], st["A_eq"], -st["b"], st["b_eq"])),
        static=static)
    assert _rel(tx.numpy(), np.asarray(ds.to_f64(js))) < 1e-9


@pytest.mark.parametrize("static", [False, True], ids=["eager", "static"])
@pytest.mark.parametrize("name", ["cassie", "random"])
def test_parity_presolve_matches_jax(name, static):
    """(d) the parity engine's presolve (``rho = 0``) against the JAX
    package's, at `test_torch_kkt.py`'s bars."""
    import jax
    import jax.numpy as jnp

    from fcc_qp_tpu.ops import kkt as jkkt

    st = _batch(name)
    x = np.asarray(jax.jit(jax.vmap(
        lambda q, a, r, s: jkkt.kkt_solve(q, a, jnp.zeros(()), r, s)
    ))(st["Q"], st["A_eq"], -st["b"], st["b_eq"]))
    t = {k: torch.from_numpy(v) for k, v in st.items()}
    tx = tkkt.kkt_solve(t["Q"], t["A_eq"], 0.0, -t["b"], t["b_eq"],
                        static=static)
    assert _rel(tx.numpy(), x) < (1e-7 if name == "cassie" else 1e-10)
    eq = np.einsum("bmn,bn->bm", st["A_eq"], tx.numpy()) - st["b_eq"]
    assert np.abs(eq).max() < 1e-8 * (1 + np.abs(st["b_eq"]).max())


@pytest.mark.parametrize("static", [False, True], ids=["eager", "static"])
def test_parity_operator_rank_deficient(static):
    """(d) the parity operator where every instance takes a shift (and so
    the shift levels and the refinement run as branches): F to 1e-8 of
    the JAX package's, x_const to 2e-6 (`test_torch_kkt.py`'s bars)."""
    st = _batch("rank_deficient")
    F, _, xc = (np.asarray(a) for a in _jax_operator(
        st["Q"], st["b"], st["A_eq"], st["b_eq"]))
    t = {k: torch.from_numpy(v) for k, v in st.items()}
    tF, _ = tkkt.kkt_factor_blocks(t["Q"], t["A_eq"], RHO, static=static)
    _, txc = tkkt.admm_operator(t["Q"], t["b"], t["A_eq"], t["b_eq"], RHO,
                                static=static)
    assert _rel(tF.numpy(), F) < 1e-8
    assert _rel(txc.numpy(), xc) < 2e-6
