"""The read-free (static) reduced solve above the gather capacity, the form
`core.graphs.CapturedBatch` captures as CUDA graphs for
`solve_batched_ds` and `replay_ds_streams` on the card, on the CPU.

The capacity floor (`ops.ds_linalg.CAPACITY_FLOOR`, 128) is lowered to 4,
so that a Cassie batch of 12 needs three passes in every capacity-gathered
loop (the polish seed rebuild, the KKT-seed rescue, the lazy exact
build; the polish continuation's bound is 12 passes) and the
continuation's full-batch step is a branch:

(a) the static solve, through `CapturedBatch` (graphs off: the CPU has
    none), equals the eager one bit for bit on a cold solve and two
    warm-chained replay steps with the operator cache (statuses, n_iter,
    z, every diagnostic, the warm state and the cache); in a warm step
    from zero carried seeds and in a cold solve whose polish accepts
    nothing, the eager loops take every pass of the static bound; no
    static loop ends with work pending;
(b) the static solves run under a dispatch mode that raises on every
    host read, with the kernels' plain versions exempt;
(c) (`tests/test_torch_graph_path.py`) the B <= 128 cases keep passing.
"""

import dataclasses

import pytest
import torch

from fcc_qp_tpu_torch.core import ds_engine
from fcc_qp_tpu_torch.core.ds_engine import (
    OperatorCache,
    _solve_ds_reduced,
    constrained_indices,
    to_ds_batch,
)
from fcc_qp_tpu_torch.core.graphs import CapturedBatch
from fcc_qp_tpu_torch.models.osc import CASSIE, generate_osc_sequence
from fcc_qp_tpu_torch.ops import device_branch, ds_linalg, pallas_admm, polish
from fcc_qp_tpu_torch.utils.io import stack_qp_dicts
from test_torch_graph_path import _PLAIN, _NoHostReads
from test_torch_serving import DS_OPTS

torch.set_num_threads(1)

B, STEPS, FLOOR = 12, 3, 4


@pytest.fixture(scope="module")
def steps():
    """Twelve streams of a walking log, three steps each: element t is
    the batch of every stream's step t (batch-last, on the CPU)."""
    log = generate_osc_sequence(CASSIE, B * STEPS, seed=1)
    return [to_ds_batch(stack_qp_dicts([log[s * STEPS + t]
                                        for s in range(B)]), device="cpu")
            for t in range(STEPS)]


@pytest.fixture
def loops(monkeypatch):
    """Lower the capacity floor and count the passes of every gathered
    loop: a list of ``(loop, static, bound, passes run)``."""
    monkeypatch.setattr(ds_linalg, "CAPACITY_FLOOR", FLOOR)
    record, real = [], device_branch.gathered_loop

    def counted_loop(static, n, pending, step, *carry):
        taken = [0]

        def counted(*c):
            taken[0] += 1
            return step(*c)

        out = real(static, n, pending, counted, *carry)
        record.append((step.__name__, static, n, taken[0]))
        return out

    monkeypatch.setattr(ds_engine, "gathered_loop", counted_loop)
    monkeypatch.setattr(polish, "gathered_loop", counted_loop)
    device_branch.exhausted_flag("cpu").fill_(False)
    return record


def _eager_chain(qps, opts, con_idx, cache0=None):
    """The eager solves of ``qps`` warm-chained with the operator cache:
    step 0 cold (or warm from ``cache0 = (warm, cache)``)."""
    out, ws, cache = [], None, OperatorCache()
    if cache0 is not None:
        ws, cache = cache0
    for qp in qps:
        sol, ws, cache = _solve_ds_reduced(
            qp, ws, CASSIE.shape, opts, ws is not None, con_idx,
            cache=cache, with_cache=True)
        out.append((sol, ws, cache))
    return out


def _static_chain(qps, opts, con_idx, cache0=None):
    """The same through `CapturedBatch` with graphs off (the static
    solve `solve_batched_ds` and `replay_ds_streams` capture)."""
    cap = CapturedBatch(CASSIE.shape, opts, con_idx, B, "cpu",
                        with_cache=True)
    warm_start = cache0 is not None
    if warm_start:
        cap.load_warm(cache0[0])
        cap.cache = cache0[1]
    out = []
    for qp in qps:
        cap.load(qp)
        cap.run(warm_start)
        warm_start = True
        out.append(cap.result())
    return out


def _tensors(x):
    return device_branch._leaves(x, [])


def _check_equal(eager, static):
    for t, ((s_e, w_e, c_e), (s_s, w_s, c_s)) in enumerate(zip(eager,
                                                               static)):
        for f in dataclasses.fields(s_e.details):
            assert torch.equal(getattr(s_e.details, f.name),
                               getattr(s_s.details, f.name)), (t, f.name)
        assert torch.equal(s_e.z, s_s.z), t
        for a, b in zip(_tensors((w_e, c_e)), _tensors((w_s, c_s))):
            assert torch.equal(a, b), t


def _no_reads(monkeypatch):
    mode = _NoHostReads()
    for name in _PLAIN:
        monkeypatch.setattr(pallas_admm, name,
                            mode.exempt(getattr(pallas_admm, name)))
    return mode


def _passes(record, static):
    """``{loop: (bound, most passes run)}`` over the solves recorded."""
    out = {}
    for name, st, n, taken in record:
        if st == static:
            b, t = out.get(name, (0, 0))
            out[name] = (max(b, n), max(t, taken))
    return out


def test_static_equals_eager_above_the_capacity(steps, loops, monkeypatch):
    """(a), (b): a cold solve and two warm steps with the cache."""
    con_idx = constrained_indices(steps[0], CASSIE.shape)
    eager = _eager_chain(steps, DS_OPTS, con_idx)
    with _no_reads(monkeypatch):
        static = _static_chain(steps, DS_OPTS, con_idx)
    _check_equal(eager, static)
    assert not bool(device_branch.exhausted_flag("cpu"))
    # every eager loop stayed within the static bound, which has three or
    # more passes in every loop
    for name, (bound, taken) in _passes(loops, False).items():
        assert taken <= bound, name
    static_loops = _passes(loops, True)
    assert {"rebuild", "exact_pass", "gathered_step"} <= set(static_loops)
    assert all(bound >= 3 for bound, _ in static_loops.values())
    assert (eager[-1][0].details.solve_status == 0).any()


def test_every_pass_from_zero_seeds(steps, loops, monkeypatch):
    """A warm step whose carried KKT and polish seeds are zero: every
    instance needs a cold KKT seed and a cold polish seed, and the eager
    rescue and rebuild loops take every pass of the static bound."""
    con_idx = constrained_indices(steps[0], CASSIE.shape)
    (_, w0, c0), = _eager_chain(steps[:1], DS_OPTS, con_idx)
    zero = lambda: OperatorCache(
        kkt_seed=torch.zeros_like(c0.kkt_seed),
        polish_seed=torch.zeros_like(c0.polish_seed),
        polish_cls=c0.polish_cls.clone(), scales=c0.scales)
    loops.clear()
    eager = _eager_chain(steps[1:2], DS_OPTS, con_idx, (w0, zero()))
    with _no_reads(monkeypatch):
        static = _static_chain(steps[1:2], DS_OPTS, con_idx, (w0, zero()))
    _check_equal(eager, static)
    assert not bool(device_branch.exhausted_flag("cpu"))
    taken = _passes(loops, False)
    for name in ("rescue", "rebuild"):
        assert taken[name][1] == taken[name][0] == 3, (name, taken[name])


def test_every_pass_of_the_exact_build(steps, loops, monkeypatch):
    """A cold solve, one polish round, at a tolerance the polish almost
    never meets: more than two passes' worth of instances take the lazy
    exact build, in every pass of its bound."""
    opts = DS_OPTS.replace(eps_bound=1e-12, eps_fcone=1e-12, polish_rounds=1)
    con_idx = constrained_indices(steps[0], CASSIE.shape)
    eager = _eager_chain(steps[:1], opts, con_idx)
    with _no_reads(monkeypatch):
        static = _static_chain(steps[:1], opts, con_idx)
    _check_equal(eager, static)
    assert not bool(device_branch.exhausted_flag("cpu"))
    assert int((eager[0][0].details.polish_accepted == 0).sum()) > 2 * FLOOR
    bound, taken = _passes(loops, False)["exact_pass"]
    assert taken == bound == 3


def test_the_flag_records_a_bound_too_small():
    """A static loop cut below what its work needs sets the flag; the
    eager loop runs to the end."""
    flag = device_branch.exhausted_flag("cpu")
    flag.fill_(False)

    def step(rem):
        rem = rem.clone()
        rem[torch.argmax(rem.int())] = False
        return (rem,)

    rem = torch.ones(5, dtype=torch.bool)
    (left,) = device_branch.gathered_loop(True, 3, lambda r: r, step, rem)
    assert int(left.sum()) == 2 and bool(flag)
    flag.fill_(False)
    (left,) = device_branch.gathered_loop(True, 5, lambda r: r, step, rem)
    assert not left.any() and not bool(flag)
    (left,) = device_branch.gathered_loop(False, 0, lambda r: r, step, rem)
    assert not left.any()
