"""The roofline arithmetic on hand-counted batches, and the check that
the counters it reads (`n_iter_f32`, `n_iter_ds`, `n_iter`) are the
iterations the ADMM chunk kernels run (their plain versions, which run
on the CPU and keep the kernels' counters)."""

import json
import os

import numpy as np
import pytest
import torch

from qpbench import drivers, gen, roofline, spec

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def test_flops_per_iteration_by_hand():
    # k = 2 rows, no cone: the 2x2 mat-vec (8) and 16 flops a row (32)
    assert roofline.flops_per_iteration(2, 0) == 40
    # Cassie's reduced layout: k = 22, 4 cones
    assert roofline.flops_per_iteration(22, 4) == 968 + 352 + 48


def test_reduced_bytes_by_hand():
    # k = 3 (one cone), kb = 0, f32: data (9 + 6 + 0 + 1 + 1) * 4 = 68,
    # state (12 + 4) * 4 + 12 = 76, in and out
    assert roofline.reduced_bytes(3, 0, 1, "f32") == 68 + 2 * 76
    # f64 doubles the words, not the three int32 counters
    assert roofline.reduced_bytes(3, 0, 1, "f64") == 136 + 2 * 140


def test_full_bytes_by_hand():
    # n = 3, nc = 3: data (9 + 9 + 1 + 1) * 8 = 160, state (12 + 6 + 4)
    # * 8 + 12 = 188, in and out
    assert roofline.full_bytes(3, 3, "f64") == 160 + 2 * 188


def test_reduced_work_counts_only_what_ran():
    # two instances: one ran 5 f32 iterations and none in f64, the
    # other 3 and 2
    w = roofline.reduced_work(3, 0, 1, [5, 3], [0, 2])
    f = roofline.flops_per_iteration(3, 1)
    assert w[0] == dict(prec="f32", flops=8 * f,
                        bytes=2 * roofline.reduced_bytes(3, 0, 1, "f32"))
    assert w[1] == dict(prec="f64", flops=2 * f,
                        bytes=roofline.reduced_bytes(3, 0, 1, "f64"))
    assert roofline.reduced_work(3, 0, 1, [0], [0])[0]["bytes"] == 0


def test_least_time_is_the_larger_bound():
    ops = roofline.least_seconds([dict(prec="f64", flops=34e12, bytes=0)])
    assert ops["seconds"] == pytest.approx(1.0)
    assert ops["bound_by"] == "operations"
    mem = roofline.least_seconds([dict(prec="f32", flops=67e12,
                                       bytes=2 * 3.35e12)])
    assert mem["seconds"] == pytest.approx(2.0)
    assert mem["bound_by"] == "bytes"
    # f32 and f64 units run side by side: the larger of the two
    both = roofline.least_seconds([dict(prec="f32", flops=67e12, bytes=0),
                                   dict(prec="f64", flops=68e12, bytes=0)])
    assert both["seconds"] == pytest.approx(2.0)


class _Counting:
    """Wraps the plain chunk versions and sums each instance's
    iterations (its ``itv`` after the chunk less before) by kernel."""

    NAMES = {"admm_chunk_f32_plain": "f32", "admm_chunk_f64_plain": "f64",
             "admm_chunk_full_f64_plain": "full_f64"}

    def __init__(self, monkeypatch):
        from fcc_qp_tpu_torch.ops import pallas_admm

        self.iters = {v: 0 for v in self.NAMES.values()}
        for name, key in self.NAMES.items():
            orig = getattr(pallas_admm, name)

            def wrapped(*args, _orig=orig, _key=key, **kw):
                # the iteration counter is the argument after n_iter
                out = _orig(*args, **kw)
                itv_in = args[16] if _key == "full_f64" else args[14]
                itv_out = out[8] if _key == "full_f64" else out[6]
                self.iters[_key] += int((itv_out - itv_in).sum())
                return out

            monkeypatch.setattr(pallas_admm, name, wrapped)


def _cell(name):
    return spec.cell(REPO, name)


def _tiny(cell, **kw):
    cell.traffic = {**cell.traffic, **kw}
    return cell


def test_reduced_counters_are_the_kernels_iterations(monkeypatch):
    count = _Counting(monkeypatch)
    cell = _tiny(_cell("cassie-cold"), batch=12, batches=1)
    drv = spec.driver("cold")(cell, torch.device("cpu"), 2**33 + 9)
    drv.setup()
    count.iters = {k: 0 for k in count.iters}
    sol, _ = drv.call(drv.batches[0])
    d = sol.details
    assert int(d.n_iter_f32.sum()) == count.iters["f32"]
    assert int(d.n_iter_ds.sum()) == count.iters["f64"]
    assert count.iters["f32"] > 0
    # ... and on the warm steps of a replay
    cell = _tiny(_cell("cassie-replay"), streams=3, steps=3, log_sets=1)
    drv = spec.driver("replay")(cell, torch.device("cpu"), 2**33 + 10)
    drv.setup()
    count.iters = {k: 0 for k in count.iters}
    sols, _ = drv.call(drv.logs[0])
    d = sols.details
    assert int(d.n_iter_f32.sum()) == count.iters["f32"]
    assert int(d.n_iter_ds.sum()) == count.iters["f64"]


def test_drop_in_ds_counters_are_the_kernels_iterations(monkeypatch):
    count = _Counting(monkeypatch)
    cell = _tiny(_cell("cassie-loop-ds"), steps=4, warmup_steps=0)
    drv = spec.driver("loop")(cell, torch.device("cpu"), 2**33 + 12)
    drv.setup()
    f32 = f64 = 0
    for _ in range(3):
        _, _, r = drv.step()
        f32 += r.details.n_iter_f32
        f64 += r.details.n_iter_ds
    assert (f32, f64) == (count.iters["f32"], count.iters["f64"])
    assert count.iters["full_f64"] == 0


def test_full_layout_counter_is_the_kernels_iterations(monkeypatch):
    """The drop-in's f64 engine (the reference's algorithm in the full
    layout) at the walking-log example's options."""
    count = _Counting(monkeypatch)
    cell = _tiny(_cell("cassie-loop-ds"), steps=4, warmup_steps=0,
                 engine="f64", options=dict(rho=0.3, eps_fcone=1e-6,
                                            eps_bound=1e-6, max_iter=3000))
    drv = spec.driver("loop")(cell, torch.device("cpu"), 2**33 + 11)
    drv.setup()
    its = []
    for _ in range(3):
        _, _, r = drv.step()
        assert r.details.n_iter < drv.opts.max_iter
        its.append(roofline.full_iterations(r.details.n_iter,
                                            drv.opts.max_iter))
    # the reported n_iter is one short of the iterations run
    assert sum(its) == count.iters["full_f64"] > 0
    assert count.iters["f32"] == count.iters["f64"] == 0


def test_bounded_rows_give_the_kernels_k():
    for name, k in (("cassie", 22), ("humanoid", 47)):
        with open(os.path.join(HERE, "configs", name + ".json")) as f:
            c = json.load(f)
        log = gen.walking_log(c["model"], c["generator"], 8,
                              gen.generator(1, "cpu"), "cpu")
        assert drivers.bounded_rows(log) + c["model"]["nc"] == k
        assert c["constrained_k"] == k
