"""What decides ``correct``, at sizes a test run holds: the control (the
reference in f32, put in the program's place) comes out not correct in
every cell, and a run whose timed path is broken underneath reads
``correct`` false for each fault the cell can have. The harness's look
for a card is skipped (``run_cell`` on the CPU); the rest of a run is
driven as on the card."""

import dataclasses
import os
import time

import pytest
import torch

import fcc_qp_tpu_torch
from fcc_qp_tpu_torch.core import api
from qpbench import check, gen, run, spec

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
CELLS = ["cassie-replay", "humanoid-cold", "cassie-loop-ds", "cassie-cold"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    cell = spec.cell(REPO, workload)
    d = gen.dims(cell.config["model"])
    log = gen.walking_log(cell.config["model"], cell.config["generator"],
                          400, gen.generator(2**33 + 41, "cpu"), "cpu")
    qp = {k: v[::25] for k, v in log.items()}
    read = check.readings(qp, None, d["ls"], d["nc"],
                          candidate=check.control_answers(d["ls"], d["nc"]))
    ok, compared = check.verdict(read)
    assert not ok, compared
    # and the reference itself, in the program's place, is correct
    ref = check.readings(qp, None, d["ls"], d["nc"],
                         candidate=lambda q: __import__(
                             "qpbench.reference", fromlist=["solve"]).solve(
                             q, d["ls"], d["nc"]).z)
    assert check.verdict(ref)[0], ref


def _with_z(sol, z):
    return dataclasses.replace(sol, z=z)


def _unchanged_batch(z, S=None):
    """Each answer is the state the step started from: the previous
    step's answer in a replay stream, the zero cold start otherwise."""
    if S is None:
        return torch.zeros_like(z)
    zz = z.view(S, -1, z.shape[-1])
    out = torch.zeros_like(zz)
    out[:, 1:] = zz[:, :-1]
    return out.reshape(z.shape)


def _half(z, S=None):
    """The second half of the batch (of the streams) left out."""
    if S is None:
        out = z.clone()
        out[z.shape[0] // 2:] = 0.0
        return out
    zz = z.view(S, -1, z.shape[-1]).clone()
    zz[S // 2:] = 0.0
    return zz.reshape(z.shape)


def _altered(z, S=None):
    """Every answer altered where it is produced."""
    out = z.clone()
    out[:, 0] += 1e-3 * (1.0 + z.abs().amax(1))
    return out


FAULTS = {"unchanged": _unchanged_batch, "half": _half,
          "altered": _altered}
CASES = ([("cassie-replay", f) for f in FAULTS]
         + [("humanoid-cold", f) for f in FAULTS]
         + [("cassie-cold", f) for f in FAULTS]
         + [("cassie-loop-ds", "unchanged"), ("cassie-loop-ds", "altered")])


def _break(monkeypatch, workload, fault):
    f = FAULTS[fault]
    if workload.endswith("replay"):
        orig = fcc_qp_tpu_torch.replay_ds_streams

        def replay(qps, shape, opts, n_streams=1024, **kw):
            sols, ws = orig(qps, shape, opts, n_streams=n_streams, **kw)
            return _with_z(sols, f(sols.z, n_streams)), ws

        monkeypatch.setattr(fcc_qp_tpu_torch, "replay_ds_streams", replay)
    elif workload.endswith("cold"):
        orig = fcc_qp_tpu_torch.solve_batched_ds

        def solve(*a, **kw):
            sol, ws = orig(*a, **kw)
            return _with_z(sol, f(sol.z)), ws

        monkeypatch.setattr(fcc_qp_tpu_torch, "solve_batched_ds", solve)
    else:
        orig = api.FCCQP.GetSolution
        last = {}

        def get(self):
            sol = orig(self)
            z = torch.from_numpy(sol.z)[None]
            if fault == "unchanged":
                new = last.get("z", torch.zeros_like(z))
                last["z"] = z
            else:
                new = f(z)
            return _with_z(sol, new[0].numpy())

        monkeypatch.setattr(api.FCCQP, "GetSolution", get)


@pytest.mark.parametrize("workload,fault", CASES)
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch,
                                            workload, fault):
    _break(monkeypatch, workload, fault)
    out = run.run_cell(workload, 2**33 + 43, 0.5, False, "cpu",
                       time.time(), root=tiny_root,
                       bench_dir=os.path.join(tiny_root, "qpbench"))
    assert out["correct"] is False, out["checks"]
