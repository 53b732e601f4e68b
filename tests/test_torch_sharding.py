"""The port's batch split over devices (`fcc_qp_tpu_torch.parallel`), on
the CPU: shards on ``devices=["cpu"] * k`` equal the unsharded solve
(the bars of the JAX package's `tests/test_sharding.py`: n_iter equal,
|dz| <= 1e-10 on the f64 engine, 1e-8 on the ds engine), uneven batches
are padded and stripped, the summary aggregates what it says, and two
processes joined by `torch.distributed` (gloo) split one batch."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import fcc_qp_tpu_torch as T
from fcc_qp_tpu_torch.models.osc import (CASSIE, QUADRUPED,
                                         generate_osc_batch,
                                         generate_osc_sequence)
from fcc_qp_tpu_torch.parallel import (batch_sharding, make_mesh, pad_batch,
                                       replay_sharded, replicated,
                                       shard_batch_last_tree,
                                       shard_batch_tree,
                                       solve_batched_ds_sharded,
                                       solve_batched_sharded)
from fcc_qp_tpu_torch.utils.io import stack_qp_dicts, to_qpbatch

torch.set_num_threads(1)

OPTS = T.FCCQPOptions(max_iter=300, rho=1.0, eps_fcone=1e-4, eps_bound=1e-4)
CPU8 = ["cpu"] * 8


def _batch(model, B, seed):
    return to_qpbatch(stack_qp_dicts(generate_osc_batch(model, B, seed=seed)),
                      device="cpu")


def test_sharded_equals_unsharded():
    qp = _batch(CASSIE, 16, 0)
    ref, _ = T.solve_batched(qp, CASSIE.shape, OPTS, device="cpu")
    sol, ws, summary = solve_batched_sharded(qp, CASSIE.shape, OPTS,
                                             mesh=CPU8)
    assert np.abs(sol.z.numpy() - ref.z.numpy()).max() <= 1e-10
    assert torch.equal(sol.details.n_iter, ref.details.n_iter)
    assert ws.x.shape == (16, 60)
    assert int(summary.n_instances) == 16


def test_uneven_batch_padding():
    qp = _batch(QUADRUPED, 11, 2)
    ref, _ = T.solve_batched(qp, QUADRUPED.shape, OPTS, device="cpu")
    sol, _, summary = solve_batched_sharded(qp, QUADRUPED.shape, OPTS,
                                            mesh=CPU8)
    assert sol.z.shape[0] == 11 and int(summary.n_instances) == 11
    assert np.abs(sol.z.numpy() - ref.z.numpy()).max() <= 1e-10


def test_summary_aggregates():
    qp = _batch(CASSIE, 8, 3)
    sol, _, s = solve_batched_sharded(qp, CASSIE.shape, OPTS, mesh=CPU8)
    d = sol.details
    assert int(s.n_instances) == 8
    assert int(s.n_solved) == int((d.solve_status == 0).sum())
    assert float(s.max_residual_bounds) == float(d.admm_residual_bounds.max())
    assert float(s.max_residual_fcone) == float(
        d.admm_residual_friction_cone.max())
    assert int(s.max_iterations) == int(d.n_iter.max())
    assert float(s.mean_iterations) == pytest.approx(
        float(d.n_iter.double().mean()), rel=1e-6)
    assert float(s.max_bounds_viol) == float(d.bounds_viol.max())
    assert float(s.max_fcone_viol) == float(d.friction_cone_viol.max())


def test_ds_sharded_uneven_batch():
    # B = 5 on 8 shards: padded, solved, stripped
    qp = T.to_ds_batch(stack_qp_dicts(generate_osc_sequence(QUADRUPED, 5,
                                                            seed=3)),
                       device="cpu")
    sol, ws, summary = solve_batched_ds_sharded(qp, QUADRUPED.shape, OPTS,
                                                mesh=CPU8)
    ref, _ = T.solve_batched_ds(qp, QUADRUPED.shape, OPTS, device="cpu")
    assert sol.z.shape[0] == 5 and ws.x.shape[-1] == 5
    assert int(summary.n_instances) == 5
    assert torch.equal(sol.details.n_iter, ref.details.n_iter)
    assert np.abs(sol.z.numpy() - ref.z.numpy()).max() <= 1e-8


def test_replay_sharded_scenarios():
    # 4 scenario sequences of 3 steps (B, T, ...), on 2 shards
    seqs = [stack_qp_dicts(generate_osc_sequence(QUADRUPED, 3, seed=10 + i))
            for i in range(4)]
    st = {k: np.stack([s[k] for s in seqs]) for k in seqs[0]}
    qps = to_qpbatch(st, device="cpu")
    sols, ws, summary = replay_sharded(qps, QUADRUPED.shape, OPTS,
                                       mesh=["cpu", "cpu"])
    assert tuple(sols.z.shape[:2]) == (4, 3)
    assert int(summary.n_instances) == 12
    one = to_qpbatch({k: v[2] for k, v in st.items()}, device="cpu")
    ref, _ = T.replay(one, QUADRUPED.shape, OPTS, device="cpu")
    assert np.abs(sols.z[2].numpy() - ref.z.numpy()).max() <= 1e-10


def test_pad_and_place_helpers():
    tree = {"a": torch.arange(10.0).reshape(5, 2)}
    padded, b = pad_batch(tree, 4)
    assert b == 5 and padded["a"].shape == (8, 2)
    assert torch.equal(padded["a"][5:], padded["a"][4:5].repeat(3, 1))
    last, b = pad_batch({"a": torch.arange(10.0).reshape(2, 5)}, 4, axis=-1)
    assert b == 5 and last["a"].shape == (2, 8)
    assert torch.equal(last["a"][:, 5:], last["a"][:, 4:5].repeat(1, 3))
    shards = shard_batch_tree(padded, ["cpu", "cpu"])
    assert [s["a"].shape for s in shards] == [(4, 2), (4, 2)]
    assert torch.equal(torch.cat([s["a"] for s in shards]), padded["a"])
    cols = shard_batch_last_tree(last, ["cpu", "cpu"])
    assert torch.equal(torch.cat([s["a"] for s in cols], dim=-1), last["a"])
    assert batch_sharding(["cpu"]).axis == 0
    both = replicated(["cpu", "cpu"]).place(tree)
    assert all(torch.equal(t["a"], tree["a"]) for t in both)
    with pytest.raises(ValueError):
        shard_batch_tree(tree, ["cpu", "cpu"])   # 5 rows on 2 shards
    assert make_mesh(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_gloo_split_matches_single_process():
    worker = os.path.join(os.path.dirname(__file__),
                          "torch_distributed_worker.py")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, worker, str(r), "2", str(port)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], "\n---\n".join(outs)
    assert all(f"OK rank {r}" in o for r, o in enumerate(outs)), outs
