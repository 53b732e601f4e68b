"""Worker of the two-process `torch.distributed` test of the port
(`tests/test_torch_sharding.py`):

    python tests/torch_distributed_worker.py <rank> <world> <port>

Each process joins a gloo group at ``tcp://localhost:<port>``, builds the
same QP batch, solves it with `parallel.solve_batched_ds_sharded` over
its own CPU (the batch split over the ranks), and holds the instances it
solved (`parallel.local_rows`) against a single-process solve of the
whole batch; the summary, reduced over both ranks, must count every
instance."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

rank, world, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

import fcc_qp_tpu_torch as T  # noqa: E402
from fcc_qp_tpu_torch.models.osc import QUADRUPED, generate_osc_batch  # noqa: E402
from fcc_qp_tpu_torch.parallel import (  # noqa: E402
    init_distributed,
    local_rows,
    solve_batched_ds_sharded,
    summarize,
)
from fcc_qp_tpu_torch.utils.io import stack_qp_dicts  # noqa: E402

joined = init_distributed(backend="gloo",
                          init_method=f"tcp://localhost:{port}",
                          world_size=world, rank=rank)
assert joined

B = 7   # not a multiple of the world size: the last rank's shard is padded
qp = T.to_ds_batch(stack_qp_dicts(generate_osc_batch(QUADRUPED, B, seed=7)),
                   device="cpu")
opts = T.FCCQPOptions(max_iter=300, rho=1.0, eps_fcone=1e-4, eps_bound=1e-4)
ref, _ = T.solve_batched_ds(qp, QUADRUPED.shape, opts, device="cpu")
ref_sum = summarize(ref)   # summed over both ranks' (identical) batches

sol, ws, summary = solve_batched_ds_sharded(qp, QUADRUPED.shape, opts,
                                            mesh=["cpu"])
rows = local_rows(B, ["cpu"])
assert len(rows) == sol.z.shape[0] == ws.x.shape[-1], (rows, sol.z.shape)
assert np.abs(sol.z.numpy() - ref.z.numpy()[rows.start:rows.stop]).max() <= 1e-8
assert torch.equal(sol.details.n_iter, ref.details.n_iter[rows.start:rows.stop])
assert int(summary.n_instances) == B, int(summary.n_instances)
assert int(summary.n_solved) == int(ref_sum.n_solved) // world
assert float(summary.max_residual_bounds) == float(
    ref.details.admm_residual_bounds.max())
torch.distributed.destroy_process_group()
print(f"OK rank {rank}: {len(rows)} instances, rows {rows.start}-{rows.stop}")
