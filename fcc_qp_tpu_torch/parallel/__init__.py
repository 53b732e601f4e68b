"""Batch-parallel solving over several devices (port of
`fcc_qp_tpu/parallel`): the mesh helpers, the sharded solves and their
cross-shard summary."""

from fcc_qp_tpu_torch.parallel.mesh import (
    BATCH_AXIS,
    batch_sharding,
    init_distributed,
    make_mesh,
    pad_batch,
    replicated,
    shard_batch_tree,
)
from fcc_qp_tpu_torch.parallel.sharded import (
    BatchSummary,
    local_rows,
    replay_sharded,
    shard_batch_last_tree,
    solve_batched_ds_sharded,
    solve_batched_sharded,
    summarize,
)

__all__ = [
    "BATCH_AXIS",
    "BatchSummary",
    "batch_sharding",
    "init_distributed",
    "local_rows",
    "make_mesh",
    "pad_batch",
    "replay_sharded",
    "replicated",
    "shard_batch_last_tree",
    "shard_batch_tree",
    "solve_batched_ds_sharded",
    "solve_batched_sharded",
    "summarize",
]
