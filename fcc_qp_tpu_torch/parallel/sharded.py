"""Batch-parallel solves over several devices, and their cross-shard
summary (port of `fcc_qp_tpu/parallel/sharded.py`).

The batch is padded to a multiple of the device count (the last instance
repeated), split into equal shards, each shard solved on its device, the
padding stripped and the shards gathered in batch order on the mesh's
first device. `BatchSummary` aggregates the stripped solution.

In one process the shards are solved one after another. On the card each
shard replays its engine's captured solve (`core.graphs.solve_captured`:
shards of the same size on the same device share one capture, and each
shard's result is copied out of the capture's buffers before the next
shard runs). Several processes (one per card, joined with
`mesh.init_distributed`) split the batch over ranks first: rank r solves
the global shards of its rank, `local_rows` says which instances those
are, and the summary's sums and maxima go through
`torch.distributed.all_reduce`, the port's form of the JAX package's
psum / pmax collectives.

Instances are independent on the f64 parity engine, so a sharded solve
equals the unsharded one. The ds engines share a few decisions across
their batch (the constrained coordinates, which the sharded entry points
take from the whole batch; the adaptive-rho rebuild count; the polish's
gathered retry capacity, a fraction of the batch), and their batched
matrix products round differently at different batch sizes, which the
reduced path's f32 seeds and approach phase can carry into an iteration
count: with adaptive rho, more polish rejections than a shard's
capacity, or on the reduced path, a shard can differ from the unsharded
solve by an iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from fcc_qp_tpu_torch.config import FCCQPOptions, ProblemShape
from fcc_qp_tpu_torch.core.ds_engine import (
    QPBatchDS,
    WarmStartDS,
    _reduced,
    constrained_indices,
    solve_batched_ds,
)
from fcc_qp_tpu_torch.core.solver import replay, solve_batched
from fcc_qp_tpu_torch.parallel.mesh import (
    BATCH_AXIS,
    Sharding,
    leaves,
    make_mesh,
    map_tree,
    pad_batch,
)
from fcc_qp_tpu_torch.types import FCCQPSolution, WarmStart


@dataclasses.dataclass(frozen=True)
class BatchSummary:
    """Global (cross-shard) aggregates of a batched solve: the
    batch-level counterpart of `FCCQPDetails`. Every field is a 0-d
    tensor."""

    n_solved: torch.Tensor        # instances with kSuccess
    n_instances: torch.Tensor
    max_residual_bounds: torch.Tensor
    max_residual_fcone: torch.Tensor
    mean_iterations: torch.Tensor
    max_iterations: torch.Tensor
    max_bounds_viol: torch.Tensor
    max_fcone_viol: torch.Tensor


def _world():
    """``(rank, world size)`` of the joined multi-process job, or (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def summarize(sol: FCCQPSolution) -> BatchSummary:
    """Reduce per-instance details to aggregates: over this process's
    instances, and in a multi-process job over every rank's (sums and
    maxima through `all_reduce`)."""
    d = sol.details
    f64 = torch.float64
    flat = lambda t: t.reshape(-1).to(f64)
    sums = torch.stack([flat(d.solve_status == 0).sum(),
                        torch.tensor(float(d.solve_status.numel()), dtype=f64,
                                     device=d.n_iter.device),
                        flat(d.n_iter).sum()])
    maxs = torch.stack([flat(getattr(d, k)).max() for k in (
        "admm_residual_bounds", "admm_residual_friction_cone", "n_iter",
        "bounds_viol", "friction_cone_viol")])
    _, world = _world()
    if world > 1:
        import torch.distributed as dist

        on = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
        s, m = sums.to(on), maxs.to(on)
        dist.all_reduce(s, op=dist.ReduceOp.SUM)
        dist.all_reduce(m, op=dist.ReduceOp.MAX)
        sums, maxs = s.to(sums.device), m.to(maxs.device)
    return BatchSummary(
        n_solved=sums[0].to(torch.int64), n_instances=sums[1].to(torch.int64),
        max_residual_bounds=maxs[0], max_residual_fcone=maxs[1],
        mean_iterations=(sums[2] / sums[1]).to(torch.float32),
        max_iterations=maxs[2].to(torch.int64), max_bounds_viol=maxs[3],
        max_fcone_viol=maxs[4],
    )


def local_rows(batch: int, mesh) -> range:
    """The instances of a ``batch`` that this process solves over
    ``mesh`` (its own devices): all of them in a single-process job, rank
    r's share of the batch padded to ``world * len(mesh)`` shards in a
    multi-process one."""
    rank, world = _world()
    n = world * len(mesh)
    per = -(-batch // n) * len(mesh)
    return range(min(rank * per, batch), min((rank + 1) * per, batch))


def _run_sharded(tree, axis, mesh, solve, extra=None):
    """Pad ``tree`` (and ``extra``, a tree padded alike or None) to the
    global shard count, keep this rank's part, solve each of its shards on
    its device (``solve(shard, extra_shard, device)``), gather the outputs
    in batch order on ``mesh[0]`` and strip the padding. Returns the
    gathered outputs (a tuple of trees, batch along ``axis``)."""
    rank, world = _world()
    n_local = len(mesh)
    tree, b = pad_batch(tree, world * n_local, axis)
    if extra is not None:
        extra, _ = pad_batch(extra, world * n_local, axis)
    rows = local_rows(b, mesh)
    per = -(-b // (world * n_local)) * n_local
    take = lambda t: None if t is None else map_tree(
        lambda a: a.narrow(axis, rank * per, per), t)
    place = Sharding(tuple(mesh), axis).place
    shards = place(take(tree))
    extras = place(take(extra)) if extra is not None else [None] * n_local
    outs = [solve(s, e, d) for s, e, d in zip(shards, extras, mesh)]
    keep = len(rows)
    strip = lambda a: a.narrow(axis, 0, keep)
    return tuple(map_tree(strip, _cat([o[i] for o in outs], axis, mesh[0]))
                 for i in range(len(outs[0])))


def _cat(trees, axis, device):
    """Concatenate trees of equal structure leaf by leaf along ``axis``
    on ``device``."""
    per_leaf = list(zip(*(leaves(t) for t in trees)))
    it = iter(torch.cat([a.to(device) for a in v], dim=axis)
              for v in per_leaf)
    return map_tree(lambda _: next(it), trees[0])


def solve_batched_sharded(
    qp,
    shape: ProblemShape,
    opts: FCCQPOptions = FCCQPOptions(),
    warm: Optional[WarmStart] = None,
    warm_start: bool = False,
    mesh=None,
    with_summary: bool = True,
):
    """The f64 parity engine (`core.solver.solve_batched`) with the batch
    (leading axis) split over ``mesh`` (default: every visible card).
    Returns ``(solution, warm, summary)``, the padding stripped, gathered
    on ``mesh[0]`` (in a multi-process job, this rank's instances,
    `local_rows`); ``summary`` is None unless ``with_summary``."""
    mesh = make_mesh(mesh)
    sol, ws = _run_sharded(
        qp, 0, mesh,
        lambda q, w, d: solve_batched(q, shape, opts, warm=w,
                                      warm_start=warm_start, device=d),
        extra=warm)
    return sol, ws, summarize(sol) if with_summary else None


def replay_sharded(qps, shape: ProblemShape,
                   opts: FCCQPOptions = FCCQPOptions(), mesh=None):
    """A batch of sequences, axes ``(B, T, ...)``: B split over ``mesh``,
    each sequence replayed warm-started over T (`core.solver.replay`),
    the MPC-scenario / multi-log configuration. Returns ``(solutions with
    axes (B, T, ...), final warm states (B, ...), summary)``."""
    mesh = make_mesh(mesh)

    def run(q, _, d):
        # replay takes time first, then the batch
        qt = map_tree(lambda a: a.transpose(0, 1), q)
        sols, ws = replay(qt, shape, opts, device=d)
        return map_tree(lambda a: a.transpose(0, 1).contiguous(), sols), ws

    sols, ws = _run_sharded(qps, 0, mesh, run)
    return sols, ws, summarize(sols)


def shard_batch_last_tree(tree, mesh, axis_name: str = BATCH_AXIS) -> list:
    """Every leaf's TRAILING axis (the ds engine's batch-last layout) split
    over the mesh: a list of one tree per device."""
    del axis_name
    return Sharding(tuple(mesh), -1).place(tree)


def solve_batched_ds_sharded(
    qp: QPBatchDS,
    shape: ProblemShape,
    opts: FCCQPOptions = FCCQPOptions(),
    warm: Optional[WarmStartDS] = None,
    warm_start: bool = False,
    mesh=None,
    con_idx: Optional[tuple] = None,
):
    """The ds engines (`core.ds_engine.solve_batched_ds`) with the batch
    (TRAILING axis) split over ``mesh`` (default: every visible card). The
    reduced path's constrained coordinates come from the whole batch
    (``con_idx``, computed when None), as in the unsharded solve. Returns
    ``(solution, warm, summary)``: the solution batch-leading, the warm
    state batch-last, the padding stripped and the summary computed after
    stripping (in a multi-process job: this rank's instances,
    `local_rows`, and the summary over every rank's)."""
    mesh = make_mesh(mesh)
    if con_idx is None and _reduced(opts):
        con_idx = constrained_indices(qp, shape,
                                      full=opts.splitting == "full")

    def run(q, w, d):
        sol, ws = solve_batched_ds(q, shape, opts, warm=w,
                                   warm_start=warm_start, device=d,
                                   con_idx=con_idx)
        # the solution is batch-leading: carry it batch-last like the rest
        return map_tree(lambda a: a.movedim(0, -1) if a.dim() else a,
                        sol), ws

    sol, ws = _run_sharded(qp, -1, mesh, run, extra=warm)
    sol = map_tree(lambda a: a.movedim(-1, 0).contiguous() if a.dim() else a,
                   sol)
    return sol, ws, summarize(sol)
