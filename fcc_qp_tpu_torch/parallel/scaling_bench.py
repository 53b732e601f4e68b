"""Device-count scaling of the sharded solve (port of
`fcc_qp_tpu/parallel/scaling_bench.py`).

Weak scaling: a fixed per-device batch is solved on meshes of 1, 2, 4,
... devices; the efficiency at N devices is

    eff(N) = throughput(N) / (N * throughput(1)).

A mesh of N reuses the visible cards in turn, so on one card N = 2 is
two shards on that card (solved one after the other: the efficiency there
measures what a shard's fixed costs take, not a second card). In one
process the shards of a multi-card mesh also run in turn
(`parallel.sharded`); several processes are what run cards side by side.

    python -m fcc_qp_tpu_torch.parallel.scaling_bench --per-device-batch 4096
    python -m fcc_qp_tpu_torch.parallel.scaling_bench --overhead

prints one JSON report (``--cpu`` runs on the CPU, at a small batch).
"""

from __future__ import annotations

import json
import time
from typing import Optional, Sequence

import numpy as np
import torch

from fcc_qp_tpu_torch.config import FCCQPOptions, ProblemShape
from fcc_qp_tpu_torch.core.ds_engine import QPBatchDS, solve_batched_ds
from fcc_qp_tpu_torch.parallel.mesh import make_mesh
from fcc_qp_tpu_torch.parallel.sharded import (
    solve_batched_ds_sharded,
    summarize,
)
from fcc_qp_tpu_torch.utils.timing import sync


def _device_counts(n_devices: int) -> tuple:
    counts, c = [], 1
    while c <= n_devices:
        counts.append(c)
        c *= 2
    if counts[-1] != n_devices:
        counts.append(n_devices)
    return tuple(counts)


def _timed(fn, devices, repeats: int):
    """Min wall seconds over ``repeats`` calls after one untimed call,
    each ending in a synchronize of every device; and the last output."""
    out = fn()
    for d in set(devices):
        sync(d)
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        for d in set(devices):
            sync(d)
        ts.append(time.perf_counter() - t0)
    return float(np.min(ts)), out


def run_scaling_bench(shape: ProblemShape, qp_ds: QPBatchDS,
                      opts: FCCQPOptions,
                      device_counts: Optional[Sequence[int]] = None,
                      repeats: int = 3,
                      devices: Optional[Sequence] = None) -> dict:
    """Weak-scaling sweep: for each count N, the first ``per_dev * N``
    instances of ``qp_ds`` (batch-last) on a mesh of N devices drawn in
    turn from ``devices`` (default: the visible cards), ``per_dev =
    batch // max(device_counts)``. Every instance must converge (the
    sweep measures the bench configuration, not a broken one)."""
    devices = list(devices) if devices is not None else make_mesh()
    if device_counts is None:
        device_counts = _device_counts(len(devices))
    per_dev = qp_ds.batch // max(device_counts)
    if per_dev <= 0:
        raise ValueError("batch smaller than the largest device count")
    results = []
    for n in device_counts:
        mesh = [devices[i % len(devices)] for i in range(n)]
        B = per_dev * n
        sub = QPBatchDS(*(a[..., :B] for a in qp_ds))
        t, (sol, _, summary) = _timed(
            lambda: solve_batched_ds_sharded(sub, shape, opts, mesh=mesh),
            mesh, repeats)
        n_solved = int(summary.n_solved)
        if n_solved != B:
            raise AssertionError(
                f"scaling sweep at {n} device(s): only {n_solved}/{B} "
                "instances converged; fix the solver configuration before "
                "recording scaling numbers")
        results.append(dict(devices=n, mesh=[str(d) for d in mesh], batch=B,
                            time_s=t, solves_per_s=B / t, n_solved=n_solved))
    base = results[0]["solves_per_s"]
    for r in results:
        r["efficiency_pct"] = 100.0 * r["solves_per_s"] / (r["devices"] * base)
    return dict(mode="weak_scaling", device=str(devices[0]),
                per_device_batch=per_dev, results=results)


def run_overhead_probe(shape: ProblemShape, qp_ds: QPBatchDS,
                       opts: FCCQPOptions, repeats: int = 5,
                       device=None) -> dict:
    """What the sharded entry point adds on one device: its wall over the
    plain batched solve's (padding, the shard's placement, the gather and
    the summary), and the summary reduction alone."""
    dev = make_mesh([device] if device is not None else None)[0]
    qp_dev = QPBatchDS(*(a.to(dev) for a in qp_ds))
    t_plain, (sol, _) = _timed(
        lambda: solve_batched_ds(qp_dev, shape, opts, device=dev), [dev],
        repeats)
    t_entry, _ = _timed(
        lambda: solve_batched_ds_sharded(qp_ds, shape, opts, mesh=[dev]),
        [dev], repeats)
    t_sum, _ = _timed(lambda: summarize(sol), [dev], repeats)
    return dict(mode="single_device_overhead", device=str(dev),
                batch=qp_ds.batch, plain_solve_s=t_plain,
                sharded_entry_s=t_entry, entry_overhead_s=t_entry - t_plain,
                entry_overhead_pct=100.0 * (t_entry - t_plain) / t_plain,
                summary_reduction_s=t_sum,
                summary_reduction_pct_of_solve=100.0 * t_sum / t_plain)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--per-device-batch", type=int, default=4096)
    p.add_argument("--model", default="cassie",
                   choices=["cassie", "quadruped", "humanoid"])
    p.add_argument("--device-counts", type=int, nargs="*", default=None,
                   help="mesh sizes (default: 1, 2, 4, ... up to the "
                        "visible cards, and at least 1 and 2)")
    p.add_argument("--overhead", action="store_true",
                   help="the single-device overhead probe instead of the "
                        "sweep")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    args = p.parse_args(argv)

    from fcc_qp_tpu_torch.core.ds_engine import to_ds_batch
    from fcc_qp_tpu_torch.models.osc import MODELS, generate_osc_sequence
    from fcc_qp_tpu_torch.utils.io import stack_qp_dicts

    devices = [torch.device("cpu")] if args.cpu else make_mesh()
    counts = args.device_counts or sorted(
        set(_device_counts(len(devices))) | {1, 2})
    model = MODELS[args.model]
    B = args.per_device_batch * (1 if args.overhead else max(counts))
    # the walking-log workload at the bench flags, as the JAX sweep
    qps = generate_osc_sequence(model, B, seed=0, smoothness=0.002)
    qp_ds = to_ds_batch(stack_qp_dicts(qps), device="cpu")
    opts = FCCQPOptions(
        max_iter=3000, rho=0.05, eps_fcone=1e-6, eps_bound=1e-6,
        adaptive_rho=False, adaptive_rho_interval=100,
        adaptive_rho_max_adaptations=1, presolve="operator",
        scaling=True, splitting="constrained", kkt_refine_steps=1,
        polish=True, polish_rounds=4,
        polish_newton_steps=model.polish_newton_steps,
    )
    if args.overhead:
        report = run_overhead_probe(model.shape, qp_ds, opts,
                                    device=devices[0])
    else:
        report = run_scaling_bench(model.shape, qp_ds, opts, counts,
                                   devices=devices)
    report["opts"] = (
        "walking-log workload (smoothness=0.002, seed=0); max_iter=3000 "
        "rho=0.05 eps=1e-6 scaling splitting=constrained "
        "presolve=operator kkt_refine_steps=1 polish rounds=4 "
        f"newton_steps={model.polish_newton_steps}")
    report["model"] = args.model
    print(json.dumps(report))


if __name__ == "__main__":
    main()
