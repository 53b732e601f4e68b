#!/usr/bin/env python3
"""Device-time profile of the port's cold batched solve on one card.

    python3 exp_torch_profile.py [--batch 8192] [--out trace.json]

Runs `fcc_qp_tpu_torch.solve_batched_ds` on `generate_osc_batch(CASSIE,
B, seed=0)` at the bench flags: two warm-up solves, then one solve under
`torch.profiler` (CPU + CUDA activities). Prints the solve's wall time,
the summed device time of its kernels, the device idle share
(1 - busy / wall, where busy is the union of kernel intervals on the
timeline), and the kernels with the most device time. Writes the
Chrome trace to ``--out`` when given. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _busy_us(events) -> float:
    """Length of the union of [start, end) intervals, in microseconds."""
    spans = sorted(events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("exp_torch_profile: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fcc_qp_tpu_torch import FCCQPOptions, solve_batched_ds, to_ds_batch
    from fcc_qp_tpu_torch.models.osc import CASSIE, generate_osc_batch
    from fcc_qp_tpu_torch.ops import pallas_admm
    from fcc_qp_tpu_torch.utils.io import stack_qp_dicts

    pallas_admm.build_kernels()
    qp = to_ds_batch(stack_qp_dicts(generate_osc_batch(CASSIE, args.batch, seed=0)))
    opts = FCCQPOptions(
        max_iter=3000, rho=0.05, eps_fcone=1e-6, eps_bound=1e-6,
        presolve="operator", scaling=True, splitting="constrained",
        polish=True, polish_rounds=4,
        polish_newton_steps=CASSIE.polish_newton_steps,
    )
    for _ in range(2):
        solve_batched_ds(qp, CASSIE.shape, opts)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve_batched_ds(qp, CASSIE.shape, opts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    kernels = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    busy = _busy_us(spans) * 1e-6
    total = sum(e.time_range.end - e.time_range.start for e in kernels) * 1e-6
    by_name: dict = {}
    for e in kernels:
        d = by_name.setdefault(e.name, [0.0, 0])
        d[0] += (e.time_range.end - e.time_range.start) * 1e-3
        d[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    print(f"device: {torch.cuda.get_device_name(0)}; B={args.batch}")
    print(f"profiled wall {wall:.6f} s; kernels {len(kernels)}; "
          f"device busy {busy:.6f} s; kernel time summed {total:.6f} s; "
          f"idle share {1.0 - busy / wall:.4f}")
    for name, (ms, n) in top:
        print(f"  {ms:10.3f} ms  {n:6d} launches  {name[:90]}")
    print(json.dumps({
        "wall_s": wall, "busy_s": busy, "idle_share": 1.0 - busy / wall,
        "launches": len(kernels),
        "top": [{"name": k, "ms": v[0], "launches": v[1]} for k, v in top],
    }))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        prof.export_chrome_trace(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
