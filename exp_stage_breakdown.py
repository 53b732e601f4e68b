#!/usr/bin/env python3
"""Every stage and span the program's telemetry holds, per cell:

    python3 exp_stage_breakdown.py [--seed 7] [--seconds 10] [cell ...]

on a machine with a CUDA card, from the root of a checkout. For each
cell of `BENCHMARK.json` named (default: all) it sets the cell's driver
up and runs its window as `qpbench.run` does, then prints one JSON line
from `fcc_qp_tpu_torch.utils.timing.telemetry()`: for each capture, its
replays, each stage's device ms and visits per replay (all of
`STAGES`, not only the four the benchmark reads), its sub-stage sites
summed by name, mode, N2 and path (ms and visits per replay, and the
sites' count), its seconds by phase and its nodes by type; and each host
span's count and median ms.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    p = argparse.ArgumentParser(prog="python3 exp_stage_breakdown.py")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("cells", nargs="*")
    args = p.parse_args()
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    from fcc_qp_tpu_torch.utils import timing
    from qpbench import spec

    torch.set_num_threads(1)
    dev = torch.device("cuda")
    cells = args.cells or [w["name"] for w in spec.benchmark(HERE)[
        "workloads"]]
    for name in cells:
        cell = spec.cell(HERE, name)
        drv = spec.driver(cell.traffic["driver"])(cell, dev, args.seed)
        first = len(timing._RECORDS)
        counts = {k: s.n for k, s in timing._SPANS.items()}
        drv.setup()
        win = drv.window(args.seconds)
        snap = timing.telemetry(dev)
        caps = []
        for c in snap["captures"][first:]:
            r = max(c["replays"], 1)
            subs = {}
            for site in c.get("sites", []):
                key = "/".join(str(site.get(k)) for k in (
                    "name", "mode", "n2", "path"))
                t = subs.setdefault(key, dict(ms=0.0, visits=0.0, sites=0))
                t["ms"] += site["ns"] * 1e-6 / r
                t["visits"] += site["visits"] / r
                t["sites"] += 1
            caps.append(dict(
                kind=c["kind"], warm=c["warm"], replays=c["replays"],
                stage_ms={k: v["ns"] * 1e-6 / r
                          for k, v in c["stages"].items() if v["visits"]},
                visits={k: v["visits"] / r
                        for k, v in c["stages"].items() if v["visits"]},
                sub_stage_ms=subs, seconds=c["seconds"], nodes=c["nodes"],
                stamps=c["stamps"]))
        spans = {}
        for k, s in snap["spans"].items():
            n = s["count"] - counts.get(k, 0)
            if n > 0:
                spans[k] = dict(count=n, median_ms=float(
                    np.median(s["ns"][-min(n, len(s["ns"])):])) * 1e-6)
        print(json.dumps(dict(cell=name, device=torch.cuda.get_device_name(),
                              calls=win["calls"], values=win["values"],
                              captures=caps, spans=spans)), flush=True)
        drv.release()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
