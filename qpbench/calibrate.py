"""The readings the limits of `qpbench.check` are set from: for each
seed, a short window of the cell's own traffic at its own sizes, then
the sample's numbers for the program's answers and for the control's
(the reference in f32 in the program's place) on the same QPs. One
process for all seeds, so the set-up's captures are made once.

    python3 -m qpbench.calibrate --workload <name> --seeds 11,12,13 \\
        --seconds 5 [--out calibrate_<name>.jsonl]

Prints one JSON line per seed (and appends it to ``--out``). Needs a
card, like the benchmark; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    from qpbench.run import ROOT, log

    p = argparse.ArgumentParser(prog="python3 -m qpbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    from qpbench import check, drivers, gen, spec

    if not torch.cuda.is_available():
        log("qpbench.calibrate: no CUDA device")
        return 3
    cell = spec.cell(ROOT, args.workload)
    dev = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        drv = spec.driver(cell.traffic["driver"])(cell, dev, seed)
        drv.setup()
        t_setup = time.perf_counter() - t0
        win = drv.window(args.seconds)
        qp, z, status = drv.sample()
        drv.release()
        del drv
        torch.cuda.empty_cache()
        solved = status == drivers.K_SUCCESS
        qp = {k: v[solved] for k, v in qp.items()}
        d = gen.dims(cell.config["model"])
        t1 = time.perf_counter()
        prog = check.readings(qp, z[solved], d["ls"], d["nc"])
        t_ref = time.perf_counter() - t1
        ctrl = check.readings(qp, None, d["ls"], d["nc"],
                              candidate=check.control_answers(d["ls"],
                                                              d["nc"]))
        line = dict(workload=args.workload, seed=seed, setup_s=t_setup,
                    reference_s=t_ref, attempted=win["attempted"],
                    failed=win["failed"], calls=win["calls"],
                    values=win["values"], sampled_not_solved=int(
                        (~solved).sum()),
                    program=prog, control=ctrl,
                    program_verdict=check.verdict(prog)[0],
                    control_verdict=check.verdict(ctrl)[0])
        print(json.dumps(line), flush=True)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
