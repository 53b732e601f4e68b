#!/usr/bin/env python3
"""Where a queued bench-flag cold solve holds the host, on one card:

    python3 exp_queue_depth.py

from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit. Captures the Cassie B = 8192 cold solve at the bench flags
(`chip_smoke.py` phase 2's batch) twice, as two `CapturedBatch`es, then
times on the host, each series from an idle card and ended by one
synchronize:

* six replays of one capture (`CapturedBatch.run`) queued back to back;
* six replays alternating between the two captures;
* six launches of one capture's iteration graph alone, and of its
  operator graph alone.

Prints each launch's host seconds per series, and a JSON line last.
"""

from __future__ import annotations

import json
import sys
import time

import chip_smoke as cs

DEPTH = 6


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("exp_queue_depth: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, cs.ROOT)
    from fcc_qp_tpu_torch import FCCQPOptions, to_ds_batch
    from fcc_qp_tpu_torch.core.ds_engine import (constrained_indices,
                                                 reduced_stages)
    from fcc_qp_tpu_torch.core.graphs import CapturedBatch
    from fcc_qp_tpu_torch.models.osc import CASSIE, generate_osc_batch
    from fcc_qp_tpu_torch.ops import pallas_admm
    from fcc_qp_tpu_torch.utils.io import stack_qp_dicts

    pallas_admm.build_kernels()
    cs.log(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: "
           f"{cs.smi_line()}; torch {torch.__version__}, CUDA "
           f"{torch.version.cuda}")
    qp = to_ds_batch(stack_qp_dicts(generate_osc_batch(CASSIE, cs.B,
                                                       seed=0)))
    bench = FCCQPOptions(**cs.BENCH_OPTS,
                         polish_newton_steps=CASSIE.polish_newton_steps)
    stages = reduced_stages(CASSIE.shape, bench,
                            constrained_indices(qp, CASSIE.shape))
    caps = [CapturedBatch(stages, cs.B, "cuda") for _ in range(2)]
    for cap in caps:
        cap.load(qp)
        cap.run(False)
    torch.cuda.synchronize()

    def series(launches):
        torch.cuda.synchronize()
        walls = []
        t0 = time.perf_counter()
        for launch in launches:
            t = time.perf_counter()
            launch()
            walls.append(time.perf_counter() - t)
        torch.cuda.synchronize()
        return dict(issue_s=walls, total_s=time.perf_counter() - t0)

    g_prep, g_iter, _, _ = caps[0]._captured[False]
    out = {
        "one_capture": series([lambda: caps[0].run(False)] * DEPTH),
        "two_captures": series([lambda c=caps[i % 2]: c.run(False)
                                for i in range(DEPTH)]),
        "iteration_graph": series([g_iter.replay] * DEPTH),
        "operator_graph": series([g_prep.replay] * DEPTH),
    }
    for name, rep in out.items():
        cs.log(f"[queue:{name}] host seconds per launch: "
               + ", ".join(f"{t:.6f}" for t in rep["issue_s"])
               + f"; {rep['total_s']:.6f} s to the synchronize")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
