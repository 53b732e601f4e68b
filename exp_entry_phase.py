#!/usr/bin/env python3
"""Phase 18 of `chip_smoke.py` (the bench entry point), alone, on one card:

    python3 exp_entry_phase.py [model ...]

from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit. Builds the kernels, then runs `chip_smoke.entry_phase` with its
checks for the named models (``quadruped``, ``humanoid``, ``cassie``; all
when none is named). Cassie's run is held bit for bit against phase 5's
captured replay, so naming it runs phase 5 (`chip_smoke.replay_phase`)
first. Prints each phase's lines and seconds, and a JSON line last.
"""

from __future__ import annotations

import json
import sys
import time

import chip_smoke as cs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("exp_entry_phase: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, cs.ROOT)
    import fcc_qp_tpu_torch.core.ds_engine as engine
    from fcc_qp_tpu_torch import FCCQPOptions
    from fcc_qp_tpu_torch.models.osc import CASSIE
    from fcc_qp_tpu_torch.ops import pallas_admm

    models = sys.argv[1:] or [m for m, _ in cs.ENTRY_RUNS]
    unknown = set(models) - {m for m, _ in cs.ENTRY_RUNS}
    if unknown:
        print(f"exp_entry_phase: unknown models {sorted(unknown)}",
              file=sys.stderr)
        return 2
    cs.ENTRY_RUNS = tuple(r for r in cs.ENTRY_RUNS if r[0] in models)
    pallas_admm.build_kernels()
    cs.log(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: "
           f"{cs.smi_line()}; torch {torch.__version__}, CUDA "
           f"{torch.version.cuda}")
    specs = (
        ("admm_chunk_f64", pallas_admm.admm_chunk_f64,
         pallas_admm.admm_chunk_f64_plain, "f64", ""),
        ("admm_chunk_f32", pallas_admm.admm_chunk_f32,
         pallas_admm.admm_chunk_f32_plain, "f32", ""),
    )
    seconds = {}
    log_stacked = replay_sols = None
    if "cassie" in models:
        bench = FCCQPOptions(**cs.BENCH_OPTS,
                             polish_newton_steps=CASSIE.polish_newton_steps)
        t0 = time.perf_counter()
        out = cs.replay_phase(engine, bench)
        log_stacked, replay_sols = out[2], out[5]
        seconds["replay"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches, cases, report = cs.entry_phase(engine, specs, log_stacked,
                                             replay_sols)
    seconds["entry"] = time.perf_counter() - t0
    print(json.dumps({"seconds": seconds, "launches": launches,
                      "cases": cases, "report": report}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
