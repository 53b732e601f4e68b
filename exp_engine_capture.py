#!/usr/bin/env python3
"""The captured full-layout engines of `chip_smoke.py`, alone, on one card:

    python3 exp_engine_capture.py [phase ...]

from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit. Phases (all when none is named), each `chip_smoke.py`'s own
function with its checks:

* ``dropin``: phase 7, the drop-in `FCCQP` on both engines (the parity
  engine's B = 1 graphs, whose shift levels and refinement are IF nodes);
* ``full``: phase 6, the full-splitting engine at `FULL_OPTS`, B = 8192;
* ``fast``: phase 13, `solve_batched_fast` at `FAST_OPTS` and
  `FAST_ALPHA_OPTS`;
* ``f32``: phase 14, the parity engine on f32 data;
* ``replay``: phase 15, the parity `replay` at B = 1 and over streams;
* ``sharded``: phase 17, the sharded solves at `SHARD_OPTS`.

The walking log here is `generate_osc_sequence(CASSIE, 8192, seed=0,
smoothness=0.002)`, the first 8192 steps' worth of `chip_smoke.py`'s
65536-step log (the replay's streams and the scaling sweep read no more).
Prints each phase's lines and seconds, and ``{"ok": true}`` last.
"""

from __future__ import annotations

import json
import sys
import time

import chip_smoke as cs

PHASES = ("dropin", "full", "fast", "f32", "replay", "sharded")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("exp_engine_capture: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, cs.ROOT)
    import fcc_qp_tpu_torch.core.ds_engine as engine
    import fcc_qp_tpu_torch.core.solver as solver_mod
    from fcc_qp_tpu_torch import FCCQPOptions
    from fcc_qp_tpu_torch.models.osc import (CASSIE, generate_osc_batch,
                                             generate_osc_sequence)
    from fcc_qp_tpu_torch.ops import pallas_admm
    from fcc_qp_tpu_torch.utils.io import stack_qp_dicts

    phases = sys.argv[1:] or PHASES
    unknown = set(phases) - set(PHASES)
    if unknown:
        print(f"exp_engine_capture: unknown phases {sorted(unknown)}",
              file=sys.stderr)
        return 2
    pallas_admm.build_kernels()
    cs.log(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: "
           f"{cs.smi_line()}; torch {torch.__version__}")
    stacked = stack_qp_dicts(generate_osc_batch(CASSIE, cs.B, seed=0))
    walking = stack_qp_dicts(generate_osc_sequence(
        CASSIE, cs.B, seed=0, smoothness=0.002))
    bench = FCCQPOptions(**cs.BENCH_OPTS,
                         polish_newton_steps=CASSIE.polish_newton_steps)
    runs = {
        "dropin": lambda: cs.dropin_phase(solver_mod)[3],
        "full": lambda: cs.full_phase(engine)[3],
        "fast": lambda: cs.fast_phase(stacked)[1],
        "f32": lambda: cs.f32_phase(stacked, solver_mod)[2],
        "replay": lambda: cs.parity_replay_phase(walking)[1],
        "sharded": lambda: cs.sharded_phase(stacked, walking, bench)[3],
    }
    seconds = {}
    for name in phases:
        t0 = time.perf_counter()
        runs[name]()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        cs.log(f"[exp] phase {name}: {seconds[name]:.1f} s")
    print(json.dumps({"seconds": seconds}), flush=True)
    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
