#!/usr/bin/env python3
"""Phase 19 of `chip_smoke.py` (the public surface and the walking-log
example), alone, on one card:

    python3 exp_surface_phase.py

from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit. Builds the kernels, generates phase 2's Cassie batch, then runs
`chip_smoke.surface_phase` with its checks (the example's loop and
batched runs, ``timing=False`` queued calls, ``rho=`` / ``operator=``
solves, the kernels on this phase's chunks). Prints the phase's lines
and seconds, and a JSON line last.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time

import chip_smoke as cs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("exp_surface_phase: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, cs.ROOT)
    import fcc_qp_tpu_torch.core.solver as solver_mod
    from fcc_qp_tpu_torch import FCCQPOptions, to_ds_batch
    from fcc_qp_tpu_torch.models.osc import CASSIE, generate_osc_batch
    from fcc_qp_tpu_torch.ops import pallas_admm
    from fcc_qp_tpu_torch.utils.io import stack_qp_dicts

    pallas_admm.build_kernels()
    cs.log(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: "
           f"{cs.smi_line()}; torch {torch.__version__}, CUDA "
           f"{torch.version.cuda}")
    stacked = stack_qp_dicts(generate_osc_batch(CASSIE, cs.B, seed=0))
    qp = to_ds_batch(stacked)
    bench = FCCQPOptions(**cs.BENCH_OPTS,
                         polish_newton_steps=CASSIE.polish_newton_steps)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        launches, cases, report = cs.surface_phase(
            cs.example_module(), qp, bench, stacked, solver_mod, out_dir)
    seconds = time.perf_counter() - t0
    print(json.dumps({"seconds": seconds, "launches": launches,
                      "cases": cases, "report": report}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
