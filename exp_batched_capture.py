#!/usr/bin/env python3
"""The batched captures alone: `chip_smoke.py`'s phase 2 (the cold
Cassie solve at B = 8192, captured, against the eager and the uncaptured
static solve) and phase 5 (the 4096 x 16 warm replay, captured), without
the other phases. Run on a machine with a CUDA card, from the root of a
checkout:

    python3 exp_batched_capture.py

Prints each phase's lines as `chip_smoke.py` does.
"""

from __future__ import annotations

import sys
import time


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import fcc_qp_tpu_torch.core.ds_engine as engine
    from fcc_qp_tpu_torch import FCCQPOptions, to_ds_batch
    from fcc_qp_tpu_torch.models.osc import CASSIE, generate_osc_batch
    from fcc_qp_tpu_torch.ops import pallas_admm
    from fcc_qp_tpu_torch.utils.io import stack_qp_dicts

    pallas_admm.build_kernels()
    cs.log(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: "
           f"{cs.smi_line()}")
    bench = FCCQPOptions(**cs.BENCH_OPTS,
                         polish_newton_steps=CASSIE.polish_newton_steps)
    t0 = time.perf_counter()
    qp = to_ds_batch(stack_qp_dicts(generate_osc_batch(CASSIE, cs.B,
                                                       seed=0)))
    cs.captured_cold_phase(engine, qp, bench)
    cs.log(f"[exp] phase 2 in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cs.replay_phase(engine, bench)
    cs.log(f"[exp] phase 5 in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
