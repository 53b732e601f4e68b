#!/usr/bin/env python3
"""Phase 20 of `chip_smoke.py` (the polish's Newton-Schulz kernel) alone,
and the batch sizes at which the kernel beats the batched cuBLAS chain,
on one card:

    python3 exp_polish_ns.py [--sweep-only]

from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit. Builds the kernels, makes phase 2's Cassie batch (B = 8192,
`generate_osc_batch(CASSIE, 8192, seed=0)`), runs `chip_smoke.
polish_ns_phase` (its checks and lines; launches read 0 here, since no
captured path runs), then times the seed and the refresh of the first
``B`` chains of that batch's inputs in the kernel and in the chain for
each ``B`` of `SWEEP` (each captured in a CUDA graph, as the solves
run them; CUDA events over its replays, ms per call). Prints a JSON line
last.
"""

from __future__ import annotations

import json
import sys

import chip_smoke as cs

SWEEP = (1, 2, 4, 8, 16, 32, 64, 128, 512, 1024)


def graph_ms(fn, reps=20):
    """Device ms of one replay of ``fn`` captured in a CUDA graph (as the
    solves run it), CUDA events over ``reps`` replays."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    g.replay()
    torch.cuda.synchronize()
    out = {}
    with cs.cuda_span(out, "ms"):
        for _ in range(reps):
            g.replay()
    return out["ms"] / reps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("exp_polish_ns: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, cs.ROOT)
    from fcc_qp_tpu_torch import (FCCQPOptions, solve_batched_ds,
                                  to_ds_batch)
    from fcc_qp_tpu_torch.models.osc import CASSIE, generate_osc_batch
    from fcc_qp_tpu_torch.ops import pallas_admm, polish
    from fcc_qp_tpu_torch.utils.io import stack_qp_dicts

    pallas_admm.build_kernels()
    cs.log(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: "
           f"{cs.smi_line()}; torch {torch.__version__}, CUDA "
           f"{torch.version.cuda}")
    qp = to_ds_batch(stack_qp_dicts(generate_osc_batch(CASSIE, cs.B,
                                                       seed=0)))
    bench = FCCQPOptions(**cs.BENCH_OPTS,
                         polish_newton_steps=CASSIE.polish_newton_steps)
    out = {}
    if "--sweep-only" not in sys.argv:
        none = {"polish_ns": 0}
        out["phase"] = cs.polish_ns_phase(qp, bench, none, none)
    ins = cs.ns_chain_inputs(lambda: solve_batched_ds(
        qp, CASSIE.shape, bench, graphs=False))
    Mb, (X, Mr) = ins["seed"], ins["refresh"]
    reps = -(-max(SWEEP) // Mr.shape[0])
    X, Mr = X.repeat(reps, 1, 1), Mr.repeat(reps, 1, 1)
    sweep = {}
    floor = polish.NS_KERNEL_MIN_BATCH
    for b in SWEEP:
        row = {}
        for case, args in (("seed", (Mb[:b].contiguous(),)),
                           ("refresh", (Mr[:b].contiguous(),
                                        X[:b].contiguous()))):
            polish.NS_KERNEL_MIN_BATCH = {"seed": 1, "refresh": 1}
            k_ms = graph_ms(lambda: polish.polish_ns(*args))
            polish.NS_KERNEL_MIN_BATCH = floor
            p_ms = graph_ms(lambda: polish.polish_ns_plain(*args))
            row[case] = dict(kernel_ms=k_ms, chain_ms=p_ms)
        cs.log(f"[sweep] B={b}: " + json.dumps(row))
        sweep[b] = row
    out["sweep"] = sweep
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
