#!/usr/bin/env python3
"""Holds the parity engine's ADMM loop as one launch of the full-layout
kernel for ``max_iter`` iterations against the loop in launches of 64
iterations with a host read between them (the loop `core.solver._admm`
ran before the captured solve), on the card, at full batch size.

    python3 exp_single_launch.py [--reps 3]

For each case, the solve through the public entry point with the one
launch (as the package runs it) and with the chunked loop (the kernel
wrapper replaced by one that issues the launches of 64 and reads the
device between them, as the old loop did), run alternately: every output
bit for bit (z, the warm state, every diagnostic but the times), and the
median wall of each (synchronized host clock). Cases, on the Cassie
batch of `chip_smoke.py` (``generate_osc_batch(CASSIE, 8192, seed=0)``):
the f64 engine at `chip_smoke.F32_OPTS` (the bench's parity-engine
flags), the same on f32 data (``bench.py --engine f32``), and the
sharded f64 solve over two shards on the one card at
`chip_smoke.SHARD_OPTS`. Prints one line per case, the `nvidia-smi`
name and power limit, and a last JSON line; writes the same JSON to
``chiprun_out/single_launch.json``.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CHUNK = 64


def chunked(kernel, reads):
    """``kernel`` (a full-layout chunk wrapper) as the old chunked loop:
    launches of up to 64 iterations until every instance is done or out
    of iterations, one host read before each launch."""
    def run(*args, K, max_iter, **kw):
        const, state = args[:8], tuple(args[8:])
        while True:
            reads[0] += 1
            if bool((state[6] | (state[8] >= max_iter)).all()):
                return state
            state = tuple(kernel(*const, *state, K=min(K, CHUNK),
                                 max_iter=max_iter, **kw))
    return run


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("exp_single_launch: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    import chip_smoke as cs
    import fcc_qp_tpu_torch.core.solver as solver_mod
    from fcc_qp_tpu_torch import FCCQPOptions, solve_batched
    from fcc_qp_tpu_torch.models.osc import CASSIE, generate_osc_batch
    from fcc_qp_tpu_torch.ops import pallas_admm
    from fcc_qp_tpu_torch.parallel import solve_batched_sharded
    from fcc_qp_tpu_torch.utils.io import stack_qp_dicts, to_qpbatch

    pallas_admm.build_kernels()
    shape = CASSIE.shape
    stacked = stack_qp_dicts(generate_osc_batch(CASSIE, cs.B, seed=0))
    q64 = to_qpbatch(stacked)
    q32 = to_qpbatch(stacked, dtype=torch.float32)
    cuda0 = torch.device("cuda", 0)
    cases = {
        "f64_B8192": lambda: solve_batched(
            q64, shape, FCCQPOptions(**cs.F32_OPTS)),
        "f32_B8192": lambda: solve_batched(
            q32, shape, FCCQPOptions(**cs.F32_OPTS)),
        "sharded_f64_B8192_x2": lambda: solve_batched_sharded(
            q64, shape, FCCQPOptions(**cs.SHARD_OPTS),
            mesh=[cuda0, cuda0])[:2],
    }
    plain_full_chunk = solver_mod.full_chunk
    reads = [0]

    def run(fn, how):
        if how == "chunked":
            solver_mod.full_chunk = lambda dt: chunked(plain_full_chunk(dt),
                                                       reads)
        try:
            reads[0] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sol, warm = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            solver_mod.full_chunk = plain_full_chunk
        return sol, warm, wall, reads[0]

    def fields(sol, warm):
        d = {k: v for k, v in vars(sol.details).items()
             if k not in ("solve_time", "factorization_time")}
        d.update(z=sol.z, x=warm.x, mu_x=warm.mu_x,
                 mu_lambda_c=warm.mu_lambda_c)
        return d

    out = {}
    for name, fn in cases.items():
        run(fn, "single")                          # warm-up
        walls = {"single": [], "chunked": []}
        first, host_reads = {}, 0
        order = ["single", "chunked", "chunked", "single"]
        order = (order * args.reps)[:2 * args.reps]
        for how in order:
            sol, warm, wall, nread = run(fn, how)
            walls[how].append(wall)
            if how == "chunked":
                host_reads = nread
            first.setdefault(how, fields(sol, warm))
        diff = sorted(k for k, v in first["single"].items()
                      if not torch.equal(v, first["chunked"][k]))
        n_iter = first["single"]["n_iter"].cpu().numpy()
        st = first["single"]["solve_status"].cpu().numpy()
        rec = dict(
            bit_equal=not diff, fields_differing=diff,
            single_wall_s=float(np.median(walls["single"])),
            chunked_wall_s=float(np.median(walls["chunked"])),
            single_walls_s=walls["single"], chunked_walls_s=walls["chunked"],
            chunked_host_reads=host_reads,
            kSuccess=int((st == 0).sum()), n_iter_max=int(n_iter.max()),
            n_iter_p50=float(np.median(n_iter)))
        out[name] = rec
        print(f"[single_launch] {name}: one launch {rec['single_wall_s']:.6f}"
              f" s, chunks of {CHUNK} {rec['chunked_wall_s']:.6f} s (median "
              f"walls; {host_reads} host reads in the chunked solve); bit for "
              f"bit: {rec['bit_equal']} {diff}; kSuccess {rec['kSuccess']}, "
              f"n_iter p50 {rec['n_iter_p50']:.0f} max {rec['n_iter_max']}",
              flush=True)
    card = cs.smi_line()
    print(card, flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "single_launch.json"),
              "w") as f:
        json.dump(dict(card=card, cases=out), f, indent=1)
    print(json.dumps(dict(card=card, cases=out)), flush=True)
    return 0 if all(r["bit_equal"] for r in out.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
