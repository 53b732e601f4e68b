#!/usr/bin/env python3
"""Times the port's chunk kernels at alpha = 1 on fixed inputs, to hold
two trees against each other on one card within one call.

    python3 exp_kernel_ab.py <root> <label>

imports `fcc_qp_tpu_torch` and `chip_smoke.py` from the checkout at
<root> (built there at first use), records the kernels' inputs from the
solves `chip_smoke.py` records them from, and prints one line ``TIMES
<label> {case: ms per launch}`` (CUDA events, `chip_smoke.time_cuda`):
the full-layout kernel on the Cassie B=8192 full-splitting solve's first
and last chunks (`chip_smoke.FULL_OPTS`), on a B = 1 parity-engine chunk
and on the humanoid B=1024 full engine's first chunk; both reduced
kernels on the two-phase solve's first chunk and the bench-flag solve's
last. To compare a change with its parent, unpack the parent into a
gitignored directory (``git archive``) and run, in one call, parent,
change, change, parent:

    for r in _chip_checkout/parent . . _chip_checkout/parent; do
        python3 exp_kernel_ab.py $r $r; done
"""

import json
import sys


def main(root: str, label: str) -> None:
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    import fcc_qp_tpu_torch as T
    import fcc_qp_tpu_torch.core.ds_engine as eng
    import fcc_qp_tpu_torch.core.solver as solver_mod
    from fcc_qp_tpu_torch.models.osc import (CASSIE, HUMANOID,
                                             generate_osc_batch,
                                             generate_osc_sequence)
    from fcc_qp_tpu_torch.ops import pallas_admm as pa
    from fcc_qp_tpu_torch.utils.io import stack_qp_dicts

    pa.build_kernels()
    out = {}

    def time_it(name, fn, args, kw):
        out[name] = cs.time_cuda(lambda: fn(*args, **kw), reps=20)[0]

    full = T.FCCQPOptions(**cs.FULL_OPTS)
    qp = T.to_ds_batch(stack_qp_dicts(generate_osc_batch(CASSIE, cs.B,
                                                         seed=0)))
    _, rec = cs.recorded_full(
        eng, lambda: T.solve_batched_ds(qp, CASSIE.shape, full))
    time_it("full_first", pa.admm_chunk_full_f64, *rec.first)
    time_it("full_tail", pa.admm_chunk_full_f64, *rec.last)
    bench = T.FCCQPOptions(
        max_iter=3000, rho=0.05, eps_fcone=1e-6, eps_bound=1e-6,
        presolve="operator", scaling=True, splitting="constrained",
        kkt_refine_steps=1, polish=True, polish_rounds=4,
        polish_newton_steps=CASSIE.polish_newton_steps)
    _, rb = cs.recorded_solve(
        eng, lambda: T.solve_batched_ds(qp, CASSIE.shape, bench))
    _, rt = cs.recorded_solve(eng, lambda: T.solve_batched_ds(
        qp, CASSIE.shape, bench.replace(polish=False, phase1_tol=1e-2)))
    for name in ("admm_chunk_f64", "admm_chunk_f32"):
        time_it(name + "_first", getattr(pa, name), *rt[name].first)
        time_it(name + "_tail", getattr(pa, name), *rb[name].last)
    one = generate_osc_sequence(CASSIE, 1, seed=0)[0]
    q1 = T.QPBatch(**{k: torch.tensor(v)[None] for k, v in one.items()})
    _, r1 = cs.recorded_full(solver_mod, lambda: T.solve_batched(
        q1, CASSIE.shape, T.FCCQPOptions(**cs.DROPIN_OPTS)))
    time_it("full_b1", pa.admm_chunk_full_f64, *r1.first)
    hq = T.to_ds_batch(stack_qp_dicts(generate_osc_batch(
        HUMANOID, cs.HUMANOID_B, seed=0)))
    _, rh = cs.recorded_full(
        eng, lambda: T.solve_batched_ds(hq, HUMANOID.shape, full))
    time_it("full_n76", pa.admm_chunk_full_f64, *rh.first)
    print("TIMES", label, json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
