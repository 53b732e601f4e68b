#!/usr/bin/env python3
"""CPU reference numbers for the reference-semantics path of the port.

    python3 exp_full_reference.py [--skip-port]

Runs, on the CPU, the JAX package (the reference) and the PyTorch port
(its kernels' plain versions) on the inputs of `chip_smoke.py`'s phases 6
and 7, and prints the numbers those phases are held to:

1. the full-splitting engine (`solve_batched_ds` at the package defaults'
   path: full splitting, exact presolve, adaptive rho;
   `chip_smoke.FULL_OPTS`) on the first 512 instances of
   `generate_osc_batch(CASSIE, 8192, seed=0)`: the kSuccess share, the
   n_iter p50 and max, and how many instances' n_iter differ between the
   two packages;
2. the drop-in replay: `FCCQP(60, 38, 12, 38)` over
   `generate_osc_sequence(CASSIE, 200, seed=0)` with
   ``set_warm_start(i > 0)`` on the f64 engine (the README quick-start
   options) and on the ds engine (the same with rho = 0.05): the status
   counts per engine;
3. the humanoid (n = 76): the full-splitting engine at
   `chip_smoke.FULL_OPTS` on the first 64 instances of
   `generate_osc_batch(HUMANOID, 1024, seed=0)`, and the drop-in
   `FCCQP(76, 41, 24, 52)` on the f64 engine over
   `generate_osc_sequence(HUMANOID, 20, seed=0)` at
   `chip_smoke.HUMANOID_DROPIN_OPTS`: kSuccess shares and status counts.

Takes a few minutes (the JAX programs compile first). Needs the JAX
package's test environment: XLA on the CPU with x64 and the SSE4.2 pin
that its double-single arithmetic needs (set here before JAX loads).
"""

import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_cpu_max_isa=SSE4_2").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
import fcc_qp_tpu as J  # noqa: E402
from fcc_qp_tpu.core.ds_engine import solve_batched_ds, to_ds_batch  # noqa: E402
from fcc_qp_tpu.models.osc import (CASSIE, HUMANOID,  # noqa: E402
                                   generate_osc_batch, generate_osc_sequence)
from fcc_qp_tpu.utils.io import stack_qp_dicts  # noqa: E402

KEYS = ("Q", "b", "A_eq", "b_eq", "friction_coeffs", "lb", "ub")


def full_batch(port: bool, model=CASSIE, B=chip_smoke.B, first=512):
    st = stack_qp_dicts(generate_osc_batch(model, B, seed=0))
    st = {k: v[:first] for k, v in st.items()}
    t0 = time.perf_counter()
    sol, _ = solve_batched_ds(to_ds_batch(st), model.shape,
                              J.FCCQPOptions(**chip_smoke.FULL_OPTS))
    n = np.asarray(sol.details.n_iter)
    ok = np.asarray(sol.details.solve_status) == 0
    tag = f"[full:{model.name}]"
    print(f"{tag} JAX, first {first} of B={B}: kSuccess {ok.sum()}"
          f"/{first} = {ok.mean():.6f}; n_iter p50 {np.median(n):.0f}, max "
          f"{n.max()} ({time.perf_counter() - t0:.1f} s)", flush=True)
    if port:
        import fcc_qp_tpu_torch as T

        tsol, _ = T.solve_batched_ds(
            T.to_ds_batch(st, device="cpu"),
            T.ProblemShape(*(getattr(model.shape, f) for f in (
                "num_vars", "num_eq", "nc", "lambda_c_start"))),
            T.FCCQPOptions(**chip_smoke.FULL_OPTS), device="cpu")
        tn = tsol.details.n_iter.numpy()
        tok = tsol.details.solve_status.numpy() == 0
        print(f"{tag} port (plain versions on the CPU): kSuccess "
              f"{tok.sum()}/{first} = {tok.mean():.6f}; n_iter differs from "
              f"JAX on {(tn != n).sum()} instances "
              f"{np.where(tn != n)[0].tolist()[:16]}", flush=True)


def dropin(port: bool, model=CASSIE, steps=chip_smoke.DROPIN_STEPS,
           runs=(("f64", chip_smoke.DROPIN_OPTS),
                 ("ds", dict(chip_smoke.DROPIN_OPTS,
                             rho=chip_smoke.DROPIN_DS_RHO)))):
    seq = generate_osc_sequence(model, steps, seed=0)
    sh = model.shape
    dims = (sh.num_vars, sh.num_eq, sh.nc, sh.lambda_c_start)
    pkgs = [("JAX", J)]
    if port:
        import fcc_qp_tpu_torch as T

        pkgs.append(("port", T))
    for engine, opts in runs:
        for name, pkg in pkgs:
            kw = {} if pkg is J else dict(device="cpu")
            s = pkg.FCCQP(*dims, engine=engine, **kw)
            s.set_options(pkg.FCCQPOptions(**opts))
            st, n = [], []
            t0 = time.perf_counter()
            for i, qp in enumerate(seq):
                s.set_warm_start(i > 0)
                s.Solve(*(qp[k] for k in KEYS))
                r = s.GetSolution()
                st.append(r.details.solve_status)
                n.append(r.details.n_iter)
            st, n = np.array(st), np.array(n)
            print(f"[dropin:{model.name}:{engine}] {name}: kSuccess "
                  f"{(st == 0).sum()}, "
                  f"kMaxIterations {(st == 1).sum()}, kFactorizationFailed "
                  f"{(st == 2).sum()}; n_iter p50 {np.median(n):.0f}, max "
                  f"{n.max()} ({time.perf_counter() - t0:.1f} s)",
                  flush=True)


if __name__ == "__main__":
    port = "--skip-port" not in sys.argv
    full_batch(port)
    dropin(port)
    full_batch(port, HUMANOID, chip_smoke.HUMANOID_B, 64)
    dropin(port, HUMANOID, chip_smoke.HUMANOID_DROPIN_STEPS,
           (("f64", chip_smoke.HUMANOID_DROPIN_OPTS),))
