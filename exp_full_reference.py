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

4. the humanoid's full engine on instances 608-639 (the card leaves
   instance 614 at the 2000-iteration cap) and on all 1024: the
   instances either package leaves unconverged, and where statuses or
   n_iter differ;
5. the humanoid's reduced two-phase path with ``splitting="full"`` (k =
   76) on the first 64 instances, as `chip_smoke.py` phase 9 runs it:
   kSuccess shares, statuses and n_iter;
6. the options this slice added, each on the first 512 instances of
   `generate_osc_batch(CASSIE, 8192, seed=0)`: over-relaxation (alpha =
   1.6) at the bench flags and at `chip_smoke.FULL_OPTS`; the bench
   flags with ``--adaptive-rho`` (`chip_smoke.ADAPTIVE`); the batch-level
   engine `solve_batched_fast` at `chip_smoke.FAST_OPTS` and
   `chip_smoke.FAST_ALPHA_OPTS`; and the parity engine on f32 data at
   `chip_smoke.F32_OPTS` (``bench.py --engine f32``).
7. the bench entry point's bars (`fcc_qp_tpu_torch.bench`, `chip_smoke.py`
   phase 18), per model at the bench flags with the model's polish Newton
   steps, on the bench's walking log (`generate_osc_sequence(model,
   65536, seed=0, smoothness=0.002)`): the cold solve of its first 512
   steps (the first 512 instances of the bench's cold batch) and the
   replay of its steps 0-1023 as 64 streams x 16 steps (the first 64
   streams of the bench's 4096-stream replay): kSuccess shares, the warm
   polish acceptance and the warm n_iter p50, with the port's plain
   versions compared status by status and n_iter by n_iter.
8. the walking-log example (`examples/replay_walking_torch.py`,
   `chip_smoke.py` phase 19) at its default options, on
   `generate_osc_sequence(CASSIE, steps, seed=0)`: the drop-in loop over
   400 steps (status counts and n_iter) and the batched solve of 400 and
   of 8192 steps (kSuccess counts).
9. the quadruped's cold instance 456 (the one whose status differed
   between the packages on the bench log's first 512 steps): its
   approach (f32) and endgame n_iter, polish attempts and acceptance and
   status in both packages, in the batch of 512 and alone.

    python3 exp_full_reference.py [--skip-port] [section ...]

runs the named sections (``full``, ``dropin``, ``humanoid``,
``humanoid614``, ``humanoid1024``, ``humanoid_reduced``,
``humanoid_reduced1024`` (the same on all 1024), ``alpha``,
``adaptive``, ``fast``, ``f32``, ``f32_8192`` (the same on all 8192),
``bench_cassie``, ``bench_quadruped``, ``bench_humanoid``,
``bench_cassie8192``, ``bench_quadruped8192``, ``bench_humanoid8192``
(the JAX package's cold solve of the model's whole cold batch),
``example_loop``, ``example_batched``, ``example_batched8192``,
``quad456``), all of them by default.

Takes minutes per section (the JAX programs compile first). Needs the JAX
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
from fcc_qp_tpu.models.osc import (CASSIE, HUMANOID, MODELS,  # noqa: E402
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


def _tshape(model):
    import fcc_qp_tpu_torch as T

    return T.ProblemShape(*(getattr(model.shape, f) for f in (
        "num_vars", "num_eq", "nc", "lambda_c_start")))


def _compare(tag, jsol, tsol, first):
    """Print both packages' kSuccess counts, and where statuses and n_iter
    differ."""
    js = np.asarray(jsol.details.solve_status)
    jn = np.asarray(jsol.details.n_iter)
    print(f"{tag} JAX: kSuccess {(js == 0).sum()}/{first} = "
          f"{(js == 0).mean():.6f}; n_iter p50 {np.median(jn):.0f}, max "
          f"{jn.max()}; not kSuccess at {np.where(js != 0)[0].tolist()[:16]}",
          flush=True)
    if tsol is None:
        return
    ts = tsol.details.solve_status.numpy()
    tn = tsol.details.n_iter.numpy()
    dz = float(np.abs(np.asarray(jsol.z) - tsol.z.numpy()).max())
    print(f"{tag} port (plain versions on the CPU): kSuccess "
          f"{(ts == 0).sum()}/{first} = {(ts == 0).mean():.6f}; not "
          f"kSuccess at {np.where(ts != 0)[0].tolist()[:16]}; statuses "
          f"differ on {np.where(ts != js)[0].tolist()[:16]}; n_iter differs "
          f"on {(tn != jn).sum()} instances {np.where(tn != jn)[0].tolist()[:16]}"
          f" (|dn| max {np.abs(tn.astype(int) - jn).max()}); max |dz| "
          f"{dz:.3e}", flush=True)


def ds_options(port: bool, tag, opts, model=CASSIE, B=chip_smoke.B,
               first=512):
    """`solve_batched_ds` in both packages on the first ``first`` (or the
    ``(lo, hi)`` window) of `generate_osc_batch(model, B, seed=0)` at
    ``opts`` (a dict)."""
    st = stack_qp_dicts(generate_osc_batch(model, B, seed=0))
    lo, hi = first if isinstance(first, tuple) else (0, first)
    st = {k: v[lo:hi] for k, v in st.items()}
    first = hi - lo
    t0 = time.perf_counter()
    jsol, _ = solve_batched_ds(to_ds_batch(st), model.shape,
                               J.FCCQPOptions(**opts), timing=False)
    print(f"{tag} JAX solve {time.perf_counter() - t0:.1f} s", flush=True)
    tsol = None
    if port:
        import fcc_qp_tpu_torch as T

        tsol, _ = T.solve_batched_ds(T.to_ds_batch(st, device="cpu"),
                                     _tshape(model), T.FCCQPOptions(**opts),
                                     device="cpu")
    _compare(tag, jsol, tsol, first)


def fast_options(port: bool, tag, opts, first=512, dtype=None):
    """`solve_batched_fast` (or, with ``dtype`` f32, the parity engine's
    `solve_batched` on f32 data) in both packages on the first ``first``
    of `generate_osc_batch(CASSIE, 8192, seed=0)`."""
    import jax.numpy as jnp

    from fcc_qp_tpu.utils.io import to_qpbatch

    st = stack_qp_dicts(generate_osc_batch(CASSIE, chip_smoke.B, seed=0))
    st = {k: v[:first] for k, v in st.items()}
    t0 = time.perf_counter()
    if dtype == "f32":
        jsol, _ = J.solve_batched(to_qpbatch(st, dtype=jnp.float32),
                                  CASSIE.shape, J.FCCQPOptions(**opts),
                                  timing=False)
    else:
        jsol, _ = J.solve_batched_fast(to_qpbatch(st), CASSIE.shape,
                                       J.FCCQPOptions(**opts))
    print(f"{tag} JAX solve {time.perf_counter() - t0:.1f} s", flush=True)
    tsol = None
    if port:
        import torch

        import fcc_qp_tpu_torch as T
        from fcc_qp_tpu_torch.utils.io import to_qpbatch as tq

        torch.set_num_threads(4)
        if dtype == "f32":
            tsol, _ = T.solve_batched(tq(st, dtype=torch.float32,
                                         device="cpu"), _tshape(CASSIE),
                                      T.FCCQPOptions(**opts), device="cpu")
        else:
            tsol, _ = T.solve_batched_fast(tq(st, device="cpu"),
                                           _tshape(CASSIE),
                                           T.FCCQPOptions(**opts),
                                           device="cpu")
    _compare(tag, jsol, tsol, first)


# the bench's walking log (bench.py defaults: 4096 streams x 16 steps) and
# the subsets its bars are taken on
BENCH_T, BENCH_COLD, BENCH_STREAMS, BENCH_STEPS = 65536, 512, 64, 16


def _warm_stats(sols, streams, steps):
    """kSuccess share, warm polish acceptance and warm n_iter p50 of a
    replay's solutions (global time order)."""
    st = np.asarray(sols.details.solve_status)
    n = np.asarray(sols.details.n_iter).reshape(streams, steps)
    acc = np.asarray(sols.details.polish_accepted).reshape(streams, steps)
    return st, n, acc, ((st == 0).mean(), acc[:, 1:].mean(),
                        np.median(n[:, 1:]))


def bench_cold_reference(model):
    """Section 7, the whole cold batch: the JAX package's cold solve of the
    bench walking log's first 8192 steps at the bench flags."""
    qps = generate_osc_sequence(model, BENCH_T, seed=0, smoothness=0.002)
    st = stack_qp_dicts(qps[:chip_smoke.B])
    del qps
    t0 = time.perf_counter()
    jsol, _ = solve_batched_ds(
        to_ds_batch(st), model.shape,
        J.FCCQPOptions(**chip_smoke.BENCH_OPTS,
                       polish_newton_steps=model.polish_newton_steps),
        timing=False)
    print(f"[bench:{model.name}] JAX cold solve of {chip_smoke.B} "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    _compare(f"[bench:{model.name}] cold, all {chip_smoke.B}:", jsol, None,
             chip_smoke.B)


def bench_reference(port: bool, model):
    """Section 7: the JAX package (and the port's plain versions) at the
    bench flags on the subsets of the bench's walking log that
    `chip_smoke.py` phase 18 holds the card to."""
    from fcc_qp_tpu.core.ds_engine import replay_ds_streams

    tag = f"[bench:{model.name}]"
    t0 = time.perf_counter()
    # the actuator bounds are a quantile over the whole log, so the subset
    # is cut from the bench's full-length log; only the subset is stacked
    qps = generate_osc_sequence(model, BENCH_T, seed=0, smoothness=0.002)
    n_rep = BENCH_STREAMS * BENCH_STEPS
    st = stack_qp_dicts(qps[:max(n_rep, BENCH_COLD)])
    del qps
    print(f"{tag} walking log T={BENCH_T} generated in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    opts = dict(chip_smoke.BENCH_OPTS,
                polish_newton_steps=model.polish_newton_steps)
    cold = {k: v[:BENCH_COLD] for k, v in st.items()}
    rep = {k: v[:n_rep] for k, v in st.items()}
    t0 = time.perf_counter()
    jsol, _ = solve_batched_ds(to_ds_batch(cold), model.shape,
                               J.FCCQPOptions(**opts), timing=False)
    print(f"{tag} JAX cold solve {time.perf_counter() - t0:.1f} s; polish "
          f"accepted {np.asarray(jsol.details.polish_accepted).mean():.6f}",
          flush=True)
    t0 = time.perf_counter()
    jrep, _ = replay_ds_streams(to_ds_batch(rep), model.shape,
                                J.FCCQPOptions(**opts),
                                n_streams=BENCH_STREAMS)
    js, jn, jacc, (jok, jwacc, jp50) = _warm_stats(jrep, BENCH_STREAMS,
                                                   BENCH_STEPS)
    print(f"{tag} JAX replay {BENCH_STREAMS} x {BENCH_STEPS} "
          f"({time.perf_counter() - t0:.1f} s): kSuccess {(js == 0).sum()}/"
          f"{n_rep} = {jok:.6f}; warm polish acceptance {jwacc:.6f}; warm "
          f"n_iter p50 {jp50:.0f}; not kSuccess at "
          f"{np.where(js != 0)[0].tolist()[:16]}", flush=True)
    tsol = trep = None
    if port:
        import torch

        import fcc_qp_tpu_torch as T

        torch.set_num_threads(2)
        tsol, _ = T.solve_batched_ds(T.to_ds_batch(cold, device="cpu"),
                                     _tshape(model), T.FCCQPOptions(**opts),
                                     device="cpu")
        trep, _ = T.replay_ds_streams(T.to_ds_batch(rep, device="cpu"),
                                      _tshape(model), T.FCCQPOptions(**opts),
                                      n_streams=BENCH_STREAMS, device="cpu")
    _compare(f"{tag} cold, first {BENCH_COLD}:", jsol, tsol, BENCH_COLD)
    if trep is None:
        return
    ts, tn, tacc, (tok, twacc, tp50) = _warm_stats(trep, BENCH_STREAMS,
                                                   BENCH_STEPS)
    dz = float(np.abs(np.asarray(jrep.z) - trep.z.numpy()).max())
    print(f"{tag} port replay (plain versions on the CPU): kSuccess "
          f"{(ts == 0).sum()}/{n_rep} = {tok:.6f}; warm polish acceptance "
          f"{twacc:.6f}; warm n_iter p50 {tp50:.0f}; statuses differ on "
          f"{np.where(ts != js)[0].tolist()[:16]}; n_iter differs on "
          f"{(tn != jn).sum()} steps {np.where(tn.ravel() != jn.ravel())[0].tolist()[:16]}"
          f"; acceptance differs on {(tacc != jacc).sum()}; max |dz| "
          f"{dz:.3e}", flush=True)


# the walking-log example's options (examples/replay_walking.py:71-102 at
# its defaults): the drop-in loop and the batched solve
EXAMPLE_LOOP_OPTS = dict(rho=0.3, eps_fcone=1e-6, eps_bound=1e-6,
                         max_iter=3000)
EXAMPLE_BATCHED_OPTS = dict(max_iter=3000, rho=0.05, eps_fcone=1e-6,
                            eps_bound=1e-6, scaling=True,
                            splitting="constrained", presolve="operator")


def example_loop(port: bool, steps=400):
    """Section 8: the example's ``--mode loop`` (`dropin` at its
    options)."""
    dropin(port, CASSIE, steps, (("f64", EXAMPLE_LOOP_OPTS),))


def example_batched(port: bool, steps):
    """Section 8: the example's ``--mode batched``: one
    `solve_batched_ds` of the whole synthesized log."""
    st = stack_qp_dicts(generate_osc_sequence(CASSIE, steps, seed=0))
    t0 = time.perf_counter()
    jsol, _ = solve_batched_ds(to_ds_batch(st), CASSIE.shape,
                               J.FCCQPOptions(**EXAMPLE_BATCHED_OPTS),
                               timing=False)
    print(f"[example:batched{steps}] JAX solve "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    tsol = None
    if port:
        import torch

        import fcc_qp_tpu_torch as T

        torch.set_num_threads(2)
        tsol, _ = T.solve_batched_ds(T.to_ds_batch(st, device="cpu"),
                                     _tshape(CASSIE),
                                     T.FCCQPOptions(**EXAMPLE_BATCHED_OPTS),
                                     device="cpu")
    _compare(f"[example:batched{steps}]", jsol, tsol, steps)


QUAD_INSTANCE = 456
TRACE_FIELDS = ("solve_status", "n_iter", "n_iter_f32", "n_iter_ds",
                "polish_attempts", "polish_accepted",
                "admm_residual_bounds", "admm_residual_friction_cone",
                "equality_viol")


def quad_instance(port: bool, i=QUAD_INSTANCE):
    """Section 9: instance ``i`` of the quadruped's bench cold batch, its
    telemetry in the batch of `BENCH_COLD` and alone, in both packages."""
    model = MODELS["quadruped"]
    qps = generate_osc_sequence(model, BENCH_T, seed=0, smoothness=0.002)
    st = stack_qp_dicts(qps[:BENCH_COLD])
    del qps
    opts = dict(chip_smoke.BENCH_OPTS,
                polish_newton_steps=model.polish_newton_steps)
    alone = {k: v[i:i + 1] for k, v in st.items()}
    for part, data in (("batch", st), ("alone", alone)):
        j = i if part == "batch" else 0
        jsol, _ = solve_batched_ds(to_ds_batch(data), model.shape,
                                   J.FCCQPOptions(**opts), timing=False)
        rows = [("JAX", {f: np.asarray(getattr(jsol.details, f))[j]
                         for f in TRACE_FIELDS})]
        if port:
            import torch

            import fcc_qp_tpu_torch as T

            torch.set_num_threads(2)
            tsol, _ = T.solve_batched_ds(T.to_ds_batch(data, device="cpu"),
                                         _tshape(model),
                                         T.FCCQPOptions(**opts),
                                         device="cpu")
            rows.append(("port", {f: getattr(tsol.details, f).numpy()[j]
                                  for f in TRACE_FIELDS}))
        for name, r in rows:
            print(f"[quad{i}:{part}] {name}: " + ", ".join(
                f"{f} {v}" for f, v in r.items()), flush=True)


SECTIONS = {
    "full": lambda port: full_batch(port),
    "dropin": lambda port: dropin(port),
    "humanoid": lambda port: (
        full_batch(port, HUMANOID, chip_smoke.HUMANOID_B, 64),
        dropin(port, HUMANOID, chip_smoke.HUMANOID_DROPIN_STEPS,
               (("f64", chip_smoke.HUMANOID_DROPIN_OPTS),))),
    # the one instance the card leaves at the cap (614), in the window of
    # 32 around it: at FULL_OPTS the 7 adaptation checks stay below the 8
    # rebuilds allowed, so an instance's result does not depend on its batch
    "humanoid614": lambda port: ds_options(
        port, "[humanoid:full_608-639]", chip_smoke.FULL_OPTS, HUMANOID,
        chip_smoke.HUMANOID_B, (608, 640)),
    "humanoid1024": lambda port: ds_options(
        port, "[humanoid1024:full]", chip_smoke.FULL_OPTS, HUMANOID,
        chip_smoke.HUMANOID_B, chip_smoke.HUMANOID_B),
    # the two-phase options of chip_smoke.py phases 3 and 9c
    "humanoid_reduced": lambda port: ds_options(
        port, "[humanoid:reduced_full]",
        dict(chip_smoke.BENCH_OPTS, polish=False, phase1_tol=1e-2,
             splitting="full", polish_newton_steps=HUMANOID.polish_newton_steps),
        HUMANOID, chip_smoke.HUMANOID_B, 64),
    "humanoid_reduced1024": lambda port: ds_options(
        port, "[humanoid:reduced_full_1024]",
        dict(chip_smoke.BENCH_OPTS, polish=False, phase1_tol=1e-2,
             splitting="full", polish_newton_steps=HUMANOID.polish_newton_steps),
        HUMANOID, chip_smoke.HUMANOID_B, chip_smoke.HUMANOID_B),
    "alpha": lambda port: (
        ds_options(port, "[alpha:bench]", dict(
            chip_smoke.BENCH_OPTS, alpha=chip_smoke.ALPHA,
            polish_newton_steps=CASSIE.polish_newton_steps)),
        ds_options(port, "[alpha:full]", dict(
            chip_smoke.FULL_OPTS, alpha=chip_smoke.ALPHA))),
    "adaptive": lambda port: ds_options(port, "[adaptive:bench]", dict(
        chip_smoke.BENCH_OPTS, **chip_smoke.ADAPTIVE,
        polish_newton_steps=CASSIE.polish_newton_steps)),
    "fast": lambda port: (
        fast_options(port, "[fast:adaptive]", chip_smoke.FAST_OPTS),
        fast_options(port, "[fast:alpha]", chip_smoke.FAST_ALPHA_OPTS)),
    "f32": lambda port: fast_options(port, "[f32]", chip_smoke.F32_OPTS,
                                     dtype="f32"),
    # the same on every instance of the card's batch: at eps 1e-6 which
    # instance converges is decided by rounding, so its share is compared
    # over the whole batch, not a sample
    "f32_8192": lambda port: fast_options(port, "[f32:8192]",
                                          chip_smoke.F32_OPTS,
                                          first=chip_smoke.B, dtype="f32"),
    "bench_cassie": lambda port: bench_reference(port, CASSIE),
    "bench_quadruped": lambda port: bench_reference(port, MODELS["quadruped"]),
    "bench_humanoid": lambda port: bench_reference(port, HUMANOID),
    # the JAX package alone on each model's whole cold batch
    **{f"bench_{name}8192": (lambda port, m=m: bench_cold_reference(m))
       for name, m in MODELS.items()},
    "example_loop": example_loop,
    "example_batched": lambda port: example_batched(port, 400),
    "example_batched8192": lambda port: example_batched(port, 8192),
    "quad456": quad_instance,
}


if __name__ == "__main__":
    port = "--skip-port" not in sys.argv
    names = [a for a in sys.argv[1:] if not a.startswith("--")]
    for name in names or SECTIONS:
        SECTIONS[name](port)
