#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`fcc_qp_tpu_torch`) on one card.

    python3 chip_smoke.py

from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit. It imports nothing of JAX or of the JAX package. Phases
(any failure exits non-zero, and nothing is caught):

1. Build both ADMM chunk kernels from `fcc_qp_tpu_torch/csrc` (nvcc,
   sm_90a) and print the build seconds, the compiler's register report
   (which must show no stack frame and no spills in any instantiation)
   and the card's name and power limit.
2. Main path: a cold batched Cassie solve, B=8192
   (`generate_osc_batch(CASSIE, 8192, seed=0)` -> `to_ds_batch` ->
   `solve_batched_ds`) at the bench flags (polish on, 4 rounds), run
   once to warm up, three times timed (kernel launches counted over the
   first; solves/s from the median) and once with per-stage times
   (a synchronize per stage). Checks: no
   kFactorizationFailed, kSuccess >= 99%, residuals <= 1e-6 and
   equality residuals <= 1e-8 on every kSuccess instance.
3. Endgame path: the same batch with polish off and phase1_tol=1e-2
   (the two-phase path), which sends every instance through the f64
   endgame kernel. Checks: no kFactorizationFailed, kSuccess >= 90%,
   residuals <= 1e-6 on kSuccess; both kernels launched over 2 and 3.
4. Kernel vs plain on the card, in three cases per kernel: the inputs
   of its first chunk in phase 3 (every instance active), of its last
   chunk in a recorded bench-flag solve (the stragglers), and of its
   first chunk in a two-phase solve of `generate_osc_batch(HUMANOID,
   1024, seed=0)` (k = 47 constrained rows, the kernels' two-slot
   layout; only agreement is checked there). Each case goes through the
   kernel and its plain PyTorch version: done / n_iter / itv must be
   equal and the state within 1e-6 (f32) or 1e-12 (f64). Both are timed
   with CUDA events (`time_cuda`), and each case's bound is computed
   from its inputs (`chunk_bound`).
5. One JSON line with a record per kernel (the first chunk's numbers
   under the plain keys, the straggler chunk's under ``*_tail``, the
   humanoid's under ``*_k47``; ``ms_idle`` is a launch on the straggler
   inputs with every instance done), the `nvidia-smi` line, and the
   final JSON status line.

Also printed: the bench solve's host seconds per chunk (the approach and
endgame stage seconds over their launches), beside the kernels' own
time per launch.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
B = 8192
# NVIDIA H100 SXM data sheet: HBM3 rate, FP64 and FP32 vector peaks
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f64": 34e12, "f32": 67e12}
# about 0.5 ms of spin per timed call at the H100's 1.98 GHz boost clock
SPIN_CYCLES_PER_CALL = 1_000_000


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def summarize(tag, sol, launches, wall, stages):
    import numpy as np

    d = sol.details
    st = d.solve_status.cpu().numpy()
    ok = st == 0
    q = lambda t: t.cpu().numpy()
    n_iter, nf, nd = q(d.n_iter), q(d.n_iter_f32), q(d.n_iter_ds)
    acc, att = q(d.polish_accepted), q(d.polish_attempts)
    log(f"[{tag}] kSuccess {ok.sum()}/{len(st)} = {ok.mean():.4%}; "
        f"kMaxIterations {(st == 1).sum()}; kFactorizationFailed "
        f"{(st == 2).sum()}")
    log(f"[{tag}] polish accepted {acc.mean():.4%}, attempts mean "
        f"{att.mean():.4f}")
    for name, a in (("n_iter", n_iter), ("n_iter_f32", nf), ("n_iter_ds", nd)):
        log(f"[{tag}] {name}: p50 {np.median(a):.0f}, max {a.max()}")
    log(f"[{tag}] wall {wall:.6f} s, solves/s {len(st) / wall:.1f}; "
        f"factorization_time {float(d.factorization_time[0]):.6f} s of "
        f"solve_time {float(d.solve_time[0]):.6f} s")
    log(f"[{tag}] stage seconds: " + json.dumps(stages))
    log(f"[{tag}] launches: " + json.dumps(launches))
    res = np.maximum(q(d.admm_residual_bounds),
                     q(d.admm_residual_friction_cone))
    return ok, st, res, q(d.equality_viol)


class Recorder:
    """Wraps a kernel wrapper in the engine's namespace and keeps a copy
    of the inputs of its first and of its last call."""

    def __init__(self, fn):
        self.fn = fn
        self.first = None
        self.last = None

    def __call__(self, *args, **kw):
        import torch

        clone = lambda a: a.clone() if isinstance(a, torch.Tensor) else a
        self.last = (
            tuple(clone(a) for a in args),
            {k: clone(v) for k, v in kw.items()},
        )
        if self.first is None:
            self.first = self.last
        return self.fn(*args, **kw)


def recorded_solve(engine, solve):
    """Runs ``solve()`` with both kernel wrappers of the engine wrapped in
    a `Recorder`; returns ``(result, {name: recorder})``."""
    rec = {name: Recorder(getattr(engine, name))
           for name in ("admm_chunk_f32", "admm_chunk_f64")}
    for name, r in rec.items():
        setattr(engine, name, r)
    try:
        out = solve()
    finally:
        for name, r in rec.items():
            setattr(engine, name, r.fn)
    return out, rec


def check_ptxas(log_text: str) -> None:
    """Every kernel instantiation keeps its state in registers: the
    compiler reports no stack frame and no spills."""
    import re

    props = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                       r"(\d+) bytes spill loads", log_text)
    check(len(props) > 0, "no ptxas resource report in the build log")
    for frame, st, ld in props:
        check((frame, st, ld) == ("0", "0", "0"),
              f"ptxas: {frame} bytes stack frame, {st} / {ld} bytes spill "
              f"stores / loads")


def time_cuda(fn, reps):
    """Device milliseconds per call of ``fn`` over ``reps`` calls after
    one warm-up call, with CUDA events on the current stream, and the
    host's milliseconds per call to issue them. A spin kernel queued
    ahead of the start event holds the card while the host queues the
    calls, so for work that does not wait on the host the span is the
    calls' device time and not the host's time to issue them (that holds
    while the host issues faster than the spin lasts, about 0.5 ms a
    call)."""
    import torch

    from fcc_qp_tpu_torch.utils.timing import cuda_span

    fn()
    torch.cuda.synchronize()
    out = {}
    torch.cuda._sleep(SPIN_CYCLES_PER_CALL * reps)
    t0 = time.perf_counter()
    with cuda_span(out, "ms"):
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
    return out["ms"] / reps, host_ms / reps


def chunk_bound(args, kw, out, prec):
    """The least time the card could take for one chunk on these inputs,
    in ms, and what bounds it. Bytes: the operator and per-instance data
    of the instances that iterate, plus the state in and out of every
    instance, each read or written once. Operations: (2k^2 + 16k + 12
    ncones) flops per instance-iteration actually run."""
    k, Bn = args[8].shape
    kb = kw["kb"]
    ncones = (k - kb) // 3
    word = args[8].element_size()
    itv_in = args[14]
    active = int((out[6] > itv_in).sum())
    iters = int((out[6] - itv_in).sum())
    per_active = (k * k + 2 * k + 2 * kb + ncones + 1) * word
    state = (4 * k + 4) * word + 3 * 4
    nbytes = active * per_active + 2 * Bn * state
    flops = iters * (2 * k * k + 16 * k + 12 * ncones)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[prec]
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                active=active, iters=iters, k=k, B=Bn)


def compare(name, case, kernel, plain, args, kw, prec):
    """Kernel vs plain version on the same inputs: counters equal, state
    within the tolerance; both timed. Returns a record."""
    import torch

    out_k = kernel(*args, **kw)
    torch.cuda.synchronize()
    out_p = plain(*args, **kw)
    torch.cuda.synchronize()
    names = ("x", "s", "mu", "v", "done", "n_iter", "itv",
             "xrn", "lrn", "prim", "dual")
    tol = 1e-6 if prec == "f32" else 1e-12
    max_err = 0.0
    for n, a, b in zip(names, out_k, out_p):
        if n in ("done", "n_iter", "itv"):
            check(torch.equal(a, b),
                  f"{name} [{case}]: {n} differs from the plain version")
        elif n in ("x", "s", "mu", "v"):
            err = float((a - b).abs().max())
            max_err = max(max_err, err)
            check(err <= tol,
                  f"{name} [{case}]: {n} max |diff| {err:.3e} > {tol:.0e}")
        else:
            rel = float(((a - b).abs() / (1.0 + b.abs())).max())
            check(rel <= 10 * tol, f"{name} [{case}]: {n} rel diff {rel:.3e}")
    bound = chunk_bound(args, kw, out_k, prec)
    ms, issue_ms = time_cuda(lambda: kernel(*args, **kw), reps=20)
    plain_ms, _ = time_cuda(lambda: plain(*args, **kw), reps=3)
    longest = int((out_k[6] - args[14]).max())
    Fj = args[0]
    log(f"[kernel] {name} [{case}]: k={bound['k']} B={bound['B']} "
        f"K={kw['K']} active {bound['active']}, iterations run "
        f"{bound['iters']} (longest {longest}), max |diff| {max_err:.3e}, "
        f"kernel {ms:.6f} ms (host issue {issue_ms:.6f} ms per call), "
        f"plain {plain_ms:.6f} ms, bound {bound['bound_ms']:.6f} ms "
        f"({bound['bound_by']}); F "
        f"{Fj.numel() * Fj.element_size() / 1e6:.1f} MB")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                longest=longest, **bound)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "fcc_qp_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(fcc_qp_tpu_torch/ not found beside this script)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)

    import numpy as np

    import fcc_qp_tpu_torch.core.ds_engine as engine
    from fcc_qp_tpu_torch import FCCQPOptions, solve_batched_ds, to_ds_batch
    from fcc_qp_tpu_torch.models.osc import (CASSIE, HUMANOID,
                                             generate_osc_batch)
    from fcc_qp_tpu_torch.ops import pallas_admm
    from fcc_qp_tpu_torch.utils.io import stack_qp_dicts

    check(not any(m == "jax" or m.startswith(("jax.", "fcc_qp_tpu."))
                  for m in sys.modules), "JAX or the JAX package was imported")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")

    # 1. build and device
    pallas_admm.build_kernels()
    info = pallas_admm.build_info
    log(f"[build] {info['library']} in {info['seconds']:.2f} s")
    for line in info.get("log", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[build] {line.strip()}")
    if info.get("log"):
        check_ptxas(info["log"])
    card = smi_line()
    log(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. main path at the bench flags
    t0 = time.perf_counter()
    stacked = stack_qp_dicts(generate_osc_batch(CASSIE, B, seed=0))
    qp = to_ds_batch(stacked)
    log(f"[data] Cassie B={B} generated and moved in "
        f"{time.perf_counter() - t0:.2f} s")
    bench = FCCQPOptions(
        max_iter=3000, rho=0.05, eps_fcone=1e-6, eps_bound=1e-6,
        presolve="operator", scaling=True, splitting="constrained",
        kkt_refine_steps=1, kkt_factor="hybrid", lazy_exact=True,
        polish=True, polish_rounds=4,
        polish_newton_steps=CASSIE.polish_newton_steps,
        adaptive_rho=False, alpha=1.0,
    )
    t0 = time.perf_counter()
    solve_batched_ds(qp, CASSIE.shape, bench)
    torch.cuda.synchronize()
    log(f"[bench] warm-up solve {time.perf_counter() - t0:.3f} s")

    pallas_admm.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol, _ = solve_batched_ds(qp, CASSIE.shape, bench)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_bench = {fn.__name__: fn.launches for fn in pallas_admm.KERNELS}
    # two more timed solves for the spread; solves/s uses the median
    walls = [wall]
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve_batched_ds(qp, CASSIE.shape, bench)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    log("[bench] timed walls (s): " + json.dumps(walls))
    wall = sorted(walls)[1]
    stages = {}
    solve_batched_ds(qp, CASSIE.shape, bench, stage_times=stages)
    ok, st, res, eqv = summarize("bench", sol, launches_bench, wall, stages)
    check((st != 2).all(), "kFactorizationFailed in the bench-flag solve")
    check(ok.mean() >= 0.99, f"kSuccess {ok.mean():.4%} < 99%")
    check((res[ok] <= 1e-6).all(), "kSuccess residual above 1e-6")
    # equality residual bar: 1e-8 relative to the row data, the scale at
    # which the reference's own endgame instances land (see ROADMAP.md
    # queue C); polish-accepted instances must meet it absolutely
    b_eq = np.abs(stacked["b_eq"]).max(axis=1)
    acc = sol.details.polish_accepted.cpu().numpy() > 0
    check((eqv[ok] <= 1e-8 * (1.0 + b_eq[ok])).all(),
          f"relative equality residual above 1e-8 on kSuccess")
    check((eqv[ok & acc] <= 1e-8).all(),
          f"equality residual above 1e-8 on a polish-accepted instance")
    log(f"[bench] max residual (kSuccess) {res[ok].max():.3e}; max "
        f"equality_viol kSuccess {eqv[ok].max():.3e}, all {eqv.max():.3e}")
    check(np.isfinite(sol.z.cpu().numpy()).all()
          and tuple(sol.z.shape) == (B, CASSIE.shape.num_vars),
          "solution not finite or of the wrong shape")
    # does the host set the pace of a chunk? stage seconds per launch
    host_per_chunk = {
        "approach": stages.get("approach", 0.0)
        / max(launches_bench["admm_chunk_f32"], 1),
        "endgame": stages.get("endgame", 0.0)
        / max(launches_bench["admm_chunk_f64"], 1),
    }
    log("[bench] host seconds per chunk (staged stage seconds / launches): "
        + json.dumps(host_per_chunk))
    # one more bench solve, not counted, that keeps each kernel's inputs:
    # its last chunk is a straggler chunk
    _, rec_bench = recorded_solve(
        engine, lambda: solve_batched_ds(qp, CASSIE.shape, bench))

    # 3. two-phase path through the f64 endgame kernel (its wall includes
    # the recorder's copies of every chunk's inputs)
    two_phase = bench.replace(polish=False, phase1_tol=1e-2)
    pallas_admm.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stages2 = {}
    (sol2, _), rec_tp = recorded_solve(
        engine, lambda: solve_batched_ds(qp, CASSIE.shape, two_phase,
                                         stage_times=stages2))
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    launches_tp = {fn.__name__: fn.launches for fn in pallas_admm.KERNELS}
    ok2, st2, res2, _ = summarize("two_phase", sol2, launches_tp, wall2,
                                  stages2)
    check((st2 != 2).all(), "kFactorizationFailed in the two-phase solve")
    check(ok2.mean() >= 0.90, f"two-phase kSuccess {ok2.mean():.4%} < 90%")
    check((res2[ok2] <= 1e-6).all(), "two-phase kSuccess residual above 1e-6")
    for fn in pallas_admm.KERNELS:
        total = launches_bench[fn.__name__] + launches_tp[fn.__name__]
        check(total > 0, f"{fn.__name__} was never launched")

    # humanoid (k = 47 > 32): the kernels' two-slot layout. Its
    # convergence is not checked (it fails in the reference itself).
    hqp = to_ds_batch(stack_qp_dicts(generate_osc_batch(HUMANOID, 1024,
                                                        seed=0)))
    k_h = len(engine.constrained_indices(hqp, HUMANOID.shape))
    check(k_h > 32, f"humanoid has k = {k_h} constrained rows, not > 32")
    t0 = time.perf_counter()
    _, rec_h = recorded_solve(
        engine, lambda: solve_batched_ds(hqp, HUMANOID.shape, two_phase))
    torch.cuda.synchronize()
    log(f"[humanoid] B=1024 two-phase solve, k={k_h}, "
        f"{time.perf_counter() - t0:.3f} s (recorded)")

    # 4. kernel vs plain version on the card (launches not counted)
    specs = (
        ("admm_chunk_f64", pallas_admm.admm_chunk_f64,
         pallas_admm.admm_chunk_f64_plain, "f64",
         "fcc_qp_tpu/ops/pallas_admm.py:445"),
        ("admm_chunk_f32", pallas_admm.admm_chunk_f32,
         pallas_admm.admm_chunk_f32_plain, "f32",
         "fcc_qp_tpu/ops/pallas_admm.py:595"),
    )
    cases = (("first", rec_tp, "first"), ("tail", rec_bench, "last"),
             ("k47", rec_h, "first"))
    records = []
    for name, kernel, plain, prec, replaces in specs:
        r = {}
        for case, rec, which in cases:
            got = getattr(rec[name], which)
            check(got is not None, f"{name}: no {case} chunk captured")
            r[case] = compare(name, case, kernel, plain, *got, prec)
        first, tail, k47 = r["first"], r["tail"], r["k47"]
        check(tail["active"] > 0, f"{name}: no instance iterates in the "
              f"bench path's last chunk")
        # the launch's fixed cost: the same inputs with every instance
        # done, which every warp copies through; the rest of the straggler
        # chunk is the longest instance's chain of iterations
        args, kw = rec_bench[name].last
        idle = list(args)
        idle[12] = torch.ones_like(args[12])
        ms_idle, _ = time_cuda(lambda: kernel(*idle, **kw), reps=20)
        us_per_it = (tail["ms"] - ms_idle) * 1e3 / max(tail["longest"], 1)
        log(f"[kernel] {name}: launch with every instance done "
            f"{ms_idle:.6f} ms; straggler chunk {us_per_it:.3f} us per "
            f"iteration of its longest instance ({tail['longest']})")
        records.append(dict(
            name=name, route="cuda",
            source="fcc_qp_tpu_torch/csrc/admm_chunk.cu",
            replaces=replaces,
            launches=launches_bench[name] + launches_tp[name],
            launches_bench=launches_bench[name],
            launches_two_phase=launches_tp[name],
            max_abs_err=first["max_abs_err"], ms=first["ms"],
            plain_ms=first["plain_ms"], bound_ms=first["bound_ms"],
            bound_by=first["bound_by"], library_ms=None,
            ms_tail=tail["ms"], plain_ms_tail=tail["plain_ms"],
            bound_ms_tail=tail["bound_ms"], bound_by_tail=tail["bound_by"],
            active_tail=tail["active"], max_abs_err_tail=tail["max_abs_err"],
            ms_idle=ms_idle, us_per_iteration_tail=us_per_it,
            ms_k47=k47["ms"], plain_ms_k47=k47["plain_ms"],
            bound_ms_k47=k47["bound_ms"], active_k47=k47["active"],
            max_abs_err_k47=k47["max_abs_err"],
        ))

    # 5. result lines
    print(json.dumps({"kernels": records}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
