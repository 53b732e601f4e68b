#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`fcc_qp_tpu_torch`) on one card.

    python3 chip_smoke.py

from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit. It imports nothing of JAX or of the JAX package. Phases
(any failure exits non-zero, and nothing is caught):

1. Build the four ADMM chunk kernels from `fcc_qp_tpu_torch/csrc`
   (nvcc, sm_90a) and print the build seconds, the compiler's register
   report (kept beside a cached build; it must name every instantiation
   and show no stack frame and no spills in any; registers per
   instantiation go into the JSON line) and the card's name and power
   limit.
2. Main path: a cold batched Cassie solve, B=8192
   (`generate_osc_batch(CASSIE, 8192, seed=0)` -> `to_ds_batch` ->
   `solve_batched_ds`) at the bench flags (polish on, 4 rounds). The
   first call captures it (`core.graphs.CapturedBatch`; kernel launches
   counted over it, as the graphs are captured) and three timed calls
   replay it (solves/s from the median); printed: the capture's warm-up,
   capture and instantiate seconds, each graph's nodes by type (IF
   bodies included, IF nodes counted), the peak memory allocated, and
   beside the replays the eager (reading) path's median in the same
   call. Then one uncaptured solve with per-stage times (a synchronize
   per stage; it counts the hybrid fallback's calls). Checks: a later
   replay equals the first, and the replays equal the uncaptured static
   solve under cuSOLVER bit for bit and the eager solve by status with
   |dz| <= 1e-9; no static gathered loop ends with work pending (the
   exhausted flag); no kFactorizationFailed, kSuccess >= 99%, residuals
   <= 1e-6 and equality residuals <= 1e-8 on every kSuccess instance.
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
5. Warm replay, the JAX bench's headline: `replay_ds_streams` over the
   bench's walking log (`generate_osc_sequence(CASSIE, 65536, seed=0,
   smoothness=0.002)`) in 4096 streams x 16 steps at the bench flags,
   captured: the first replay captures the cold (step 0) and warm graphs
   (kernel launches counted over it), three timed replays (solves/s from
   the median) beside three of the eager (reading) replay in the same
   call, one uncaptured replay with stage times summed over the warm
   steps (step 0 apart) and one recorded. Printed as in phase 2 per
   capture. Checks: the graph replays equal the uncaptured static
   replay under cuSOLVER bit for bit over its first
   `STATIC_REPLAY_STEPS` steps, and the eager replay by status with
   |dz| <= 1e-9; the exhausted flag clear; no kFactorizationFailed,
   kSuccess >= 99.9%, residuals <= 1e-6 and the equality bars of phase 2
   on kSuccess, warm polish acceptance >= 99%, warm n_iter p50 <= 15, a
   finite (65536, 60) solution, both kernels launched, and the step-0
   rows equal to a cold `solve_batched_ds` of the same 4096 instances
   (status, n_iter, polish acceptance exactly, z to 1e-12); a profiled
   captured replay with no host read and both reduced kernels in its
   trace, and its warm steps profiled alone: no host read, the device's
   busy time and idle share per step (profiled, and against the same
   window's unprofiled wall). Each kernel is then held against its
   plain version on its last chunk of a warm step of an uncaptured
   replay (``*_warm`` keys; the f64 kernel only where a warm step
   launched it).
6. The reference-semantics path: the full-splitting engine (the package
   defaults' path) on the same Cassie batch, B=8192, at `FULL_OPTS`
   (exact presolve, adaptive rho), captured (`captured_path`, below),
   and once staged (uncaptured). Checks: no kFactorizationFailed and no NaN,
   residuals <= 1e-6 on kSuccess, a kSuccess share at least the JAX
   package's on the first 512 instances less 1%, the full-layout kernel
   launched. One more solve under `torch.profiler` sums the kernel's
   device time over its launches, printed beside the `iterate` stage
   (the rest of that stage is the adaptive-rho rebuilds and the host).
   `captured_path`, here and in phases 13 and 14: the entry point's
   first call captures (counted from zero: a wrapper counts while the
   graphs are captured); printed: the capture's warm-up, capture and
   instantiate seconds, nodes by type (IF bodies included, IF nodes
   counted), the hand kernels per graph, the peak memory; three timed
   replays beside three eager (reading) solves in the same call; the
   adaptive-rho rebuild that the graphs hold in IF bodies, captured
   alone and timed (``rebuild_body``). Checks: a later replay equals
   the first, the replays equal the uncaptured static solve under
   cuSOLVER bit for bit and the eager solve by statuses and n_iter with
   |dz| <= 1e-9; the exhausted flag clear; a captured call under
   `torch.profiler` has no host read and the path's full-layout kernel
   in its trace (a trace can lose kernel records: a call whose trace
   holds none is profiled again, up to `PROFILED_CALLS` calls, all of
   them without a host read).
7. The drop-in `FCCQP(60, 38, 12, 38)` over a 200-step walking log, the
   reference loop (``set_warm_start(i > 0)``), on the f64 engine at the
   README quick-start options and on the ds engine with rho = 0.05; on
   the card every `Solve` replays the captured graphs
   (`core.graphs.CapturedSolve`): per-Solve wall p50 / p95, solve and
   factorization time p50, n_iter and statuses. Checks: the graphs
   captured, no kFactorizationFailed, the kSuccess count within two of
   the JAX package's on the CPU, and on every kSuccess step the equality
   residual, bounds and cones; the first 64 steps equal to the eager
   static solve on the card (`CapturedSolve` with graphs off) bit for
   bit (z and every diagnostic); beside them, in the same call, the
   per-Solve wall of the eager solve, the drop-in's solve uncaptured
   (host reads in its loops), over the same 64 steps, whose results the
   replays equal (f64 bit for bit: the captured loop is one launch of
   max_iter iterations, the eager one chunks of 64; ds statuses and
   |dz| <= 1e-9). Printed: how many captures each drop-in made, and
   the capturing Solves' walls apart from the replays'. Then the verify
   notes' probes on both engines.
8. Both reduced kernels against their plain versions at B = 1 (one warp
   in a block of four slots, three of them out of range), on the ds
   drop-in's eager static solve: its first launch (``*_b1`` keys) and
   its last launch in which the instance iterates (``*_b1_last``),
   state and max-norms bit for bit, timed with bounds. The full-layout
   kernel against its plain version on the full solve's
   first and last chunks and one B = 1 launch of the f64 drop-in's eager
   static solve (``max_iter`` iterations in one launch; timed, with
   bounds), on a quadruped chunk whose cone triple
   straddles a warp's two row slots, and on the first (timed, with
   bounds: ``*_generic`` keys, one case per row-slot count) and last
   chunks of random problems whose row counts are no model's
   (`GENERIC_DIMS`): state, counters and max-norms bit for bit, the
   2-norms to 1e-12 relative.
9. The humanoid (n = 76, the kernels' third row slot), each path counted
   from zero: the full engine on `generate_osc_batch(HUMANOID, 1024,
   seed=0)` at `FULL_OPTS` (not cut: no kFactorizationFailed, no NaN,
   kSuccess residuals <= 1e-6, a kSuccess share at least the JAX
   package's on the first 64 less 1%, the kernel launched at n = 76);
   the drop-in `FCCQP(76, 41, 24, 52)` on the f64 engine over a 20-step
   walking log at `HUMANOID_DROPIN_OPTS` (statuses within two of the JAX
   package's, the drop-in step checks); the reduced two-phase path with
   ``splitting="full"`` (both reduced kernels at k = 76; a kSuccess share
   at least the JAX package's on the same 1024 less 1%). Then the
   full-layout kernel on the full engine's first chunk and both reduced
   kernels on the reduced path's first chunk against their plain
   versions, timed with bounds (``*_n76``, ``*_k76`` keys), and each
   kernel's resident blocks per SM.
10. Host IO (`utils.io`): phase 5's 65536-step walking log written as a
   packed ``.fqlog`` into the gitignored ``test_data/``, reloaded bit for
   bit (write and load seconds printed) and removed; the replay's final
   `WarmStartDS` and a parity-engine `WarmStart` saved and reloaded bit
   for bit on the card.
11. Over-relaxation, alpha = 1.6: each kernel against its plain version
   bit for bit on an all-active first chunk (``*_alpha`` keys); a cold
   Cassie solve at the bench flags and one at FULL_OPTS, each held to the
   JAX package's kSuccess share on the first 512 less 1%.
12. Adaptive rho on the reduced path (the bench flags with
   ``bench.py --adaptive-rho``): held to the JAX share less 1%; its
   operator rebuilds.
13. The batch-level engine `solve_batched_fast` at B = 8192 with adaptive
   rho (`FAST_OPTS`) and with alpha = 1.6 (`FAST_ALPHA_OPTS`), each
   captured (`captured_path`) and staged once: JAX shares less 1%,
   rebuilds, time per solve.
14. The parity engine on f32 data (``bench.py --engine f32``) at B = 8192,
   captured (`captured_path`): the JAX f32 engine's share less 1%, and
   the f32 full-layout kernel (`admm_chunk_full_f32`) against its plain
   version bit for bit on an uncaptured solve's one launch of all its
   iterations.
15. The parity engine's `replay`, captured (a cold graph pair, then the
   warm pair replayed at every later step), over the drop-in's 200-step
   walking log at B = 1 and over 256 streams x 16 steps of phase 5's
   walking log: the checks of `captured_path` for the replay (the
   uncaptured static chain bit for bit, the eager replay by statuses,
   n_iter and |dz| <= 1e-9, a profiled replay with no host read).
16. `FCCQPServer` over a 64-step walking log at depth 1, 2, 4 and 8 on
   both engines. First, per engine, a capture census
   (`capture_census`): the solve of the log's first step captured
   afresh with the kernel counters read around each stage, which gives
   each hand kernel's launches in one cold and one warm replay exactly,
   and each graph's nodes by type from `libcuda`. Then: the graphs
   captured; equal to the serial `FCCQP` loop
   (statuses, |dz| <= 1e-9 ds / 1e-8 f64), and both equal to the eager
   static solve bit for bit; the serial loop against the eager
   (uncaptured) solve as in phase 7; ms per result p50 / p95 and results/s per
   depth, beside the eager solves' results/s. Then at every depth a
   submit loop after the capturing first submit under `torch.profiler`:
   no host read (``aten::_local_scalar_dense``) and no synchronization
   outside a retire (``FCCQPServer.retire`` ranges), the traces of the
   depths together naming each hand kernel of its engine that the
   profiled solves ran (an f32 iteration, an f64 one; a skipped IF body
   launches nothing, and the trace of a graph with IF nodes names fewer
   of its kernels than run), and per solve the
   graph launches and the kernel launches the trace shows (a lower
   bound: a trace can lose kernel records, and an IF body that is
   skipped launches none of its kernels); a replay's device time from
   CUDA events over 20 back-to-back replays. Since the IF nodes, the
   census's kernel nodes are those a replay may run, not those it runs.
17. The sharded solves (`parallel`), each shard replaying its engine's
   capture: first two shards of 4096 on the one card at B = 8192, both
   engines at `SHARD_OPTS`, with the checks of `captured_path` (each
   shard bit for bit its uncaptured static solve; the eager unsharded
   solve by statuses, n_iter and |dz| <= 1e-9; a profiled sharded call
   with no host read); then over [cuda:0] and over two shards at B =
   8192 and 8191: equal to the unsharded solve (n_iter, statuses, |dz|
   <= 1e-8 ds / 1e-10 f64) with equal summary aggregates; then
   `parallel.scaling_bench` over one and two shards at the bench flags.
18. The bench entry point (`fcc_qp_tpu_torch.bench.run`, as ``python -m
   fcc_qp_tpu_torch.bench --model <name>`` runs it) for the quadruped and
   the humanoid at the bench defaults (cold B = 8192 of the walking log,
   the replay of 4096 streams x 16 steps, captured) and for Cassie at one
   repeat (`entry_phase`), each counted from zero over its run: the
   record line, each capture's census (warm-up, capture and instantiate
   seconds, nodes by type, IF nodes, hand kernels per graph) and the
   run's peak memory. Checks per model: the record's keys; no
   kFactorizationFailed, no NaN; kSuccess residuals <= 1e-6; the equality
   bars of phases 2 and 5; the kSuccess shares of the cold solve's first
   512 instances and of all 8192, and of the replay's first 64 streams,
   and the warm polish acceptance there, at least the JAX package's on
   the same instances less 1% (`ENTRY_JAX`); warm n_iter p50 <= 15; both reduced
   kernels launched. Cassie's replay equals phase 5's captured replay
   bit for bit (status, n_iter, z). For the quadruped (k = 24) and the
   humanoid (k = 47), each reduced kernel against its plain version bit
   for bit on an all-active first chunk, the bench solve's last chunk
   with an iterating instance (the stragglers) and a warm step's last
   chunk, timed with bounds (``*_quad``, ``*_hum``, ``*_tail_quad``,
   ``*_warm_hum``, ... keys).
19. The public surface and the walking-log example (`surface_phase`),
   each path counted from zero after every batched capture is dropped
   (so each captures anew and its wrappers count under the capture):
   `examples/replay_walking_torch.py`'s `replay` in its loop mode over
   400 synthesized steps (the drop-in f64 engine; kSuccess within two of
   the JAX package's, `EXAMPLE_JAX`) and its batched mode at 400 and at
   8192 steps (kSuccess at least the JAX share less 1%), kSuccess
   residuals <= 1e-6 and equality residuals <= 1e-8 (1 + max |b_eq|),
   the mode's kernels launched, the plot written (a temporary
   directory), the wall per `Solve` p50 / p95 and the batched solves/s;
   four ``timing=False`` calls of `solve_batched_ds` (phase 2's batch
   and flags) and of `solve_batched_fast` (`SHARD_OPTS`) queued before
   one synchronize, each bit for bit the ``timing=True`` result with
   zero time fields, their wall per call beside the synchronized call's;
   `solve(rho=, operator=)` and `solve_batched_fast(rho=, operator=)`
   (a scalar rho and one per instance) bit for bit the calls that build
   the operator; the reduced f64 kernel on the example's chunks, the
   reduced f32 kernel on the queued bench solve's and the full-layout
   kernel on the ``operator=`` solves' chunks against their plain
   versions bit for bit, timed with bounds (``*_example``,
   ``*_untimed``, ``*_solve_operator``, ``*_fast_operator`` keys).
   `python3 exp_surface_phase.py` runs it alone.
20. One JSON line with a record per kernel (the first chunk's numbers
   under the plain keys, the straggler chunk's under ``*_tail``, the
   humanoid's under ``*_k47`` / ``*_k76`` / ``*_n76``, the warm step's
   under ``*_warm``, the drop-in chunk's under ``*_b1``, alpha = 1.6's
   under ``*_alpha``; ``ms_idle`` is a launch on the straggler inputs
   with every instance done; ``launches`` sums every path's count, and
   ``launches_<path>`` splits it: on the captured paths (every path but
   the recorded solves) a wrapper counts at the warm-up and the capture,
   and
   ``launches_per_replay`` (``_cold``) gives its launches in one replay
   of each engine's warm (cold) B = 1 graphs, from the capture census,
   ``launches_per_cold_graph`` in one replay of the B = 8192 bench
   graphs, ``launches_per_replay_step0`` / ``launches_per_warm_step``
   in one replay of the replay's cold / warm graphs, and for the
   full-layout kernels ``launches_per_full_graph``, ``_fast_graph``,
   ``_f32_graph``, ``_parity_replay`` and ``_shard_graph`` in one replay
   of the graph pair of phases 6, 13, 14, 15 and 17, each counted under
   capture: an IF body's kernels count whether or not it runs;
   ``launches_entry`` per model of phase 18 and
   ``launches_per_entry_graph`` in one replay of each of its graphs,
   ``launches_surface`` per path of phase 19), the `nvidia-smi` line,
   and the final JSON status line.

Also printed: the bench solve's host seconds per chunk (the approach and
endgame stage seconds over their launches), beside the kernels' own
time per launch, and the replay's seconds per warm step.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
B = 8192
# the JAX bench's replay: a walking log of T steps in S streams; the
# captured replay is held bit for bit against the uncaptured static one
# over its first STATIC_REPLAY_STEPS steps
REPLAY_T, REPLAY_S = 65536, 4096
STATIC_REPLAY_STEPS = 16
# NVIDIA H100 SXM data sheet: HBM3 rate, FP64 and FP32 vector peaks
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f64": 34e12, "f32": 67e12}
# about 0.5 ms of spin per timed call at the H100's 1.98 GHz boost clock
SPIN_CYCLES_PER_CALL = 1_000_000
# the reduced path's kernels (phases 2-5); the full-layout kernel runs on
# the reference-semantics path (phases 6-8)
REDUCED_KERNELS = ("admm_chunk_f64", "admm_chunk_f32")


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
    of the inputs of its first and of its last call, of its last call in
    which some instance iterates (``last_active``), and of its last call
    from a warm replay step (one where some instance is done without
    having iterated: accepted by the warm polish attempt 0).
    ``done_at`` / ``itv_at``: where the wrapper takes those arguments."""

    def __init__(self, fn, done_at=12, itv_at=14):
        self.fn = fn
        self.done_at, self.itv_at = done_at, itv_at
        self.first = None
        self.last = None
        self.last_active = None
        self.last_warm = None

    def __call__(self, *args, **kw):
        import torch

        clone = lambda a: a.clone() if isinstance(a, torch.Tensor) else a
        self.last = (
            tuple(clone(a) for a in args),
            {k: clone(v) for k, v in kw.items()},
        )
        if self.first is None:
            self.first = self.last
        done, itv = args[self.done_at], args[self.itv_at]
        if bool((done & (itv == 0)).any()):
            self.last_warm = self.last
        if not bool(done.all()):
            self.last_active = self.last
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


# the kernel instantiations of the library, one per row-slot count: both
# reduced kernels with and without over-relaxation, and the full layout
# (both iterations in one kernel) in f64 and f32
INSTANTIATIONS = tuple(
    [f"admm_chunk_warp<{t}, {nr}, {relax}>" for t in ("double", "float")
     for nr in (1, 2, 3) for relax in ("false", "true")]
    + [f"admm_chunk_full_warp<{t}, {nr}>" for t in ("double", "float")
       for nr in (1, 2, 3)])


def check_ptxas(report: dict) -> None:
    """Every kernel instantiation of the loaded library keeps its state in
    registers: the compiler's report (kept beside a cached build) names
    each one, with no stack frame and no spills."""
    check(sorted(report) == sorted(INSTANTIATIONS),
          f"ptxas report names {sorted(report)}, not the library's "
          f"instantiations {sorted(INSTANTIATIONS)}")
    for name, (_, frame, st, ld) in report.items():
        check((frame, st, ld) == (0, 0, 0),
              f"ptxas [{name}]: {frame} bytes stack frame, {st} / {ld} "
              f"bytes spill stores / loads")


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


def compare(name, case, kernel, plain, args, kw, prec, exact=False):
    """Kernel vs plain version on the same inputs: counters equal, state
    within the tolerance (``exact``: the state and the max-norms bit for
    bit); both timed. Returns a record."""
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
        if n in ("done", "n_iter", "itv") or (
                exact and n not in ("prim", "dual")):
            if a.is_floating_point():
                max_err = max(max_err, float((a - b).abs().max()))
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
        f"{Fj.numel() * Fj.element_size() / 1e6:.1f} MB"
        + (f"; alpha {kw['alpha']}" if "alpha" in kw else "")
        + ("; bit for bit" if exact else ""))
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                longest=longest, **bound)


def _union(spans):
    """Sorted, disjoint union of [start, end) intervals."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile_captured_replay(replay, cap, log_sm):
    """Two windows under `torch.profiler`. (1) One captured replay: its
    host reads (``aten::_local_scalar_dense``) and the kernels of each
    hand-written instantiation in its trace. (2) After an untimed cold
    step 0, the warm steps alone: each later step's slice loaded and the
    warm graphs replayed, as the replay does, after which the card is
    synchronized; per warm step the window's wall, the device's busy
    time (the union of the kernels' intervals), its idle share, the
    kernels, the host reads, and the kernels with the most device time.
    The tracer's cost per kernel record stretches the profiled window
    (its gaps and its kernels), so the same window also runs unprofiled
    first: its wall, the span of the stream's work between CUDA events
    recorded around the steps, and the host's seconds to issue them (an
    issue time far below the span says the host does not hold the card
    back)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        replay()
        torch.cuda.synchronize()
    ev = prof.events()
    names = [e.name for e in ev if e.device_type == cuda]
    out = dict(
        replay_host_reads=sum(e.name == "aten::_local_scalar_dense"
                              for e in ev if e.device_type != cuda),
        replay_hand_kernels={inst: sum(inst in n for n in names)
                             for inst in GRAPH_KERNELS["ds"]})
    steps = log_sm.b.shape[0]

    def warm_steps():
        # the chain from step 0 (not timed), as in a replay; the wall, and
        # the span of the stream's work from CUDA events around the steps
        cap.load(type(log_sm)(*(a[0] for a in log_sm)))
        cap.run(False)
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        for t in range(1, steps):
            with torch.profiler.record_function("replay_warm_step"):
                cap.load(type(log_sm)(*(a[t] for a in log_sm)))
                cap.run(True)
        ev[1].record()
        issued = time.perf_counter() - t0
        torch.cuda.synchronize()
        return (time.perf_counter() - t0, ev[0].elapsed_time(ev[1]) * 1e-3,
                issued)

    quiet, quiet_span, quiet_issue = warm_steps()
    with profile(activities=acts) as prof:
        wall, _, _ = warm_steps()
    ev = prof.events()
    kernels = [e for e in ev if e.device_type == cuda
               and e.name != "replay_warm_step"]
    busy_us = sum(e - s_ for s_, e in _union(
        (e.time_range.start, e.time_range.end) for e in kernels))
    by_name: dict = {}
    for e in kernels:
        d = by_name.setdefault(e.name, [0.0, 0])
        d[0] += (e.time_range.end - e.time_range.start) * 1e-3
        d[1] += 1
    n = steps - 1
    out.update(
        steps=n, wall_s=wall / n, busy_s=busy_us * 1e-6 / n,
        idle_share=1.0 - busy_us * 1e-6 / wall,
        unprofiled_wall_s=quiet / n, unprofiled_span_s=quiet_span / n,
        unprofiled_issue_s=quiet_issue / n,
        launches=len(kernels) / n,
        host_reads=sum(e.name == "aten::_local_scalar_dense"
                       for e in ev if e.device_type != cuda) / n,
        graph_launches=sum(e.name == "cudaGraphLaunch" for e in ev) / n,
        top=[dict(name=k[:80], ms_per_step=v[0] / n, launches=v[1] / n)
             for k, v in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:8]])
    return out


def replay_phase(engine, bench):
    """Phase 5: the warm replay at the bench's shape, captured, its checks
    and its numbers. Returns the launches of the capturing replay per
    kernel (a wrapper counts while the graphs are captured), the
    recorders of a recorded (uncaptured) replay, the log, the final warm
    state, and the captures' report."""
    import numpy as np
    import torch

    from fcc_qp_tpu_torch import replay_ds_streams, solve_batched_ds
    from fcc_qp_tpu_torch import to_ds_batch
    from fcc_qp_tpu_torch.core.graphs import (CapturedBatch, _copy,
                                              captured_batch)
    from fcc_qp_tpu_torch.models.osc import CASSIE, generate_osc_sequence
    from fcc_qp_tpu_torch.ops import device_branch, pallas_admm
    from fcc_qp_tpu_torch.utils.io import stack_qp_dicts

    S, steps = REPLAY_S, REPLAY_T // REPLAY_S
    t0 = time.perf_counter()
    stacked = stack_qp_dicts(generate_osc_sequence(
        CASSIE, REPLAY_T, seed=0, smoothness=0.002))
    qp = to_ds_batch(stacked)
    torch.cuda.synchronize()
    log(f"[replay] walking log T={REPLAY_T} generated and moved in "
        f"{time.perf_counter() - t0:.2f} s")
    replay = lambda **kw: replay_ds_streams(qp, CASSIE.shape, bench,
                                            n_streams=S, **kw)
    ci_log = engine.constrained_indices(qp, CASSIE.shape)
    flag = device_branch.exhausted_flag("cuda")
    flag.fill_(False)

    # the capturing replay, counted from zero
    pallas_admm.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    replay()
    torch.cuda.synchronize()
    first_call = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in pallas_admm.KERNELS}
    peak_gb = (torch.cuda.max_memory_allocated() - mem0) / 1e9
    cap = captured_batch(engine.reduced_stages(CASSIE.shape, bench, ci_log,
                                               cached=True), S, "cuda")
    check(sorted(cap._captured) == [False, True],
          "replay: the cold and warm steps were not both captured")
    report = {("cold" if not w else "warm"): capture_report(cap, w)
              for w in (False, True)}

    # three timed replays
    walls, (sols, final_warm) = timed_walls(replay)
    wall = sorted(walls)[1]
    check(not bool(flag), "replay: a static gathered loop ended with work "
          "pending (its bound is too small)")
    # the eager (reading) replay in the same call, and a staged one
    eager_walls, (eager, _) = timed_walls(lambda: replay(graphs=False))
    eager_wall = sorted(eager_walls)[1]
    stages = {}
    replay(stage_times=stages)
    log("[replay] timed walls (s): " + json.dumps(walls) + "; eager "
        "(uncaptured) replay walls, same call: " + json.dumps(eager_walls))
    log(f"[replay] T={REPLAY_T} ({S} streams x {steps} steps), captured: "
        f"median {wall:.6f} s -> {REPLAY_T / wall:.1f} solves/s (eager "
        f"{eager_wall:.6f} s -> {REPLAY_T / eager_wall:.1f}); the "
        f"capturing replay {first_call:.3f} s, peak {peak_gb:.3f} GB "
        f"allocated; solve_time {float(sols.details.solve_time[0]):.6f} s "
        f"per step, factorization_time (step 0's operator graph) "
        f"{float(sols.details.factorization_time[0]):.6f} s")
    log("[replay:graphs] captures (cold = step 0, warm = each later step): "
        + json.dumps(report))

    # the uncaptured static replay under cuSOLVER, step by step: the
    # graph replays equal it bit for bit
    static = CapturedBatch(engine.reduced_stages(CASSIE.shape, bench, ci_log,
                                                 cached=True), S, "cuda",
                           graphs=False)
    log_sm = type(qp)(*(a.reshape(*a.shape[:-1], S, steps).movedim(-1, 0)
                        for a in qp))
    t0 = time.perf_counter()
    rows = np.arange(S) * steps
    for t in range(STATIC_REPLAY_STEPS):
        static.load(type(qp)(*(a[t] for a in log_sm)))
        static.run(t > 0)
        got = type(sols)(details=type(sols.details)(**{
            f: getattr(sols.details, f)[rows + t]
            for f in sols.details.__dataclass_fields__}),
            z=sols.z[rows + t])
        check_same_solution(f"replay step {t}: graph replay vs the "
                            "uncaptured static solve", got, static.out)
    torch.cuda.synchronize()
    static_wall = time.perf_counter() - t0
    check(not bool(flag), "replay: the uncaptured static solve ended a "
          "gathered loop with work pending")
    dz, dn = check_like_eager("replay", sols, eager)
    log(f"[replay] the graph replays equal the uncaptured static replay "
        f"bit for bit over its first {STATIC_REPLAY_STEPS} steps "
        f"({static_wall:.3f} s) and the eager replay by status (|dz| "
        f"{dz:.3e}, n_iter differs on {dn} rows); exhausted flag clear")

    d = sols.details
    q = lambda t: t.cpu().numpy()
    st = q(d.solve_status)
    ok = st == 0
    n = q(d.n_iter).reshape(S, steps)
    acc = q(d.polish_accepted).reshape(S, steps)
    warm_n = n[:, 1:]
    warm_acc = acc[:, 1:].mean()
    rb, rc = q(d.admm_residual_bounds), q(d.admm_residual_friction_cone)
    eqv = q(d.equality_viol)
    log(f"[replay] kSuccess {ok.sum()}/{len(st)} = {ok.mean():.4%}; "
        f"kMaxIterations {(st == 1).sum()}; kFactorizationFailed "
        f"{(st == 2).sum()}")
    log(f"[replay] cold-step n_iter p50 {np.median(n[:, 0]):.0f}; warm "
        f"n_iter p50 {np.median(warm_n):.0f}, mean {warm_n.mean():.4f}, "
        f"max {warm_n.max()}; warm polish acceptance {warm_acc:.4%}")
    log(f"[replay] max residuals (bounds, cone) ({rb.max():.3e}, "
        f"{rc.max():.3e}); max equality_viol {eqv.max():.3e}")
    log("[replay] launches over the capturing replay: " + json.dumps(launches))
    log("[replay] step-0 stage seconds (uncaptured, staged): "
        + json.dumps(stages["step0"]))
    log(f"[replay] warm-step stage seconds summed over {steps - 1} steps: "
        + json.dumps(stages["warm"]))
    per_warm = {k: v / (steps - 1) for k, v in stages["warm"].items()}
    log("[replay] per warm step (staged seconds; instances rescued / "
        "rebuilt / served by the f64 fallback, and calls that ran it): "
        + json.dumps(per_warm))

    res = np.maximum(rb, rc)
    check((st != 2).all(), "kFactorizationFailed in the replay")
    check(ok.mean() >= 0.999, f"replay kSuccess {ok.mean():.4%} < 99.9%")
    check((res[ok] <= 1e-6).all(), "replay kSuccess residual above 1e-6")
    # the equality bars of phase 2, with one exception the reference
    # shares: a warm step accepted by the polish's first attempt right
    # after a step that needed retries can carry a refined solve only as
    # exact as the acceptance test demands, |A_eq z - b_eq| < eps_bound
    # (the JAX package accepts the same steps with 1.3e-8 - 3.3e-7 on the
    # CPU, tests/test_torch_replay.py; ROADMAP.md queue C). Warm
    # polish-accepted steps are held to that test's bound.
    b_eq = np.abs(stacked["b_eq"]).max(axis=1)
    accf = acc.reshape(-1) > 0
    cold_row = np.arange(REPLAY_T) % steps == 0
    check((eqv[ok] <= 1e-8 * (1.0 + b_eq[ok])).all(),
          "replay: relative equality residual above 1e-8 on kSuccess")
    check((eqv[ok & accf & cold_row] <= 1e-8).all(),
          "replay: equality residual above 1e-8 on a polish-accepted step 0")
    check((eqv[ok & accf] <= bench.eps_bound).all(),
          "replay: equality residual above eps_bound on a polish-accepted "
          "step")
    loose = np.where(accf & (eqv > 1e-8))[0]
    log(f"[replay] polish-accepted warm steps with equality residual above "
        f"1e-8: {len(loose)} of {int(accf.sum())}: "
        + json.dumps([dict(row=int(r), stream=int(r // steps),
                           step=int(r % steps), eq=float(eqv[r]))
                      for r in loose[:8]]))
    check(warm_acc >= 0.99, f"warm polish acceptance {warm_acc:.4%} < 99%")
    check(np.median(warm_n) <= 15, f"warm n_iter p50 {np.median(warm_n)}")
    z = q(sols.z)
    check(np.isfinite(z).all() and z.shape == (REPLAY_T, 60),
          "replay solution not finite or of the wrong shape")
    for name in REDUCED_KERNELS:
        check(launches[name] > 0, f"{name} was not launched in the replay")

    # step 0 of every stream (rows s*steps) is the cold batched solve of
    # those instances; the replay takes its constrained coordinates from
    # the whole log
    qp0 = type(qp)(*(a[..., ::steps].contiguous() for a in qp))
    ci_0 = engine.constrained_indices(qp0, CASSIE.shape)
    if ci_log != ci_0:
        log(f"[replay] constrained coordinates differ: log {ci_log}, "
            f"step 0 {ci_0}; the cold solve takes the log's")
    cold, _ = solve_batched_ds(qp0, CASSIE.shape, bench, con_idx=ci_log)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solve_batched_ds(qp0, CASSIE.shape, bench, con_idx=ci_log)
    torch.cuda.synchronize()
    cold_wall = time.perf_counter() - t0
    rows0 = slice(0, None, steps)
    for name in ("solve_status", "n_iter", "polish_accepted"):
        check(np.array_equal(q(getattr(d, name))[rows0],
                             q(getattr(cold.details, name))),
              f"replay step 0: {name} differs from the cold solve")
    dz0 = float(np.abs(z[rows0] - q(cold.z)).max())
    check(dz0 <= 1e-12, f"replay step 0: z differs from the cold solve by "
          f"{dz0:.3e}")
    log(f"[replay] step-0 rows equal the cold solve of the same {S} "
        f"instances (max |dz| {dz0:.3e}); that cold solve (captured) took "
        f"{cold_wall:.6f} s, so a warm step took "
        f"{(wall - cold_wall) / (steps - 1):.6f} s of wall (eager: "
        f"{(eager_wall - cold_wall) / (steps - 1):.6f} s beside the captured "
        f"cold solve)")

    # where a captured warm step's time goes: a profiled replay, with no
    # host read in it and both kernels in its trace, and the warm steps
    # profiled alone
    prof = profile_captured_replay(replay, cap, log_sm)
    log("[replay] profiled captured replay and warm steps (per step): "
        + json.dumps(prof))
    check(prof["replay_host_reads"] == 0, f"replay: "
          f"{prof['replay_host_reads']} host reads in a captured replay")
    check(prof["host_reads"] == 0, f"replay: {prof['host_reads']} host "
          "reads per captured warm step")
    for inst, k in prof["replay_hand_kernels"].items():
        check(k > 0, f"replay: the trace names no {inst}")
    report.update(first_call_s=first_call, peak_allocated_gb=peak_gb,
                  replay_walls=walls, replay_median_s=wall,
                  eager_walls=eager_walls, eager_median_s=eager_wall,
                  static_steps=STATIC_REPLAY_STEPS, static_wall_s=static_wall,
                  max_dz_to_eager=dz, n_iter_differs_from_eager=dn,
                  warm_step_s=(wall - cold_wall) / (steps - 1),
                  profiled_warm_step=prof)

    # a recorded (uncaptured) replay, not counted, keeps each kernel's
    # last warm chunk
    _, rec = recorded_solve(engine, lambda: replay(graphs=False))
    return launches, rec, stacked, final_warm, report, sols


# the JAX bench's flags (bench.py:191-200) for the cold batch and the
# replay; the polish's Newton steps are the model's
BENCH_OPTS = dict(
    max_iter=3000, rho=0.05, eps_fcone=1e-6, eps_bound=1e-6,
    presolve="operator", scaling=True, splitting="constrained",
    kkt_refine_steps=1, kkt_factor="hybrid", lazy_exact=True,
    polish=True, polish_rounds=4, adaptive_rho=False, alpha=1.0,
)
# over-relaxation as OSQP sets it (alpha = 1.6), and bench.py
# --adaptive-rho (interval 100, one adaptation; bench.py:192-194)
ALPHA = 1.6
ADAPTIVE = dict(adaptive_rho=True, adaptive_rho_interval=100,
                adaptive_rho_max_adaptations=1)
# the batch-level engine (solve_batched_fast) at the options of the JAX
# package's own tests (tests/test_batched_fast.py:11, :78), and with
# alpha = 1.6 at rho = 0.1, where over-relaxation and one adaptation both
# act (at rho = 1 and alpha = 1.6 nothing adapts, in both packages)
FAST_OPTS = dict(max_iter=2000, rho=1.0, eps_fcone=1e-6, eps_bound=1e-6,
                 adaptive_rho=True, adaptive_rho_interval=50)
FAST_ALPHA_OPTS = dict(FAST_OPTS, alpha=ALPHA, rho=0.1)
# bench.py --engine f32: the parity engine on f32 data with the bench's
# tolerances and operator presolve, no adaptation, scaling, constrained
# splitting or polish (bench.py:206-210)
F32_OPTS = dict(max_iter=3000, rho=0.05, eps_fcone=1e-6, eps_bound=1e-6,
                presolve="operator")
# the full-splitting engine's options of the JAX package's own tests
# (tests/test_ds_engine.py:15,46): the package defaults' path, exact
# presolve, adaptive rho
FULL_OPTS = dict(max_iter=2000, rho=1.0, eps_fcone=1e-6, eps_bound=1e-6,
                 adaptive_rho=True)
# kSuccess share of the JAX package on the first 512 instances of
# generate_osc_batch(CASSIE, 8192, seed=0) at FULL_OPTS, on the CPU
# (exp_full_reference.py: 509 of 512, and the port's plain versions the
# same 509 with every n_iter equal); the card must reach it less 1%
FULL_JAX_SHARE_512 = 509 / 512
# the drop-in replay (the reference loop over a 200-step walking log):
# the README quick-start options on the f64 engine, and the same with the
# equilibrated-space rho on the ds engine
DROPIN_STEPS = 200
DROPIN_OPTS = dict(rho=5e-5, eps_fcone=1e-6, eps_bound=1e-6, max_iter=100)
DROPIN_DS_RHO = 0.05
# the statuses of the same two loops in the JAX package on the CPU
# (exp_full_reference.py; the port's plain versions on the CPU give the
# same): {engine: (kSuccess, kMaxIterations)}. At max_iter = 100 the f64
# engine runs every step of this synthetic log to the cap (the README's
# rho is the real log's); the card may differ by two steps, since its
# matrix products round differently from the CPU's
DROPIN_JAX_STATUSES = {"f64": (0, 200), "ds": (162, 38)}
# the humanoid (n = 76, the kernels' third row slot): the full engine on
# generate_osc_batch(HUMANOID, 1024, seed=0) at FULL_OPTS, whose kSuccess
# share must reach the JAX package's on the first 64 instances on the CPU
# less 1% (exp_full_reference.py), and the drop-in FCCQP(76, 41, 24, 52)
# on the f64 engine over a short walking log at a rho the humanoid's raw
# data converges at (the README's 5e-5 leaves every step at the cap)
# (n, num_eq, nc, lambda_c_start) of random problems whose row counts
# are no model's: the full-layout kernel at one, two and three row slots
# (a cone triple across slots 1 / 2), and a segment of 36 rows, where a
# lane owns two cone rows
GENERIC_DIMS = ((24, 8, 6, 10), (50, 20, 12, 31), (90, 30, 24, 60),
                (90, 30, 36, 40))
HUMANOID_B = 1024
HUMANOID_JAX_SHARE_64 = 64 / 64
HUMANOID_DROPIN_STEPS = 20
HUMANOID_DROPIN_OPTS = dict(rho=0.01, eps_fcone=1e-6, eps_bound=1e-6,
                            max_iter=400)
# the statuses of that loop in the JAX package on the CPU: (kSuccess,
# kMaxIterations)
HUMANOID_DROPIN_JAX_STATUSES = (20, 0)
# the reduced two-phase path with splitting="full" on the same 1024
# humanoid instances: the JAX package's kSuccess share on the CPU
# (exp_full_reference.py, section humanoid_reduced1024; on the first 64
# the port's plain versions give the JAX statuses and n_iter instance for
# instance, 40 of 64); the card must reach it less 1%
HUMANOID_REDUCED_JAX_SHARE_1024 = 558 / 1024
FULL_NAMES = ("x", "x_bar", "lam_bar", "mu_x", "mu_lam", "v", "done",
              "n_iter", "itv", "xrn", "lrn", "prim", "dual")


def full_bound(args, kw, out):
    """`chunk_bound` for the full-layout chunk: bytes of the operator and
    per-instance data of the instances that iterate plus every
    instance's state in and out; (2n^2 + 16n + 12 ncones) flops per
    instance-iteration run, against the FP64 or FP32 peak (the inputs'
    precision)."""
    n, Bn = args[8].shape
    nc = args[10].shape[0]
    ncones = nc // 3
    itv_in = args[16]
    word = args[8].element_size()
    active = int((out[8] > itv_in).sum())
    iters = int((out[8] - itv_in).sum())
    per_active = (n * n + 3 * n + ncones + 1) * word
    state = (4 * n + 2 * nc + 4) * word + 3 * 4
    nbytes = active * per_active + 2 * Bn * state
    flops = iters * (2 * n * n + 16 * n + 12 * ncones)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS["f64" if word == 8 else "f32"]
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                active=active, iters=iters, n=n, B=Bn)


def compare_full(case, kernel, plain, args, kw, time_it=True, plain_reps=3):
    """The full-layout kernel (`admm_chunk_full_f64`, or
    `admm_chunk_full_f32` on f32 inputs) against its plain version on the
    same inputs: the state, the counters and the max-norms bit for bit,
    the 2-norms (sums whose order PyTorch's reduction picks) to 1e-12
    relative (f64) or 1e-6 (f32). ``plain_reps``: timed calls of the
    plain version after its warm-up call."""
    import torch

    f32 = args[8].dtype == torch.float32
    kname = "admm_chunk_full_f32" if f32 else "admm_chunk_full_f64"
    out_k = kernel(*args, **kw)
    torch.cuda.synchronize()
    out_p = plain(*args, **kw)
    torch.cuda.synchronize()
    max_err = 0.0
    for name, a, b in zip(FULL_NAMES, out_k, out_p):
        if name in ("prim", "dual"):
            rel = float(((a - b).abs() / (1.0 + b.abs())).max())
            check(rel <= (1e-6 if f32 else 1e-12), f"{kname} [{case}]: "
                  f"{name} rel diff {rel:.3e}")
            continue
        if a.is_floating_point() and a.numel():
            max_err = max(max_err, float((a - b).abs().max()))
        check(torch.equal(a, b), f"{kname} [{case}]: {name} differs from "
              f"the plain version")
    bound = full_bound(args, kw, out_k)
    rec = dict(max_abs_err=max_err, **bound)
    if time_it:
        ms, issue_ms = time_cuda(lambda: kernel(*args, **kw), reps=20)
        plain_ms, _ = time_cuda(lambda: plain(*args, **kw), reps=plain_reps)
        rec.update(ms=ms, plain_ms=plain_ms, issue_ms=issue_ms)
    longest = int((out_k[8] - args[16]).max())
    log(f"[kernel] {kname} [{case}]: n={bound['n']} "
        f"B={bound['B']} ls={kw['ls']} K={kw['K']} gate={kw['gate']} active "
        f"{bound['active']}, iterations run {bound['iters']} (longest "
        f"{longest}), max |diff| {max_err:.3e}"
        + (f", kernel {rec['ms']:.6f} ms (host issue {rec['issue_ms']:.6f} "
           f"ms per call), plain {rec['plain_ms']:.6f} ms" if time_it else "")
        + f", bound {bound['bound_ms']:.6f} ms ({bound['bound_by']})"
        + (f", alpha {kw['alpha']}" if "alpha" in kw else ""))
    return rec


def random_batch(n, m, nc, ls, Bn, seed):
    """A stacked batch of Bn random feasible QPs with n variables, m
    equality rows and nc cone rows at [ls, ls + nc): b_eq from a point
    inside the cones and the (half finite) bounds."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = {k: [] for k in ("Q", "b", "A_eq", "b_eq", "friction_coeffs",
                           "lb", "ub")}
    for _ in range(Bn):
        G = rng.normal(size=(n, n))
        x0 = 0.3 * rng.normal(size=n)
        for c in range(nc // 3):
            x0[ls + 3 * c:ls + 3 * c + 3] = (0.1 * rng.normal(),
                                             0.1 * rng.normal(), 1.0)
        A = rng.normal(size=(m, n))
        box = rng.random(n) < 0.5
        lb = np.where(box, x0 - 0.5, -np.inf)
        ub = np.where(box, x0 + 0.5, np.inf)
        for k, v in (("Q", G @ G.T + 0.1 * np.eye(n)),
                     ("b", rng.normal(size=n)), ("A_eq", A),
                     ("b_eq", A @ x0),
                     ("friction_coeffs", np.full(nc // 3, 0.8)),
                     ("lb", lb), ("ub", ub)):
            out[k].append(v)
    return {k: np.stack(v) for k, v in out.items()}


def recorded_full(module, run, name="admm_chunk_full_f64"):
    """``run()`` with the full-layout wrapper ``name`` in ``module``
    wrapped in a `Recorder`; returns ``(result, recorder)``."""
    rec = Recorder(getattr(module, name), done_at=14, itv_at=16)
    setattr(module, name, rec)
    try:
        out = run()
    finally:
        setattr(module, name, rec.fn)
    return out, rec


def full_phase(engine):
    """Phase 6: the full-splitting cold Cassie solve, B = 8192, at
    FULL_OPTS, captured (`captured_path`, the rebuild body timed), then
    one staged solve (uncaptured). Returns its launches, a recorder of one
    more (uncaptured) solve, the kernel's profiled device time and the
    capture's report."""
    import numpy as np
    import torch

    from fcc_qp_tpu_torch import FCCQPOptions, solve_batched_ds, to_ds_batch
    from fcc_qp_tpu_torch.models.osc import CASSIE, generate_osc_batch
    from fcc_qp_tpu_torch.utils.io import stack_qp_dicts

    stacked = stack_qp_dicts(generate_osc_batch(CASSIE, B, seed=0))
    qp = to_ds_batch(stacked)
    opts = FCCQPOptions(**FULL_OPTS)
    rho = torch.full((B,), opts.rho, dtype=torch.float32, device="cuda")
    sol, launches, rep = captured_path(
        "full", engine.full_stages(CASSIE.shape, opts), qp,
        lambda g: solve_batched_ds(qp, CASSIE.shape, opts, graphs=g),
        "admm_chunk_full_warp<double",
        rebuild=lambda: engine._factor(qp, rho, opts.kkt_refine_steps,
                                       static=True))
    walls = rep["replay_walls"]
    wall = rep["replay_median_s"]
    stages = {}
    solve_batched_ds(qp, CASSIE.shape, opts, stage_times=stages)
    rep["n_refactor"] = stages["n_refactor"]
    d = sol.details
    q = lambda t: t.cpu().numpy()
    st, n_iter = q(d.solve_status), q(d.n_iter)
    ok = st == 0
    rb, rc = q(d.admm_residual_bounds), q(d.admm_residual_friction_cone)
    eqv = q(d.equality_viol)
    z = q(sol.z)
    log("[full] timed walls (s, graph replays): " + json.dumps(walls))
    log(f"[full] Cassie B={B} full splitting, exact presolve, adaptive rho: "
        f"kSuccess {ok.sum()}/{len(st)} = {ok.mean():.4%}; kMaxIterations "
        f"{(st == 1).sum()}; kFactorizationFailed {(st == 2).sum()}")
    log(f"[full] n_iter p50 {np.median(n_iter):.0f}, max {n_iter.max()}; "
        f"max residuals kSuccess (bounds, cone) ({rb[ok].max():.3e}, "
        f"{rc[ok].max():.3e}); max equality_viol {eqv.max():.3e}")
    log(f"[full] median wall {wall:.6f} s -> {B / wall:.1f} solves/s "
        f"(captured; eager {rep['eager_median_s']:.6f} s in the same call); "
        f"factorization_time {float(d.factorization_time[0]):.6f} s of "
        f"solve_time {float(d.solve_time[0]):.6f} s; {stages['n_refactor']} "
        f"rebuilds a solve, one rebuild body "
        f"{rep['rebuild_body']['ms']:.6f} ms of device time; staged "
        "(uncaptured) stage seconds " + json.dumps(stages))
    log("[full] launches (capture): " + json.dumps(launches))
    device = full_kernel_device_time(
        lambda st_: solve_batched_ds(qp, CASSIE.shape, opts, stage_times=st_))
    log(f"[full] one staged (uncaptured) solve under torch.profiler: "
        f"admm_chunk_full_f64 device time {device['ms']:.6f} ms over "
        f"{device['launches']} launches; its iterate stage "
        f"{device['iterate_s']:.6f} s there and {stages['iterate']:.6f} s in "
        "the staged solve above (the rest of iterate: the adaptive-rho "
        "rebuilds and the host's chunk loop)")
    check((st != 2).all(), "kFactorizationFailed in the full-splitting solve")
    check(np.isfinite(z).all() and z.shape == (B, 60),
          "full-splitting solution not finite or of the wrong shape")
    check(not np.isnan(rb).any() and not np.isnan(rc).any(),
          "NaN residual in the full-splitting solve")
    check((np.maximum(rb, rc)[ok] <= 1e-6).all(),
          "full-splitting kSuccess residual above 1e-6")
    bar = FULL_JAX_SHARE_512 - 0.01
    check(ok.mean() >= bar, f"full-splitting kSuccess {ok.mean():.4%} < "
          f"{bar:.4%}")
    check(launches["admm_chunk_full_f64"] > 0,
          "admm_chunk_full_f64 was not launched in the full-splitting solve")
    _, rec = recorded_full(
        engine, lambda: solve_batched_ds(qp, CASSIE.shape, opts,
                                         graphs=False))
    return launches, rec, device, rep


def full_kernel_device_time(solve):
    """``solve(stage_times)`` once under `torch.profiler`: the summed
    device time of the full-layout kernel's launches, their count, and the
    solve's `iterate` stage seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    stages = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solve(stages)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    ev = [e for e in prof.events() if e.device_type == cuda
          and "admm_chunk_full_warp" in e.name]
    check(len(ev) > 0, "the profiler saw no admm_chunk_full_f64 launch")
    ms = sum(e.time_range.end - e.time_range.start for e in ev) * 1e-3
    return dict(ms=ms, launches=len(ev), iterate_s=stages["iterate"])


def check_dropin_steps(tag, seq, res, st, n):
    """Every kSuccess step of a drop-in loop: a finite z of n values,
    the equality residual, bounds and cones."""
    import numpy as np

    for i in np.where(st == 0)[0]:
        qp, r = seq[i], res[i]
        z = r.z
        eq = np.abs(qp["A_eq"] @ z - qp["b_eq"]).max()
        check(np.isfinite(z).all() and z.shape == (n,),
              f"drop-in {tag} step {i}: z not finite")
        check(eq <= 1e-6 * (1.0 + np.abs(qp["b_eq"]).max()),
              f"drop-in {tag} step {i}: |A_eq z - b_eq| {eq:.3e}")
        check(r.details.bounds_viol <= 1e-5 and
              r.details.friction_cone_viol <= 1e-5,
              f"drop-in {tag} step {i}: bounds / cone violation "
              f"{r.details.bounds_viol:.3e} / "
              f"{r.details.friction_cone_viol:.3e}")


KEYS = ("Q", "b", "A_eq", "b_eq", "friction_coeffs", "lb", "ub")
# the steps of a drop-in or serving log held bit for bit against the
# eager static solve (a ds eager static solve takes about 0.27 s at B = 1)
GRAPH_EQ_STEPS = 64
# submits after the capturing first one, profiled at every server depth
PROFILED_SUBMITS = 12
# the hand kernels each engine's graphs must launch (names in the trace)
GRAPH_KERNELS = {"ds": ("admm_chunk_warp<float", "admm_chunk_warp<double"),
                 "f64": ("admm_chunk_full_warp<double",)}


def eager_static_chain(engine, opts, seq):
    """The eager static solve on the card (`core.graphs.CapturedSolve`
    with graphs off: the code the graphs capture, run op by op) over
    ``seq``, warm-chained and classified per step as `FCCQP` does; the
    packed results, one row a step (z, then `core.graphs.STATS`)."""
    import numpy as np
    import torch

    from fcc_qp_tpu_torch.core.graphs import (CapturedSolve, SolveBuffers,
                                              classify, engine_options,
                                              layout, pack_host)
    from fcc_qp_tpu_torch.models.osc import CASSIE

    shape = CASSIE.shape
    opts = engine_options(opts, engine)
    host = torch.empty((layout(shape)[-1],), dtype=torch.float64)
    bufs = SolveBuffers(shape, engine, "cuda", opts.rho)
    solves, out = {}, []
    for i, qp in enumerate(seq):
        pack_host(shape, [qp[k] for k in KEYS], host)
        con_idx = classify(shape, engine, host)
        if con_idx not in solves:
            solves[con_idx] = CapturedSolve(shape, opts, engine, bufs,
                                            con_idx, graphs=False)
        bufs.inp.copy_(host)
        solves[con_idx].run(i > 0)
        out.append(bufs.out.cpu().numpy().copy())
    return np.stack(out)


def packed_results(results, n):
    """Host results (`FCCQPSolution`) as packed rows, like the eager
    static chain's."""
    import numpy as np

    from fcc_qp_tpu_torch.core.graphs import STATS

    return np.stack([np.concatenate([r.z, [float(getattr(r.details, k))
                                           for k in STATS]])
                     for r in results])


def check_bit_equal(tag, got, want):
    """Replays against the eager static solve: every word equal."""
    import numpy as np

    bad = np.where((got != want).any(axis=1))[0]
    check(len(bad) == 0, f"{tag}: the graph replays differ from the eager "
          f"static solve at steps {bad.tolist()[:8]} (max |diff| "
          f"{float(np.abs(got - want).max()):.3e})")


def check_captured(tag, solves):
    check(len(solves) > 0 and all(s.graphs and s.captured for s in solves),
          f"{tag}: the solve was not captured as CUDA graphs")


def eager_dropin_walls(engine, opts, seq):
    """Per-step wall of `Solve` + `GetSolution` with the drop-in's solve
    uncaptured: the eager engine (a host read per chunk, per polish pass
    and per skip; the f64 engine's loop in chunks of 64 iterations), the
    operator span synchronized apart, the details read field by field.
    Returns the walls (s) and the packed results (as
    `eager_static_chain`'s)."""
    import numpy as np
    import torch

    from fcc_qp_tpu_torch.core.ds_engine import QPBatchDS, solve_batched_ds
    from fcc_qp_tpu_torch.core.graphs import engine_options, pack_solution
    from fcc_qp_tpu_torch.core.solver import _solve_core
    from fcc_qp_tpu_torch.models.osc import CASSIE
    from fcc_qp_tpu_torch.ops.kkt import admm_operator
    from fcc_qp_tpu_torch.types import QPBatch

    shape = CASSIE.shape
    opts = engine_options(opts, engine)
    warm, walls, rows = None, [], []
    for i, step in enumerate(seq):
        t0 = time.perf_counter()
        qp = QPBatch(*(torch.as_tensor(np.asarray(step[k], np.float64))
                       .to("cuda") for k in KEYS))
        if engine == "ds":
            sol, warm = solve_batched_ds(
                QPBatchDS(*(v[..., None].contiguous()
                            for v in qp.__dict__.values())),
                shape, opts, warm=warm, warm_start=i > 0, graphs=False)
        else:
            qp1 = QPBatch(*(a[None] for a in qp.__dict__.values()))
            torch.cuda.synchronize()
            op = admm_operator(qp1.Q, qp1.b, qp1.A_eq, qp1.b_eq, opts.rho)
            torch.cuda.synchronize()
            sol, warm = _solve_core(qp1, shape, opts, warm, i > 0, op)
            torch.cuda.synchronize()
        _ = {k: v.reshape(-1)[0].item()
             for k, v in sol.details.__dict__.items()}
        _ = sol.z.cpu().numpy()
        walls.append(time.perf_counter() - t0)
        rows.append(pack_solution(sol).cpu().numpy())
    return walls, np.stack(rows)


def check_against_eager(tag, engine, got, eager, dz_bar):
    """The graph replays against the eager (uncaptured) solve: bit for
    bit on the f64 engine (its one launch of max_iter iterations must
    equal the chunked loop); on the ds engine statuses equal and |dz|
    within the server bar, and whether it is bit for bit. Returns
    (bit for bit, max |dz|)."""
    import numpy as np

    n = got.shape[1] - 11
    if engine == "f64":
        check_bit_equal(f"{tag} (against the chunked eager solve)", got,
                        eager)
    dz = float(np.abs(got[:, :n] - eager[:, :n]).max())
    check(np.array_equal(got[:, n + 1], eager[:, n + 1]) and dz <= dz_bar,
          f"{tag}: statuses or |dz| {dz:.3e} against the eager solve")
    return bool(np.array_equal(got, eager)), dz


def dropin_phase(solver_mod):
    """Phase 7: the drop-in `FCCQP` over a 200-step walking log, the
    reference loop, on both engines, replaying its captured graphs (the
    capturing `Solve`s counted and timed apart); held bit for bit against
    the eager static solve on the first `GRAPH_EQ_STEPS`, and timed
    beside the eager solve of the drop-in before its capture; then the
    verify notes' probes. Returns {engine: launches}, the recorders of
    the eager static chains' launches (the f64 chain's full-layout
    kernel; the ds chain's two reduced kernels, {name: recorder}), and
    the numbers."""
    import numpy as np

    import fcc_qp_tpu_torch.core.ds_engine as ds_mod
    from fcc_qp_tpu_torch import FCCQP, FCCQPOptions
    from fcc_qp_tpu_torch.models.osc import CASSIE, generate_osc_sequence
    from fcc_qp_tpu_torch.ops import pallas_admm

    seq = generate_osc_sequence(CASSIE, DROPIN_STEPS, seed=0)
    keys = KEYS
    launches, rec, rec_ds, table = {}, None, None, {}
    for engine, rho in (("f64", DROPIN_OPTS["rho"]), ("ds", DROPIN_DS_RHO)):
        opts = FCCQPOptions(**dict(DROPIN_OPTS, rho=rho))
        solver = FCCQP(60, 38, 12, 38, engine=engine)
        solver.set_options(opts)

        pallas_admm.reset_launch_counts()
        res, walls, capturing = [], [], []
        for i, qp in enumerate(seq):
            solver.set_warm_start(i > 0)
            known = {id(c) for c in solver._captures.values() if c.captured}
            t0 = time.perf_counter()
            solver.Solve(*(qp[k] for k in keys))
            res.append(solver.GetSolution())
            walls.append(time.perf_counter() - t0)
            if any(c.captured and id(c) not in known
                   for c in solver._captures.values()):
                capturing.append(i)
        launches[engine] = {fn.__name__: fn.launches
                            for fn in pallas_admm.KERNELS}
        check_captured(f"drop-in {engine}", solver._captures.values())
        # the eager static solve on the same steps, its launches recorded
        # (the f64 chain's last and the ds chain's first and last reduced
        # launches are phase 8's B = 1 cases)
        t0 = time.perf_counter()
        if engine == "f64":
            ref, rec = recorded_full(solver_mod, lambda: eager_static_chain(
                engine, opts, seq[:GRAPH_EQ_STEPS]))
        else:
            ref, rec_ds = recorded_solve(ds_mod, lambda: eager_static_chain(
                engine, opts, seq[:GRAPH_EQ_STEPS]))
        static_s = (time.perf_counter() - t0) / GRAPH_EQ_STEPS
        check_bit_equal(f"drop-in {engine}",
                        packed_results(res[:GRAPH_EQ_STEPS], 60), ref)
        eager, eager_rows = eager_dropin_walls(engine, opts,
                                               seq[:GRAPH_EQ_STEPS])
        eager = np.array(eager) * 1e3
        same, dz = check_against_eager(
            f"drop-in {engine}", engine,
            packed_results(res[:GRAPH_EQ_STEPS], 60), eager_rows,
            1e-9 if engine == "ds" else 1e-8)
        det = [r.details for r in res]
        st = np.array([x.solve_status for x in det])
        n_iter = np.array([x.n_iter for x in det])
        ms = np.array(walls) * 1e3
        replays = np.delete(ms, capturing)
        table[engine] = dict(
            graph_p50_ms=float(np.median(ms)),
            graph_p95_ms=float(np.percentile(ms, 95)),
            graph_first_ms=float(ms[0]),
            captures=len(solver._captures), capturing_steps=capturing,
            capturing_ms=[float(ms[i]) for i in capturing],
            replay_p50_ms=float(np.median(replays)),
            replay_p95_ms=float(np.percentile(replays, 95)),
            graph_p50_ms_first64=float(np.median(ms[:GRAPH_EQ_STEPS])),
            solve_time_p50_ms=float(np.median([x.solve_time
                                               for x in det]) * 1e3),
            factorization_time_p50_ms=float(np.median(
                [x.factorization_time for x in det]) * 1e3),
            eager_p50_ms=float(np.median(eager)),
            eager_p95_ms=float(np.percentile(eager, 95)),
            eager_static_ms=static_s * 1e3,
            bit_equal_to_eager=same, max_dz_to_eager=dz)
        log(f"[dropin:{engine}] {DROPIN_STEPS} steps, graph replays: "
            f"Solve+GetSolution wall p50 {np.median(ms):.3f} ms, p95 "
            f"{np.percentile(ms, 95):.3f} ms; {len(solver._captures)} "
            f"captures, made by the Solves of steps {capturing} "
            f"({', '.join(f'{ms[i]:.3f}' for i in capturing)} ms); without "
            f"them p50 {table[engine]['replay_p50_ms']:.3f} ms, p95 "
            f"{table[engine]['replay_p95_ms']:.3f} ms; solve_time p50 "
            f"{table[engine]['solve_time_p50_ms']:.3f} ms, "
            f"factorization_time p50 "
            f"{table[engine]['factorization_time_p50_ms']:.3f} ms; the first "
            f"{GRAPH_EQ_STEPS} steps bit for bit the eager static solve "
            f"({static_s * 1e3:.3f} ms a step); the eager (uncaptured) solve, "
            f"same call, same {GRAPH_EQ_STEPS} steps: p50 "
            f"{np.median(eager):.3f} ms, p95 {np.percentile(eager, 95):.3f} "
            f"ms (graph p50 on those steps "
            f"{table[engine]['graph_p50_ms_first64']:.3f} ms)")
        log(f"[dropin:{engine}] statuses kSuccess {(st == 0).sum()}, "
            f"kMaxIterations {(st == 1).sum()}, kFactorizationFailed "
            f"{(st == 2).sum()}; n_iter p50 {np.median(n_iter):.0f}, max "
            f"{n_iter.max()}, step 0 {n_iter[0]}; polish accepted "
            f"{sum(x.polish_accepted for x in det)}; launches (warm-up and "
            f"capture) " + json.dumps(launches[engine]))
        want = DROPIN_JAX_STATUSES[engine]
        log(f"[dropin:{engine}] the JAX package on the CPU: kSuccess "
            f"{want[0]}, kMaxIterations {want[1]}")
        check((st != 2).all(), f"drop-in {engine}: kFactorizationFailed")
        check(abs(int((st == 0).sum()) - want[0]) <= 2,
              f"drop-in {engine}: kSuccess count {(st == 0).sum()} is not "
              f"the JAX package's {want[0]} (+-2)")
        check_dropin_steps(engine, seq, res, st, 60)
    check(launches["f64"]["admm_chunk_full_f64"] > 0,
          "admm_chunk_full_f64 was not launched in the f64 drop-in replay")

    # the verify notes' probes, on both engines
    rng = np.random.default_rng(0)
    for engine in ("f64", "ds"):
        try:
            FCCQP(10, 2, 4, 0, engine=engine)
        except ValueError:
            pass
        else:
            fail(f"probe {engine}: FCCQP(10, 2, 4, 0) did not raise")
        s = FCCQP(60, 38, 12, 38, engine=engine)
        try:
            s.GetSolution()
        except RuntimeError:
            pass
        else:
            fail(f"probe {engine}: GetSolution() before Solve() did not raise")
        qp = seq[0]
        for bad, what in ((dict(qp, Q=np.eye(59)), "a wrong Q shape"),
                          (dict(qp, lb=qp["ub"] + 1.0), "lb > ub")):
            try:
                s.Solve(*(bad[k] for k in keys))
            except ValueError:
                pass
            else:
                fail(f"probe {engine}: {what} did not raise")
        # equality-only: no cones, every bound infinite
        n, m = 12, 5
        G = rng.normal(size=(n, n))
        A = rng.normal(size=(m, n))
        eq_qp = dict(Q=G @ G.T + 0.1 * np.eye(n), b=rng.normal(size=n),
                     A_eq=A, b_eq=A @ rng.normal(size=n),
                     friction_coeffs=np.zeros(0), lb=np.full(n, -np.inf),
                     ub=np.full(n, np.inf))
        s = FCCQP(n, m, 0, 0, engine=engine)
        s.Solve(*(eq_qp[k] for k in keys))
        r = s.GetSolution()
        res_eq = np.abs(A @ r.z - eq_qp["b_eq"]).max()
        check(r.details.n_iter == 0 and r.details.solve_status == 0
              and res_eq <= 1e-9,
              f"probe {engine}: equality-only problem n_iter "
              f"{r.details.n_iter}, status {r.details.solve_status}, "
              f"|A z - b| {res_eq:.3e}")
    log("[dropin] probes passed on both engines: FCCQP(10, 2, 4, 0), a wrong "
        "Q shape and lb > ub raise, GetSolution() before Solve() raises, an "
        "equality-only problem gives n_iter 0 and an exact A_eq residual")
    return launches, rec, rec_ds, table


def humanoid_phase(engine, two_phase):
    """Phase 9: the humanoid (n = 76 rows, the kernels' third row slot) on
    the three paths that take it at that size: (a) the full engine on
    `generate_osc_batch(HUMANOID, 1024, seed=0)` at FULL_OPTS, (b) the
    drop-in `FCCQP(76, 41, 24, 52)` on the f64 engine over a 20-step
    walking log, (c) the reduced two-phase path with ``splitting="full"``
    (k = 76) on the same batch. Each path is counted from zero. Returns
    {path: launches} and the recorders of (a) and (c)."""
    import numpy as np
    import torch

    from fcc_qp_tpu_torch import (FCCQP, FCCQPOptions, solve_batched_ds,
                                  to_ds_batch)
    from fcc_qp_tpu_torch.models.osc import (HUMANOID, generate_osc_batch,
                                             generate_osc_sequence)
    from fcc_qp_tpu_torch.ops import pallas_admm
    from fcc_qp_tpu_torch.utils.io import stack_qp_dicts

    shape = HUMANOID.shape
    n = shape.num_vars
    check(n > 64, f"the humanoid has n = {n}, not above two row slots")
    counts = lambda: {fn.__name__: fn.launches for fn in pallas_admm.KERNELS}
    qp = to_ds_batch(stack_qp_dicts(generate_osc_batch(
        HUMANOID, HUMANOID_B, seed=0)))
    launches = {}

    # (a) the full engine: a recorded solve (its first chunk is held
    # against the plain version below), then a counted, staged one
    opts = FCCQPOptions(**FULL_OPTS)
    t0 = time.perf_counter()
    _, rec_full = recorded_full(
        engine, lambda: solve_batched_ds(qp, shape, opts, graphs=False))
    torch.cuda.synchronize()
    log(f"[humanoid:full] recorded solve {time.perf_counter() - t0:.3f} s")
    check(rec_full.first is not None and rec_full.first[0][8].shape[0] == n,
          f"admm_chunk_full_f64 did not run the humanoid at n = {n}")
    pallas_admm.reset_launch_counts()
    stages = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol, _ = solve_batched_ds(qp, shape, opts, stage_times=stages)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["full"] = counts()
    d = sol.details
    q = lambda t: t.cpu().numpy()
    st, n_iter = q(d.solve_status), q(d.n_iter)
    ok = st == 0
    rb, rc = q(d.admm_residual_bounds), q(d.admm_residual_friction_cone)
    z = q(sol.z)
    log(f"[humanoid:full] B={HUMANOID_B}, n={n}, FULL_OPTS: kSuccess "
        f"{ok.sum()}/{len(st)} = {ok.mean():.4%}; kMaxIterations "
        f"{(st == 1).sum()}; kFactorizationFailed {(st == 2).sum()}; n_iter "
        f"p50 {np.median(n_iter):.0f}, max {n_iter.max()}; not kSuccess at "
        f"{np.where(~ok)[0].tolist()[:16]}; staged wall "
        f"{wall:.6f} s, stage seconds " + json.dumps(stages)
        + "; launches " + json.dumps(launches["full"]))
    check((st != 2).all(), "humanoid full engine: kFactorizationFailed")
    check(np.isfinite(z).all() and z.shape == (HUMANOID_B, n)
          and not np.isnan(rb).any() and not np.isnan(rc).any(),
          "humanoid full engine: NaN or a solution of the wrong shape")
    check((np.maximum(rb, rc)[ok] <= 1e-6).all(),
          "humanoid full engine: kSuccess residual above 1e-6")
    bar = HUMANOID_JAX_SHARE_64 - 0.01
    check(ok.mean() >= bar, f"humanoid full engine: kSuccess {ok.mean():.4%}"
          f" < {bar:.4%}")
    check(launches["full"]["admm_chunk_full_f64"] > 0,
          "humanoid full engine: admm_chunk_full_f64 not launched")

    # (b) the drop-in class on the f64 engine
    seq = generate_osc_sequence(HUMANOID, HUMANOID_DROPIN_STEPS, seed=0)
    keys = ("Q", "b", "A_eq", "b_eq", "friction_coeffs", "lb", "ub")
    solver = FCCQP(n, shape.num_eq, shape.nc, shape.lambda_c_start,
                   engine="f64")
    solver.set_options(FCCQPOptions(**HUMANOID_DROPIN_OPTS))
    pallas_admm.reset_launch_counts()
    res, walls = [], []
    for i, step in enumerate(seq):
        solver.set_warm_start(i > 0)
        t0 = time.perf_counter()
        solver.Solve(*(step[k] for k in keys))
        res.append(solver.GetSolution())
        walls.append(time.perf_counter() - t0)
    launches["dropin"] = counts()
    st = np.array([r.details.solve_status for r in res])
    n_iter = np.array([r.details.n_iter for r in res])
    want = HUMANOID_DROPIN_JAX_STATUSES
    log(f"[humanoid:dropin] FCCQP({n}, {shape.num_eq}, {shape.nc}, "
        f"{shape.lambda_c_start}) f64 engine, {len(seq)} steps at "
        + json.dumps(HUMANOID_DROPIN_OPTS) + f": kSuccess {(st == 0).sum()}, "
        f"kMaxIterations {(st == 1).sum()}, kFactorizationFailed "
        f"{(st == 2).sum()} (the JAX package on the CPU: {want[0]}, "
        f"{want[1]}); n_iter p50 {np.median(n_iter):.0f}, max "
        f"{n_iter.max()}; Solve+GetSolution wall p50 "
        f"{np.median(walls) * 1e3:.3f} ms; launches "
        + json.dumps(launches["dropin"]))
    check((st != 2).all(), "humanoid drop-in: kFactorizationFailed")
    check(abs(int((st == 0).sum()) - want[0]) <= 2,
          f"humanoid drop-in: kSuccess count {(st == 0).sum()} is not the "
          f"JAX package's {want[0]} (+-2)")
    check_dropin_steps("humanoid", seq, res, st, n)
    check(launches["dropin"]["admm_chunk_full_f64"] > 0,
          "humanoid drop-in: admm_chunk_full_f64 not launched")

    # (c) the reduced path over all 76 coordinates, two-phase: both
    # reduced kernels at k = 76, held to the JAX package's share on the
    # same instances less 1%
    full_split = two_phase.replace(splitting="full")
    pallas_admm.reset_launch_counts()
    t0 = time.perf_counter()
    (sol, _), rec_red = recorded_solve(
        engine, lambda: solve_batched_ds(qp, shape, full_split,
                                         graphs=False))
    torch.cuda.synchronize()
    launches["reduced"] = counts()
    st = q(sol.details.solve_status)
    log(f"[humanoid:reduced] two-phase, splitting='full', B={HUMANOID_B}: "
        f"{time.perf_counter() - t0:.3f} s (recorded); kSuccess "
        f"{(st == 0).sum()}, kMaxIterations {(st == 1).sum()}, "
        f"kFactorizationFailed {(st == 2).sum()}; launches "
        + json.dumps(launches["reduced"]))
    check(np.isfinite(q(sol.z)).all(), "humanoid reduced path: z not finite")
    bar = HUMANOID_REDUCED_JAX_SHARE_1024
    check((st == 0).mean() >= bar - 0.01,
          f"humanoid reduced path: kSuccess {(st == 0).mean():.4%} < the "
          f"JAX package's {bar:.4%} on the same instances less 1%")
    check((st != 2).all(), "humanoid reduced path: kFactorizationFailed")
    for name in REDUCED_KERNELS:
        got = rec_red[name].first
        check(got is not None and got[0][8].shape[0] == n,
              f"{name} did not run the humanoid at k = {n}")
    return launches, rec_full, rec_red


# kSuccess shares of the JAX package on the CPU on the first 512 instances
# of generate_osc_batch(CASSIE, 8192, seed=0) (exp_full_reference.py,
# sections alpha, adaptive, fast); the card's share on the same 512
# instances of its B = 8192 solve must reach it less 1% (on these paths
# the port's plain versions on the CPU give the JAX package's statuses
# instance for instance)
ALPHA_JAX_SHARE_512 = {"bench": 512 / 512, "full": 450 / 512}
ADAPTIVE_JAX_SHARE_512 = 512 / 512
FAST_JAX_SHARE_512 = {"adaptive": 509 / 512, "alpha": 510 / 512}
# the JAX f32 engine's share on all 8192 instances (section f32_8192): at
# eps 1e-6 the f32 iteration sits on the f32 floor and each instance's
# convergence is decided by rounding (407 of the first 512 in JAX, 422 in
# the port on the CPU, with 16 of the first 134 instances differing), so
# the card's share over the whole batch is held to the JAX share over the
# whole batch less 1%
F32_JAX_SHARE_8192 = 6437 / 8192
# serving: the JAX package's own server tests (tests/test_serving.py:19-24,
# :78-80) over a 64-step walking log, at every depth
SERVE_STEPS = 64
SERVE_DEPTHS = (1, 2, 4, 8)
SERVE_DS_OPTS = dict(max_iter=600, rho=0.05, eps_fcone=1e-6, eps_bound=1e-6,
                     presolve="operator", scaling=True,
                     splitting="constrained", kkt_refine_steps=1,
                     polish=True, polish_rounds=4, polish_newton_steps=4)
SERVE_F64_OPTS = dict(max_iter=2000, rho=1.0, eps_fcone=1e-6, eps_bound=1e-6)
# sharded solves: both engines at the JAX package's sharding-test options
# (tests/test_sharding.py:18, :135; on the ds engine that is the
# full-splitting path). The reduced path is not held there: its f32 seeds
# come from batched f32 products whose rounding moves with the batch size
# (a shard of 16 instances against the same 16 in a batch of 32, on the
# CPU: 3.8e-6 in the seed, one approach-phase iteration on one instance)
SHARD_OPTS = dict(max_iter=300, rho=1.0, eps_fcone=1e-4, eps_bound=1e-4)
# the parity engine's captured replay: over the drop-in's walking log at
# B = 1 (DROPIN_OPTS), and over streams of the bench's walking log at the
# JAX package's server-test options (tests/test_serving.py:19-24)
PARITY_REPLAY_STREAMS = 256
PARITY_REPLAY_STEPS = 16
PARITY_REPLAY_OPTS = dict(max_iter=2000, rho=1.0, eps_fcone=1e-6,
                          eps_bound=1e-6)


def counts():
    from fcc_qp_tpu_torch.ops import pallas_admm

    return {fn.__name__: fn.launches for fn in pallas_admm.KERNELS}


def reset_counts():
    from fcc_qp_tpu_torch.ops import pallas_admm

    pallas_admm.reset_launch_counts()


def share_check(tag, sol, bar, residual=True, first=None):
    """No kFactorizationFailed, no NaN, kSuccess residuals <= 1e-6, and the
    kSuccess share on the first ``first`` instances (all when None) at
    least ``bar`` less 1%. Returns the share over the whole batch and over
    those instances."""
    import numpy as np

    d = sol.details
    q = lambda t: t.cpu().numpy()
    st = q(d.solve_status)
    ok = st == 0
    rb, rc = q(d.admm_residual_bounds), q(d.admm_residual_friction_cone)
    check((st != 2).all(), f"{tag}: kFactorizationFailed")
    check(np.isfinite(q(sol.z)).all() and not np.isnan(rb).any()
          and not np.isnan(rc).any(), f"{tag}: NaN in the solution")
    if residual:
        check((np.maximum(rb, rc)[ok] <= 1e-6).all(),
              f"{tag}: kSuccess residual above 1e-6")
    held = ok[:first] if first else ok
    check(held.mean() >= bar - 0.01, f"{tag}: kSuccess {held.mean():.4%} on "
          f"the first {len(held)} < {bar - 0.01:.4%} (the JAX package's "
          f"{bar:.4%} on the same instances less 1%)")
    return float(ok.mean()), float(held.mean())


def timed_solves(solve, n=3):
    """``solve(stage_times)`` once to warm up, counted from zero (on a
    captured path this call captures, and a wrapper counts while the
    graphs are captured), then ``n`` timed solves, then one staged
    (uncaptured): ``(first timed solution, launches of the first call,
    walls, stages)``."""
    import torch

    reset_counts()
    solve(None)
    torch.cuda.synchronize()
    launches = counts()
    walls, sol = [], None
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = solve(None)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if sol is None:
            sol = out[0]
    stages = {}
    solve(stages)
    return sol, launches, walls, stages


def io_phase(stacked, warm_ds):
    """Phase 10: the replay's walking log as a packed .fqlog and both
    warm-start kinds through `utils.io` (the replay's final
    `WarmStartDS`, and the `WarmStart` of a parity-engine solve of the
    log's first 1024 steps), each reloaded bit for bit; the log's write
    and load seconds."""
    import numpy as np
    import torch

    from fcc_qp_tpu_torch import FCCQPOptions, solve_batched
    from fcc_qp_tpu_torch.models.osc import CASSIE
    from fcc_qp_tpu_torch.utils import io

    _, warm_f64 = solve_batched(
        io.to_qpbatch({k: v[:1024] for k, v in stacked.items()}),
        CASSIE.shape, FCCQPOptions(**SHARD_OPTS))

    d = os.path.join(ROOT, "test_data")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"chip_smoke_{os.getpid()}.fqlog")
    try:
        t0 = time.perf_counter()
        io.save_qp_log_packed(path, stacked)
        t_write = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        back = io.load_qp_log_packed(path)
        t_load = time.perf_counter() - t0
    finally:
        if os.path.exists(path):
            os.remove(path)
    for k in io.QP_KEYS:
        check(back[k].dtype == np.float64 and np.array_equal(
            back[k].view(np.uint64), stacked[k].view(np.uint64)),
            f"io: .fqlog field {k} did not reload bit for bit")
    for kind, w in (("WarmStartDS", warm_ds), ("WarmStart", warm_f64)):
        wp = os.path.join(d, f"chip_smoke_{os.getpid()}_{kind}.npz")
        try:
            io.save_warm_start(wp, w)
            w2 = io.load_warm_start(wp)
        finally:
            if os.path.exists(wp):
                os.remove(wp)
        check(type(w2).__name__ == kind, f"io: {kind} loaded as "
              f"{type(w2).__name__}")
        for f, a in (w._asdict() if hasattr(w, "_asdict")
                     else w.__dict__).items():
            b = getattr(w2, f)
            check(b.device == a.device and b.dtype == a.dtype
                  and torch.equal(a, b), f"io: {kind}.{f} did not reload "
                  f"bit for bit")
    T = stacked["b"].shape[0]
    log(f"[io] walking log T={T} as .fqlog: {size / 1e9:.3f} GB written in "
        f"{t_write:.3f} s, loaded in {t_load:.3f} s "
        f"({size / 1e9 / t_load:.3f} GB/s), bit for bit; WarmStartDS and "
        f"WarmStart (.npz) reloaded bit for bit on the card")
    return dict(fqlog_gb=size / 1e9, fqlog_write_s=t_write,
                fqlog_load_s=t_load)


def alpha_phase(engine, qp, bench, two_phase, specs, records):
    """Phase 11: over-relaxation, alpha = 1.6. Each kernel against its
    plain version bit for bit on an all-active first chunk at alpha 1.6
    (``*_alpha`` keys), then a cold Cassie solve at the bench flags and at
    FULL_OPTS with alpha 1.6, each counted from zero and held to the JAX
    package's share less 1%. Returns {path: launches}."""
    import numpy as np

    from fcc_qp_tpu_torch import FCCQPOptions, solve_batched_ds
    from fcc_qp_tpu_torch.models.osc import CASSIE
    from fcc_qp_tpu_torch.ops import pallas_admm

    shape = CASSIE.shape
    # all-active first chunks: the approach phase's first (two-phase), the
    # f64 endgame's first with no approach phase, the full engine's first
    _, rec_tp = recorded_solve(engine, lambda: solve_batched_ds(
        qp, shape, two_phase.replace(alpha=ALPHA), graphs=False))
    _, rec_eg = recorded_solve(engine, lambda: solve_batched_ds(
        qp, shape, two_phase.replace(alpha=ALPHA, phase1_tol=0.0,
                                     max_iter=64), graphs=False))
    full_alpha = FCCQPOptions(**dict(FULL_OPTS, alpha=ALPHA))
    _, rec_f = recorded_full(engine, lambda: solve_batched_ds(
        qp, shape, full_alpha, graphs=False))
    firsts = {"admm_chunk_f64": rec_eg, "admm_chunk_f32": rec_tp}
    for (name, kernel, plain, prec, _), r in zip(specs, records):
        args, kw = firsts[name][name].first
        check(kw.get("alpha") == float(np.float32(ALPHA)),
              f"{name}: the recorded chunk is not at alpha {ALPHA}")
        a = compare(name, "alpha", kernel, plain, args, kw, prec, exact=True)
        check(a["active"] == B, f"{name}: the alpha chunk is not all active")
        r.update(ms_alpha=a["ms"], plain_ms_alpha=a["plain_ms"],
                 bound_ms_alpha=a["bound_ms"], bound_by_alpha=a["bound_by"],
                 max_abs_err_alpha=a["max_abs_err"])
    fa = compare_full("alpha", pallas_admm.admm_chunk_full_f64,
                      pallas_admm.admm_chunk_full_f64_plain, *rec_f.first)
    check(fa["active"] == B, "the full engine's alpha chunk is not all active")

    launches, shares = {}, {}
    for tag, opts in (("bench", bench.replace(alpha=ALPHA)),
                      ("full", full_alpha)):
        sol, launches[tag], walls, stages = timed_solves(
            lambda st_: solve_batched_ds(qp, shape, opts, stage_times=st_))
        shares[tag], s512 = share_check(f"alpha:{tag}", sol,
                                        ALPHA_JAX_SHARE_512[tag], first=512)
        n = sol.details.n_iter.cpu().numpy()
        log(f"[alpha:{tag}] alpha {ALPHA}, Cassie B={B}: kSuccess "
            f"{shares[tag]:.4%}, on the first 512 {s512:.4%} (the JAX "
            f"package there: {ALPHA_JAX_SHARE_512[tag]:.4%}); n_iter p50 "
            f"{np.median(n):.0f}, max {n.max()}; median wall "
            f"{sorted(walls)[1]:.6f} s; stage seconds " + json.dumps(stages)
            + "; launches " + json.dumps(launches[tag]))
    # the f64 endgame runs only for instances the polish rejects
    check(launches["bench"]["admm_chunk_f32"] > 0,
          "alpha: admm_chunk_f32 was not launched at the bench flags")
    check(launches["full"]["admm_chunk_full_f64"] > 0,
          "alpha: admm_chunk_full_f64 was not launched")
    return launches, fa, shares


def adaptive_phase(qp, bench):
    """Phase 12: the reduced path with adaptive rho (bench.py
    --adaptive-rho) on the Cassie batch, counted from zero, held to the
    JAX package's share less 1%; its operator rebuilds."""
    import numpy as np

    from fcc_qp_tpu_torch import solve_batched_ds
    from fcc_qp_tpu_torch.models.osc import CASSIE

    opts = bench.replace(**ADAPTIVE)
    sol, launches, walls, stages = timed_solves(
        lambda st_: solve_batched_ds(qp, CASSIE.shape, opts, stage_times=st_))
    share, s512 = share_check("adaptive", sol, ADAPTIVE_JAX_SHARE_512,
                              first=512)
    n = sol.details.n_iter.cpu().numpy()
    log(f"[adaptive] bench flags + adaptive rho "
        + json.dumps(ADAPTIVE) + f", Cassie B={B}: kSuccess {share:.4%}, "
        f"on the first 512 {s512:.4%} (the JAX package there: "
        f"{ADAPTIVE_JAX_SHARE_512:.4%});"
        f" n_iter p50 {np.median(n):.0f}, max {n.max()}; operator rebuilds "
        f"{stages.get('n_refactor', 0)}; median wall {sorted(walls)[1]:.6f} "
        f"s; stage seconds " + json.dumps(stages) + "; launches "
        + json.dumps(launches))
    check(launches["admm_chunk_f32"] > 0,
          "adaptive: admm_chunk_f32 was not launched")
    return launches, share


def fast_phase(stacked):
    """Phase 13: the batch-level engine `solve_batched_fast` at B = 8192
    with adaptive rho, and with alpha = 1.6, each captured
    (`captured_path`, the rebuild body timed) and staged once
    (uncaptured): shares against the JAX package's less 1%, operator
    rebuilds and the time per solve."""
    import numpy as np
    import torch

    from fcc_qp_tpu_torch import FCCQPOptions, solve_batched_fast
    from fcc_qp_tpu_torch.core.batched import Given, fast_stages
    from fcc_qp_tpu_torch.models.osc import CASSIE
    from fcc_qp_tpu_torch.ops.kkt import admm_operator
    from fcc_qp_tpu_torch.utils.io import to_qpbatch

    qpb = to_qpbatch(stacked)
    launches, out = {}, {}
    for tag, o in (("adaptive", FAST_OPTS), ("alpha", FAST_ALPHA_OPTS)):
        opts = FCCQPOptions(**o)
        rho = torch.full((B,), opts.rho, dtype=torch.float64, device="cuda")
        sol, launches[tag], rep = captured_path(
            f"fast:{tag}", fast_stages(CASSIE.shape, opts),
            Given(qpb, rho, None),
            lambda g: solve_batched_fast(qpb, CASSIE.shape, opts, graphs=g),
            "admm_chunk_full_warp<double",
            rebuild=lambda: admm_operator(qpb.Q, qpb.b, qpb.A_eq, qpb.b_eq,
                                          rho, static=True))
        stages = {}
        solve_batched_fast(qpb, CASSIE.shape, opts, stage_times=stages)
        share, s512 = share_check(f"fast:{tag}", sol,
                                  FAST_JAX_SHARE_512[tag], first=512)
        n = sol.details.n_iter.cpu().numpy()
        wall = rep["replay_median_s"]
        out[tag] = dict(share=share, share_512=s512, wall_s=wall,
                        n_refactor=stages.get("n_refactor", 0), graphs=rep)
        log(f"[fast:{tag}] solve_batched_fast " + json.dumps(o)
            + f", Cassie B={B}: kSuccess {share:.4%}, on the first 512 "
            f"{s512:.4%} (the JAX package there: "
            f"{FAST_JAX_SHARE_512[tag]:.4%}); n_iter p50 "
            f"{np.median(n):.0f}, max {n.max()}; operator rebuilds "
            f"{out[tag]['n_refactor']}, one rebuild body "
            f"{rep['rebuild_body']['ms']:.6f} ms of device time; median wall "
            f"{wall:.6f} s captured ({B / wall:.1f} solves/s), eager "
            f"{rep['eager_median_s']:.6f} s; staged (uncaptured) stage "
            "seconds " + json.dumps(stages) + "; launches (capture) "
            + json.dumps(launches[tag]))
        check(out[tag]["n_refactor"] >= 1, f"fast:{tag}: rho never adapted")
        check(launches[tag]["admm_chunk_full_f64"] > 0,
              f"fast:{tag}: admm_chunk_full_f64 was not launched")
    return launches, out


def f32_phase(stacked, solver_mod):
    """Phase 14: the parity engine on f32 data (bench.py --engine f32) at
    B = 8192, captured (`captured_path`), held to the JAX f32 engine's
    share less 1%; then the f32 full-layout kernel against its plain
    version bit for bit on an uncaptured solve's one launch (every
    instance from its start to its stop)."""
    import numpy as np

    import torch

    from fcc_qp_tpu_torch import FCCQPOptions, solve_batched
    from fcc_qp_tpu_torch.core.solver import parity_stages
    from fcc_qp_tpu_torch.models.osc import CASSIE
    from fcc_qp_tpu_torch.ops import pallas_admm
    from fcc_qp_tpu_torch.utils.io import to_qpbatch

    q32 = to_qpbatch(stacked, dtype=torch.float32)
    opts = FCCQPOptions(**F32_OPTS)
    sol, launches, rep = captured_path(
        "f32", parity_stages(CASSIE.shape, opts, torch.float32), q32,
        lambda g: solve_batched(q32, CASSIE.shape, opts, graphs=g),
        "admm_chunk_full_warp<float")
    walls = rep["replay_walls"]
    check(sol.z.dtype == torch.float32, "f32 engine: z is not f32")
    share, _ = share_check("f32", sol, F32_JAX_SHARE_8192, residual=False)
    d = sol.details
    q = lambda t: t.cpu().numpy()
    ok = q(d.solve_status) == 0
    res = np.maximum(q(d.admm_residual_bounds),
                     q(d.admm_residual_friction_cone))
    check((res[ok] < np.float32(1e-6)).all(),
          "f32 engine: kSuccess residual at or above 1e-6")
    n = q(d.n_iter)
    wall = sorted(walls)[1]
    log(f"[f32] parity engine on f32 data " + json.dumps(F32_OPTS)
        + f", Cassie B={B}: kSuccess {share:.4%} (the JAX f32 engine on "
        f"the same {B}: {F32_JAX_SHARE_8192:.4%}); n_iter p50 "
        f"{np.median(n):.0f}, max {n.max()}; median wall {wall:.6f} s "
        f"captured ({B / wall:.1f} solves/s), eager "
        f"{rep['eager_median_s']:.6f} s; factorization_time "
        f"{float(d.factorization_time[0]):.6f} s; launches "
        + json.dumps(launches))
    check(launches["admm_chunk_full_f32"] > 0,
          "f32 engine: admm_chunk_full_f32 was not launched")
    check(launches["admm_chunk_full_f64"] == 0,
          "f32 engine: the f64 full-layout kernel ran on f32 data")
    _, rec = recorded_full(solver_mod, lambda: solve_batched(
        q32, CASSIE.shape, opts, graphs=False), name="admm_chunk_full_f32")
    k, p = pallas_admm.admm_chunk_full_f32, pallas_admm.admm_chunk_full_f32_plain
    check(rec.first is rec.last, "the f32 engine launched its kernel more "
          "than once in a solve")
    # the plain version of this launch takes seconds: timed once
    first = compare_full("f32_one_launch", k, p, *rec.first, plain_reps=1)
    check(first["active"] == B, "the f32 engine's launch is not all active")
    return launches, first, dict(share=share, wall_s=wall, graphs=rep)


# CUgraphNodeType (cuda.h)
NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph",
              5: "empty", 6: "wait_event", 7: "event_record",
              10: "mem_alloc", 11: "mem_free", 13: "conditional"}


def graph_node_types(handle):
    """The nodes of a CUDA graph (its ``cudaGraph_t`` as an int) counted
    by type, from `libcuda` (`cuGraphGetNodes`, `cuGraphNodeGetType`);
    None, with the reason printed, where it does not answer."""
    import ctypes

    try:
        cu = ctypes.CDLL("libcuda.so.1")
        graph, n = ctypes.c_void_p(handle), ctypes.c_size_t(0)
        r = cu.cuGraphGetNodes(graph, None, ctypes.byref(n))
        nodes = (ctypes.c_void_p * n.value)()
        if r == 0:
            r = cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n))
        out, kind = {}, ctypes.c_int()
        for node in nodes if r == 0 else ():
            r = r or cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                           ctypes.byref(kind))
            name = NODE_TYPES.get(kind.value, str(kind.value))
            out[name] = out.get(name, 0) + 1
        if r != 0:
            raise OSError(f"CUresult {r}")
        return out
    except (OSError, AttributeError) as e:
        log(f"[graphs] graph nodes not counted: {e}")
        return None


def graph_nodes_total(handles):
    """Nodes by type summed over graphs (a captured graph and the bodies
    of its IF nodes); None where `libcuda` does not answer."""
    total = {}
    for h in handles:
        c = graph_node_types(h)
        if c is None:
            return None
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    return total


def capture_report(cap, warm_start):
    """One capture of a `core.graphs.CapturedBatch`: its warm-up, capture
    and instantiate seconds, each graph's nodes by type (its IF bodies'
    included), the IF nodes and kernel nodes in all, and the hand
    kernels' launches in one replay (counted under capture)."""
    nodes = {stage: graph_nodes_total(h)
             for stage, h in cap.graph_handles[warm_start].items()}
    total = lambda kind: (None if None in nodes.values() else
                          sum(n.get(kind, 0) for n in nodes.values()))
    return dict(seconds=cap.capture_seconds[warm_start], nodes=nodes,
                if_nodes=total("conditional"), kernel_nodes=total("kernel"),
                launches=cap.capture_launches[warm_start])


TIME_FIELDS = ("solve_time", "factorization_time")


def check_same_solution(tag, got, want):
    """z and every diagnostic but the two times bit for bit."""
    import dataclasses

    import torch

    for f in dataclasses.fields(want.details):
        if f.name not in TIME_FIELDS:
            check(torch.equal(getattr(got.details, f.name),
                              getattr(want.details, f.name)),
                  f"{tag}: {f.name} differs")
    check(torch.equal(got.z, want.z), f"{tag}: z differs")


def check_like_eager(tag, got, eager, dz_bar=1e-9):
    """Statuses equal to the eager (reading) solve's, |dz| within the bar;
    returns |dz| and the instances whose n_iter differs."""
    import torch

    check(torch.equal(got.details.solve_status, eager.details.solve_status),
          f"{tag}: statuses differ from the eager solve")
    dz = float((got.z - eager.z).abs().max())
    check(dz <= dz_bar, f"{tag}: |dz| {dz:.3e} to the eager solve > "
          f"{dz_bar:.0e}")
    return dz, int((got.details.n_iter != eager.details.n_iter).sum())


def timed_walls(run, n=3):
    """Walls of ``n`` calls of ``run`` (each synchronized) and the first
    call's result."""
    import torch

    walls, first = [], None
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        first = out if first is None else first
    return walls, first


def captured_cold_phase(engine, qp, bench):
    """Phase 2's main path: the bench-flag Cassie solve at B = 8192
    through `solve_batched_ds`, which captures at its first call and
    replays after. Counted from zero over the capturing call (on a
    captured path a wrapper counts while the graphs are captured: each
    launch is a kernel node of them). Then three timed replays (equal to
    the first bit for bit), the eager (reading) path's three timed solves
    in the same call, and the uncaptured static solve under cuSOLVER:
    the replays equal it bit for bit and the eager solve by status and
    |dz| <= 1e-9, and no static loop ends with work pending. Returns
    ``(solution, launches, replay walls, report)``."""
    import torch

    from fcc_qp_tpu_torch import solve_batched_ds
    from fcc_qp_tpu_torch.core.graphs import CapturedBatch, captured_batch
    from fcc_qp_tpu_torch.models.osc import CASSIE
    from fcc_qp_tpu_torch.ops import device_branch, pallas_admm

    shape = CASSIE.shape
    ci = engine.constrained_indices(qp, shape)
    flag = device_branch.exhausted_flag("cuda")
    flag.fill_(False)
    pallas_admm.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    sol, _ = solve_batched_ds(qp, shape, bench)
    torch.cuda.synchronize()
    first_call = time.perf_counter() - t0
    launches = counts()
    peak_gb = (torch.cuda.max_memory_allocated() - mem0) / 1e9
    cap = captured_batch(engine.reduced_stages(shape, bench, ci), qp.batch,
                         "cuda")
    check(False in cap._captured, "bench: the solve was not captured")
    rep = capture_report(cap, False)
    walls, _ = timed_walls(lambda: solve_batched_ds(qp, shape, bench))
    again, _ = solve_batched_ds(qp, shape, bench)
    check_same_solution("bench: a later replay", again, sol)
    eager_walls, (eager, _) = timed_walls(
        lambda: solve_batched_ds(qp, shape, bench, graphs=False))
    static = CapturedBatch(engine.reduced_stages(shape, bench, ci), qp.batch,
                           "cuda", graphs=False)
    static.load(qp)
    t0 = time.perf_counter()
    static.run(False)
    torch.cuda.synchronize()
    static_wall = time.perf_counter() - t0
    check(not bool(flag), "bench: a static gathered loop ended with work "
          "pending (its bound is too small)")
    check_same_solution("bench: graph replay vs the uncaptured static "
                        "solve", sol, static.out)
    dz, dn = check_like_eager("bench: graph replay", sol, eager)
    rep.update(first_call_s=first_call, peak_allocated_gb=peak_gb,
               replay_walls=walls, replay_median_s=sorted(walls)[1],
               eager_walls=eager_walls, eager_median_s=sorted(eager_walls)[1],
               static_wall_s=static_wall, max_dz_to_eager=dz,
               n_iter_differs_from_eager=dn,
               solve_time_s=float(sol.details.solve_time[0]),
               factorization_time_s=float(sol.details.factorization_time[0]))
    log("[bench:graphs] B=8192 captured at the first call "
        f"({first_call:.3f} s, peak {peak_gb:.3f} GB allocated); replay "
        f"median {rep['replay_median_s']:.6f} s against the eager path's "
        f"{rep['eager_median_s']:.6f} s (same call); bit for bit the "
        f"uncaptured static solve ({static_wall:.3f} s); statuses of the "
        f"eager solve, |dz| {dz:.3e}, n_iter differs on {dn}; exhausted "
        "flag clear; capture " + json.dumps(rep))
    return sol, launches, walls, rep


def body_graph_ms(fn, reps=5):
    """One call of ``fn`` (a rebuild: the body of a captured path's IF
    node) captured as a CUDA graph of its own under cuSOLVER, its IF
    nodes included: the device milliseconds of one replay (median of
    ``reps``, CUDA events) and its kernel and IF nodes."""
    import torch

    from fcc_qp_tpu_torch.core.graphs import _cusolver
    from fcc_qp_tpu_torch.ops.device_branch import body_graphs, forget_owned

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with _cusolver(), torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph(keep_graph=True)
    n0 = len(body_graphs)
    with _cusolver(), torch.cuda.graph(g):
        out = fn()
    forget_owned()
    nodes = graph_nodes_total([g.raw_cuda_graph()] + body_graphs[n0:])
    g.instantiate()
    ms = []
    for _ in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        g.replay()
        ev[1].record()
        ev[1].synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
    del out, g
    return dict(ms=sorted(ms[1:])[reps // 2],
                kernel_nodes=nodes and nodes.get("kernel", 0),
                if_nodes=nodes and nodes.get("conditional", 0))


# profiled calls of one path at most: a trace can lose kernel records
# (the same captured solve profiled 25 times in a row traced 5, 5, ...,
# 3, 2 of its kernels; late in a long run one trace held none of its 6),
# so a call whose trace holds no kernel of the path is profiled again
PROFILED_CALLS = 3


def profiled_host_reads(run, inst):
    """``run()`` under `torch.profiler`: its host reads
    (``aten::_local_scalar_dense``) and the kernels in its trace whose
    name holds ``inst``. Until a trace holds such a kernel, up to
    `PROFILED_CALLS` calls are profiled, each in a profiler session of
    its own; ``host_reads`` sums every profiled call's, ``traced_kernels``
    is the last trace's count, ``profiled_calls`` how many ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    reads = 0
    for calls in range(1, PROFILED_CALLS + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        ev = prof.events()
        reads += sum(e.name == "aten::_local_scalar_dense"
                     for e in ev if e.device_type != cuda)
        traced = sum(inst in e.name for e in ev if e.device_type == cuda)
        if traced:
            break
    return dict(host_reads=reads, traced_kernels=traced,
                profiled_calls=calls)


def captured_path(tag, stages, qp, solve, inst, rebuild=None):
    """The checks of a path that the entry point captures at its first
    call on the card (`core.graphs.solve_captured`): ``solve(graphs)``
    calls the entry point on ``qp`` (``graphs=None``: the capture,
    ``False``: the eager, reading path). Counted from zero over the
    capturing call (a wrapper counts while the graphs are captured); the
    capture's seconds, nodes by type (IF bodies included, IF nodes
    counted), hand kernels per graph and peak memory; three timed
    replays (a later one equal to the first bit for bit) beside three
    eager solves in the same call; the uncaptured static solve under
    cuSOLVER (`CapturedBatch` with graphs off) held bit for bit, the
    eager solve by statuses and n_iter equal and |dz| <= 1e-9; no static
    loop ends with work pending; one profiled call of the captured entry
    point with no host read and the path's full-layout kernel ``inst``
    in its trace; ``rebuild()``, where given, the adaptive-rho rebuild
    that the graphs hold in IF bodies, timed as a graph of its own
    (`body_graph_ms`). Returns ``(solution, launches, report)``."""
    import torch

    from fcc_qp_tpu_torch.core.graphs import (CapturedBatch, _batch,
                                              captured_batch)
    from fcc_qp_tpu_torch.ops import device_branch

    flag = device_branch.exhausted_flag("cuda")
    flag.fill_(False)
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    sol, _ = solve(None)
    torch.cuda.synchronize()
    first_call = time.perf_counter() - t0
    launches = counts()
    peak_gb = (torch.cuda.max_memory_allocated() - mem0) / 1e9
    Bq = _batch(qp)
    cap = captured_batch(stages, Bq, "cuda")
    check(False in cap._captured, f"{tag}: the solve was not captured")
    rep = capture_report(cap, False)
    walls, _ = timed_walls(lambda: solve(None))
    again, _ = solve(None)
    check_same_solution(f"{tag}: a later replay", again, sol)
    eager_walls, (eager, _) = timed_walls(lambda: solve(False))
    static = CapturedBatch(stages, Bq, "cuda", graphs=False)
    static.load(qp)
    t0 = time.perf_counter()
    static.run(False)
    torch.cuda.synchronize()
    static_wall = time.perf_counter() - t0
    check(not bool(flag), f"{tag}: a static loop ended with work pending")
    check_same_solution(f"{tag}: graph replay vs the uncaptured static "
                        "solve", sol, static.out)
    dz, dn = check_like_eager(f"{tag}: graph replay", sol, eager)
    check(dn == 0, f"{tag}: n_iter differs from the eager solve on {dn} "
          "instances")
    prof = profiled_host_reads(lambda: solve(None), inst)
    check(prof["host_reads"] == 0, f"{tag}: {prof['host_reads']} host reads "
          "in a captured call")
    check(prof["traced_kernels"] > 0, f"{tag}: no {inst} kernel in the "
          "trace of a captured call")
    rep.update(first_call_s=first_call, peak_allocated_gb=peak_gb,
               replay_walls=walls, replay_median_s=sorted(walls)[1],
               eager_walls=eager_walls, eager_median_s=sorted(eager_walls)[1],
               static_wall_s=static_wall, max_dz_to_eager=dz,
               bit_equal_to_eager=_same_bits(sol, eager),
               solve_time_s=float(sol.details.solve_time[0]),
               factorization_time_s=float(sol.details.factorization_time[0]),
               profiled=prof)
    if rebuild is not None:
        rep["rebuild_body"] = body_graph_ms(rebuild)
    log(f"[{tag}:graphs] B={Bq} captured at the first call "
        f"({first_call:.3f} s, peak {peak_gb:.3f} GB allocated); replay "
        f"median {rep['replay_median_s']:.6f} s against the eager path's "
        f"{rep['eager_median_s']:.6f} s (same call); bit for bit the "
        f"uncaptured static solve ({static_wall:.3f} s); the eager solve's "
        f"statuses and n_iter, |dz| {dz:.3e}; a captured call profiled: "
        f"{prof['host_reads']} host reads, {prof['traced_kernels']} {inst} "
        "kernels traced; capture " + json.dumps(rep))
    return sol, launches, rep


def _same_bits(got, want):
    """Whether z and every diagnostic but the two times are equal."""
    import dataclasses

    import torch

    return torch.equal(got.z, want.z) and all(
        torch.equal(getattr(got.details, f.name),
                    getattr(want.details, f.name))
        for f in dataclasses.fields(want.details)
        if f.name not in TIME_FIELDS)


def capture_census(engine, opts, qp):
    """The captured solve of ``qp`` (a serving log's first step) made
    afresh with the kernel counters read around each of its stages: the
    hand kernels' launches in one replay of the cold and of the warm
    graphs, counted under capture (each launch is one kernel node of the
    graph, run or skipped by its IF node), checked equal to the
    warm-up's; and each graph's nodes by type from `libcuda`
    (`graph_node_types`, the graphs kept for it, their IF bodies'
    nodes included)."""
    import torch

    from fcc_qp_tpu_torch.core.graphs import (CapturedSolve, SolveBuffers,
                                              classify, engine_options,
                                              layout, pack_host)
    from fcc_qp_tpu_torch.models.osc import CASSIE

    shape = CASSIE.shape
    opts = engine_options(opts, engine)
    host = torch.empty((layout(shape)[-1],), dtype=torch.float64)
    pack_host(shape, [qp[k] for k in KEYS], host)
    solve = CapturedSolve(shape, opts, engine,
                          SolveBuffers(shape, engine, "cuda", opts.rho),
                          classify(shape, engine, host))
    from fcc_qp_tpu_torch.ops.device_branch import body_graphs

    calls, bodies = [], {}

    def counted(fn):
        def run(*args):
            before, n0 = counts(), len(body_graphs)
            out = fn(*args)
            after = counts()
            capturing = torch.cuda.is_current_stream_capturing()
            calls.append((args[-1], capturing,
                          {k: after[k] - before[k] for k in after}))
            if capturing:
                bodies[args[-1], fn.__name__] = body_graphs[n0:]
            return out
        return run

    solve._prepare = counted(solve._prepare)
    solve._iterate = counted(solve._iterate)
    graph_cls = torch.cuda.CUDAGraph
    try:
        graph_cls(keep_graph=True)
        keep = True
    except TypeError:
        keep = False
        log("[graphs] graph nodes not counted: this torch keeps no graph")
    if keep:
        torch.cuda.CUDAGraph = lambda: graph_cls(keep_graph=True)
    try:
        solve.buffers.inp.copy_(host)
        solve.run(warm_start=False)
        torch.cuda.synchronize()
    finally:
        torch.cuda.CUDAGraph = graph_cls
    check_captured(f"capture census {engine}", [solve])
    per = {}
    for warm in (False, True):
        for captured in (False, True):
            tot = {}
            for w, cap, d in calls:
                if (w, cap) == (warm, captured):
                    tot = {k: tot.get(k, 0) + v for k, v in d.items()}
            per[warm, captured] = tot
        check(per[warm, True] == per[warm, False], f"capture census {engine}: "
              f"the graph's launches {per[warm, True]} are not the warm-up's "
              f"{per[warm, False]}")
    nodes = None
    if keep:
        nodes = {("warm" if w else "cold"): {
            stage: graph_nodes_total([g.raw_cuda_graph()]
                                     + bodies[w, fn_name])
            for stage, fn_name, g in zip(("operator", "iteration"),
                                         ("_prepare", "_iterate"),
                                         solve._captured[w][:2])}
            for w in (False, True)}
    return dict(cold=per[False, True], warm=per[True, True], nodes=nodes)


def profile_submits(server, seq, engine):
    """A submit loop under `torch.profiler`, after the server's first
    submit (the capture) retired outside the trace: the host reads
    (``aten::_local_scalar_dense``), the synchronizations outside a
    ``FCCQPServer.retire`` range, and per submit the graph launches, and
    the kernel launches, the hand kernels' launches and the kernels'
    summed durations the trace shows (``traced_*``: a lower bound, as a
    trace can lose kernel records; the durations inflated by the
    profiler's per-kernel cost)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    server.result(server.submit(*(seq[0][k] for k in KEYS)))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("submit_loop"):
            for qp in seq[1:]:
                server.submit(*(qp[k] for k in KEYS))
            results = [r for _, r in server.drain()]
    n = len(seq) - 1
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    cpu = [e for e in events if e.device_type != cuda]
    spans = {name: [(r.time_range.start, r.time_range.end) for r in cpu
                    if r.name == name]
             for name in ("submit_loop", "FCCQPServer.retire")}
    within = lambda e, name: any(s0 <= e.time_range.start <= s1
                                 for s0, s1 in spans[name])
    # the synchronizations of the loop (the profiler's own, at its start
    # and stop, fall outside it)
    syncs = [e for e in cpu if "Synchronize" in e.name
             and within(e, "submit_loop")]
    outside = [e.name for e in syncs if not within(e, "FCCQPServer.retire")]
    kernels = [e for e in events if e.device_type == cuda
               and not e.name.startswith(("Memcpy", "Memset"))]
    hand = {name: sum(name in e.name for e in kernels)
            for name in GRAPH_KERNELS[engine]}
    # which hand kernels the solves ran (an IF body a replay skips
    # launches none of its kernels): the approach / polish chunks where
    # an f32 iteration ran, the endgame's where an f64 one did, the full
    # layout's in every f64-engine solve
    ran = ({"admm_chunk_warp<float": sum(r.details.n_iter_f32 > 0
                                         for r in results),
            "admm_chunk_warp<double": sum(r.details.n_iter_ds > 0
                                          for r in results)}
           if engine == "ds" else {k: n for k in GRAPH_KERNELS[engine]})
    return dict(
        submits=n,
        retires=sum(e.name == "FCCQPServer.retire" for e in cpu),
        host_reads=sum(e.name == "aten::_local_scalar_dense" for e in cpu),
        syncs=len(syncs), syncs_outside_retire=len(outside),
        sync_names_outside_retire=sorted(set(outside)),
        graph_launches_per_submit=sum(e.name == "cudaGraphLaunch"
                                      for e in cpu) / n,
        traced_kernels_per_submit=len(kernels) / n,
        traced_hand_kernels_per_submit={k: v / n for k, v in hand.items()},
        traced_hand_kernel_names=sorted({e.name[:120] for e in kernels
                                         if "admm_chunk" in e.name}),
        hand_kernels_ran=ran,
        profiled_kernel_ms_per_submit=sum(
            e.time_range.end - e.time_range.start for e in kernels)
        * 1e-3 / n)


def serving_phase():
    """Phase 16: `FCCQPServer` over a 64-step walking log at depth 1, 2, 4
    and 8 on both engines, replaying its captured graphs: each run equal
    to the serial `FCCQP` loop (statuses equal, |dz| <= 1e-9 on ds,
    <= 1e-8 on f64: the JAX package's server bars) and both bit for bit
    to the eager static solve; ms per result (submit to retire) p50 / p95
    and results per second per depth beside the eager solves'; a
    profiled submit loop per depth (`profile_submits`)."""
    import numpy as np

    from fcc_qp_tpu_torch import FCCQP, FCCQPOptions, FCCQPServer
    from fcc_qp_tpu_torch.models.osc import CASSIE, generate_osc_sequence

    seq = generate_osc_sequence(CASSIE, SERVE_STEPS, seed=1)
    launches, table, traces, census = {}, {}, {}, {}
    for engine, o, dz_bar in (("ds", SERVE_DS_OPTS, 1e-9),
                              ("f64", SERVE_F64_OPTS, 1e-8)):
        opts = FCCQPOptions(**o)
        census[engine] = c = capture_census(engine, opts, seq[0])
        kernel_nodes = (None if c["nodes"] is None or None in (
            c["nodes"]["warm"]["operator"], c["nodes"]["warm"]["iteration"])
            else sum(c["nodes"]["warm"][g].get("kernel", 0)
                     for g in ("operator", "iteration")))
        c["kernel_nodes_warm"] = kernel_nodes
        check(kernel_nodes is None or kernel_nodes >= sum(c["warm"].values()),
              f"capture census {engine}: {kernel_nodes} kernel nodes, fewer "
              f"than the hand kernels' launches {c['warm']}")
        log(f"[graphs:{engine}] capture census: hand kernels per replay "
            f"(counted under capture) cold {json.dumps(c['cold'])}, warm "
            f"{json.dumps(c['warm'])}; kernel nodes in the warm graphs "
            f"{kernel_nodes}; nodes by type " + json.dumps(c["nodes"]))
        t0 = time.perf_counter()
        ref = eager_static_chain(engine, opts, seq)
        static_wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        eager_walls, eager_rows = eager_dropin_walls(engine, opts, seq)
        eager_wall = time.perf_counter() - t0
        solver = FCCQP(60, 38, 12, 38, engine=engine)
        solver.set_options(opts)
        res = []
        t0 = time.perf_counter()
        for i, qp in enumerate(seq):
            solver.set_warm_start(i > 0)
            solver.Solve(*(qp[k] for k in KEYS))
            res.append(solver.GetSolution())
        serial_wall = time.perf_counter() - t0
        check_captured(f"serving {engine} serial loop",
                       solver._captures.values())
        check_bit_equal(f"serving {engine} serial FCCQP loop",
                        packed_results(res, 60), ref)
        same, dz_eager = check_against_eager(
            f"serving {engine} serial FCCQP loop", engine,
            packed_results(res, 60), eager_rows, dz_bar)
        z_ref = np.stack([r.z for r in res])
        st_ref = np.array([r.details.solve_status for r in res])
        table[engine] = {
            "serial_results_per_s": SERVE_STEPS / serial_wall,
            "eager_static_results_per_s": SERVE_STEPS / static_wall,
            "eager_results_per_s": SERVE_STEPS / eager_wall,
            "eager_p50_ms": float(np.median(eager_walls) * 1e3),
            "bit_equal_to_eager": same, "max_dz_to_eager": dz_eager,
            "kSuccess": int((st_ref == 0).sum())}
        for depth in SERVE_DEPTHS:
            server = FCCQPServer(CASSIE.shape, opts, depth=depth,
                                 engine=engine)
            reset_counts()
            t0 = time.perf_counter()
            tickets = [server.submit(*(seq[0][k] for k in KEYS))]
            t_capture = time.perf_counter() - t0
            tickets += [server.submit(*(qp[k] for k in KEYS))
                        for qp in seq[1:]]
            results = dict(server.drain())
            wall = time.perf_counter() - t0
            # the first submit captures (and queues the first replay)
            steady = (SERVE_STEPS - 1) / (wall - t_capture)
            launches[f"{engine}_d{depth}"] = counts()
            check_captured(f"serving {engine} depth {depth}", [server._solve])
            check(sorted(results) == tickets,
                  f"serving {engine} depth {depth}: tickets out of order")
            got = [results[t] for t in tickets]
            check_bit_equal(f"serving {engine} depth {depth}",
                            packed_results(got, 60), ref)
            z = np.stack([r.z for r in got])
            st = np.array([r.details.solve_status for r in got])
            ms = np.array([r.details.solve_time for r in got]) * 1e3
            dz = float(np.abs(z - z_ref).max())
            check(np.array_equal(st, st_ref),
                  f"serving {engine} depth {depth}: statuses differ from "
                  f"the serial loop")
            check(dz <= dz_bar, f"serving {engine} depth {depth}: |dz| "
                  f"{dz:.3e} > {dz_bar:.0e}")
            trace = profile_submits(
                FCCQPServer(CASSIE.shape, opts, depth=depth, engine=engine),
                seq[:PROFILED_SUBMITS + 1], engine)
            if depth == 1:
                # a replay's device time: the warm graphs replayed back to
                # back behind a spin kernel (this server's chain, dropped)
                trace["replay_device_ms"], _ = time_cuda(
                    lambda: server._solve.run(warm_start=True), reps=20)
            traces[f"{engine}_d{depth}"] = trace
            log(f"[graphs:{engine}] profiled submit loop, depth {depth}: "
                + json.dumps(trace))
            check(trace["host_reads"] == 0,
                  f"serving {engine} depth {depth}: {trace['host_reads']} "
                  f"host reads in the profiled submit loop")
            check(trace["syncs_outside_retire"] == 0,
                  f"serving {engine} depth {depth}: a synchronization "
                  f"outside a retire: {trace['sync_names_outside_retire']}")

            table[engine][depth] = dict(
                p50_ms=float(np.median(ms)),
                p95_ms=float(np.percentile(ms, 95)),
                results_per_s=SERVE_STEPS / wall,
                results_per_s_after_capture=steady,
                first_submit_s=t_capture, max_dz=dz)
        log(f"[serving:{engine}] FCCQPServer over {SERVE_STEPS} steps, "
            "captured, equal to the serial FCCQP loop at every depth "
            f"(statuses, |dz| <= {dz_bar:.0e}) and bit for bit to the eager "
            "static solve; per depth, ms per result (submit to retire) and "
            "results/s (the first submit captures), beside the serial graph "
            "loop, the eager static solve and the eager (uncaptured) "
            "solve: " + json.dumps(table[engine]))
        log(f"[graphs:{engine}] profiled submit loops ({PROFILED_SUBMITS} "
            "submits after the capture), per depth: "
            + json.dumps({k: v for k, v in traces.items()
                          if k.startswith(engine)}))
        # the trace of a graph with IF nodes names fewer of its kernels
        # than run, by an amount that differs between identical submit
        # loops (ds: 1.83 against 6.58 f32 chunks a submit at different
        # depths, the solves bit for bit equal): each hand kernel the
        # profiled solves ran must be named in the traces of the depths
        # together
        mine = [t for k, t in traces.items() if k.startswith(engine)]
        for name in GRAPH_KERNELS[engine]:
            if any(t["hand_kernels_ran"][name] for t in mine):
                check(any(t["traced_hand_kernels_per_submit"][name] > 0
                          for t in mine),
                      f"serving {engine}: no trace names {name}, which the "
                      "profiled solves ran")
    check(launches["f64_d1"]["admm_chunk_full_f64"] > 0,
          "serving f64: admm_chunk_full_f64 was not launched")
    check(launches["ds_d1"]["admm_chunk_f32"] > 0,
          "serving ds: admm_chunk_f32 was not launched")
    return launches, table, traces, census


def _stacked_steps(sols, single):
    """Per-step solutions (each batch-leading) stacked over time as
    `replay` stacks them (the batch axis dropped for a single
    sequence)."""
    import dataclasses

    import torch

    from fcc_qp_tpu_torch.types import FCCQPDetails, FCCQPSolution

    pick = (lambda a: a[0]) if single else (lambda a: a)
    det = FCCQPDetails(**{
        f.name: torch.stack([pick(getattr(s.details, f.name)) for s in sols])
        for f in dataclasses.fields(FCCQPDetails)})
    return FCCQPSolution(details=det,
                         z=torch.stack([pick(s.z) for s in sols]))


def parity_replay_phase(walking):
    """Phase 15: the parity engine's `replay` on the card, captured (the
    JAX package's ``lax.scan``: the cold graphs at step 0, the warm graphs
    replayed at every later step, the warm state in static buffers), over
    the drop-in's 200-step walking log at B = 1 (`DROPIN_OPTS`) and over
    `PARITY_REPLAY_STREAMS` streams x `PARITY_REPLAY_STEPS` steps of the
    bench's walking log (`PARITY_REPLAY_OPTS`). For each, counted from
    zero over the capturing replay: both captures' seconds, nodes and
    hand kernels per graph, peak memory; three timed replays (a later one
    bit for bit the first) beside three eager replays in the same call;
    the uncaptured static chain under cuSOLVER held bit for bit, the eager
    replay by statuses and n_iter equal and |dz| <= 1e-9; one profiled
    replay with no host read and `admm_chunk_full_f64` in its trace.
    Returns ``(launches per log, report)``."""
    import numpy as np
    import torch

    from fcc_qp_tpu_torch import FCCQPOptions, QPBatch, replay
    from fcc_qp_tpu_torch.core.graphs import CapturedBatch, captured_batch
    from fcc_qp_tpu_torch.core.solver import parity_stages
    from fcc_qp_tpu_torch.models.osc import CASSIE, generate_osc_sequence
    from fcc_qp_tpu_torch.utils.io import stack_qp_dicts, to_qpbatch

    shape = CASSIE.shape
    S, T = PARITY_REPLAY_STREAMS, PARITY_REPLAY_STEPS
    # stream s owns global steps [s T, (s + 1) T): time first, then streams
    streams = {k: np.ascontiguousarray(np.swapaxes(
        v[:S * T].reshape(S, T, *v.shape[1:]), 0, 1))
        for k, v in walking.items()}
    logs = (("b1", to_qpbatch(stack_qp_dicts(generate_osc_sequence(
                CASSIE, DROPIN_STEPS, seed=0))), DROPIN_OPTS),
            ("streams", to_qpbatch(streams), PARITY_REPLAY_OPTS))
    launches, report = {}, {}
    for tag, log_qp, o in logs:
        opts = FCCQPOptions(**o)
        single = log_qp.b.dim() == 2
        Bq = 1 if single else log_qp.b.shape[1]
        steps = log_qp.b.shape[0]
        stages = parity_stages(shape, opts)
        run = lambda graphs=None: replay(log_qp, shape, opts, graphs=graphs)
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        sol, _ = run()
        torch.cuda.synchronize()
        first_call = time.perf_counter() - t0
        launches[tag] = counts()
        peak_gb = (torch.cuda.max_memory_allocated() - mem0) / 1e9
        cap = captured_batch(stages, Bq, "cuda")
        check(False in cap._captured and True in cap._captured,
              f"replay:{tag}: the cold and warm solves were not captured")
        rep = {w: capture_report(cap, k) for w, k in (("cold", False),
                                                      ("warm", True))}
        walls, _ = timed_walls(run)
        again, _ = run()
        check_same_solution(f"replay:{tag}: a later replay", again, sol)
        eager_walls, (eager, _) = timed_walls(lambda: run(False))
        static = CapturedBatch(stages, Bq, "cuda", graphs=False)
        outs = []
        t0 = time.perf_counter()
        for t in range(steps):
            step = QPBatch(*(a[t][None] if single else a[t]
                             for a in log_qp.__dict__.values()))
            static.load(step)
            static.run(t > 0)
            outs.append(static.result()[0])
        torch.cuda.synchronize()
        static_wall = time.perf_counter() - t0
        check_same_solution(f"replay:{tag}: graph replays vs the "
                            "uncaptured static chain", sol,
                            _stacked_steps(outs, single))
        dz, dn = check_like_eager(f"replay:{tag}: graph replays", sol, eager)
        check(dn == 0, f"replay:{tag}: n_iter differs from the eager replay "
              f"on {dn} steps")
        prof = profiled_host_reads(run, "admm_chunk_full_warp<double")
        check(prof["host_reads"] == 0, f"replay:{tag}: "
              f"{prof['host_reads']} host reads in a captured replay")
        check(prof["traced_kernels"] > 0, f"replay:{tag}: no "
              "admm_chunk_full_f64 kernel in a captured replay's trace")
        check(launches[tag]["admm_chunk_full_f64"] > 0, f"replay:{tag}: "
              "admm_chunk_full_f64 was not launched")
        st = sol.details.solve_status.cpu().numpy()
        check((st != 2).all(), f"replay:{tag}: kFactorizationFailed")
        check(np.isfinite(sol.z.cpu().numpy()).all(),
              f"replay:{tag}: z not finite")
        rep.update(B=Bq, steps=steps, first_call_s=first_call,
                   peak_allocated_gb=peak_gb, replay_walls=walls,
                   replay_median_s=sorted(walls)[1], eager_walls=eager_walls,
                   eager_median_s=sorted(eager_walls)[1],
                   static_wall_s=static_wall, max_dz_to_eager=dz,
                   bit_equal_to_eager=_same_bits(sol, eager),
                   kSuccess=int((st == 0).sum()), profiled=prof)
        report[tag] = rep
        log(f"[replay:{tag}] parity replay, B={Bq} x {steps} steps "
            + json.dumps(o) + f": kSuccess {(st == 0).sum()} of {st.size}; "
            f"captured at the first replay ({first_call:.3f} s, peak "
            f"{peak_gb:.3f} GB); replay median {rep['replay_median_s']:.6f} "
            f"s against the eager replay's {rep['eager_median_s']:.6f} s "
            f"(same call); bit for bit the uncaptured static chain "
            f"({static_wall:.3f} s); the eager replay's statuses and n_iter, "
            f"|dz| {dz:.3e}; a captured replay profiled: "
            f"{prof['host_reads']} host reads, {prof['traced_kernels']} "
            "admm_chunk_full_f64 kernels traced; captures "
            + json.dumps(rep))
    return launches, report


def sharded_captured(kind, stages, qp, sharded, eager_solve, inst):
    """The captured checks of a two-shard solve on the one card at B =
    8192 (`sharded()`; its shards of 4096 share one capture, which its
    first call makes): counted from zero over the capturing call; the
    capture's seconds, nodes, hand kernels per graph and peak memory;
    three timed sharded calls beside three eager unsharded solves
    (``eager_solve()``) in the same call; each shard's uncaptured static
    solve under cuSOLVER held bit for bit, the eager solve by statuses
    and n_iter equal and |dz| <= 1e-9; one profiled sharded call with no
    host read and the full-layout kernel ``inst`` in its trace. Returns
    ``(launches, report)``."""
    import torch

    from fcc_qp_tpu_torch.core.ds_engine import QPBatchDS
    from fcc_qp_tpu_torch.core.graphs import CapturedBatch, captured_batch
    from fcc_qp_tpu_torch.types import FCCQPDetails, FCCQPSolution

    tag = f"sharded:{kind}"
    half = B // 2
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    sol, _, _ = sharded()
    torch.cuda.synchronize()
    first_call = time.perf_counter() - t0
    launches = counts()
    peak_gb = (torch.cuda.max_memory_allocated() - mem0) / 1e9
    cap = captured_batch(stages, half, "cuda")
    check(False in cap._captured, f"{tag}: the shards were not captured")
    rep = capture_report(cap, False)
    walls, _ = timed_walls(sharded)
    eager_walls, (eager, _) = timed_walls(eager_solve)
    static = CapturedBatch(stages, half, "cuda", graphs=False)
    outs = []
    for lo in (0, half):
        if isinstance(qp, QPBatchDS):
            static.load(QPBatchDS(*(a[..., lo:lo + half] for a in qp)))
        else:
            static.load(type(qp)(*(a[lo:lo + half]
                                   for a in qp.__dict__.values())))
        static.run(False)
        outs.append(static.result()[0])
    cat = lambda *a: torch.cat(a, dim=0)
    both = FCCQPSolution(details=FCCQPDetails(**{
        k: cat(*(getattr(o.details, k) for o in outs))
        for k in FCCQPDetails.__dataclass_fields__}),
        z=cat(*(o.z for o in outs)))
    check_same_solution(f"{tag}: the shards' replays vs their uncaptured "
                        "static solves", sol, both)
    dz, dn = check_like_eager(f"{tag}: the shards' replays", sol, eager)
    check(dn == 0, f"{tag}: n_iter differs from the eager solve on {dn}")
    prof = profiled_host_reads(sharded, inst)
    check(prof["host_reads"] == 0, f"{tag}: {prof['host_reads']} host reads "
          "in a captured sharded call")
    check(prof["traced_kernels"] > 0, f"{tag}: no {inst} kernel in the "
          "trace of a captured sharded call")
    rep.update(first_call_s=first_call, peak_allocated_gb=peak_gb,
               replay_walls=walls, replay_median_s=sorted(walls)[1],
               eager_walls=eager_walls, eager_median_s=sorted(eager_walls)[1],
               max_dz_to_eager=dz, bit_equal_to_eager=_same_bits(sol, eager),
               profiled=prof)
    log(f"[{tag}:graphs] two shards of {half} on the one card, captured at "
        f"the first call ({first_call:.3f} s, peak {peak_gb:.3f} GB); "
        f"sharded median {rep['replay_median_s']:.6f} s against the eager "
        f"unsharded solve's {rep['eager_median_s']:.6f} s (same call); each "
        "shard bit for bit its uncaptured static solve; the eager solve's "
        f"statuses and n_iter, |dz| {dz:.3e}; a sharded call profiled: "
        f"{prof['host_reads']} host reads, {prof['traced_kernels']} {inst} "
        "kernels traced; capture " + json.dumps(rep))
    return launches, rep


def sharded_phase(stacked, walking, bench, dev=None):
    """Phase 17: `solve_batched_ds_sharded` and `solve_batched_sharded`
    (the f64 parity engine) at `SHARD_OPTS`, each shard replaying its
    engine's capture: first the captured checks of two shards on the one
    card at B = 8192 (`sharded_captured`), then over [cuda:0] and over two
    shards at B = 8192 and B = 8191: each equal to the unsharded solve
    (n_iter and statuses equal; |dz| <= 1e-8 on ds, <= 1e-10 on f64) with
    equal summary aggregates; then the weak-scaling sweep
    (`parallel.scaling_bench`) over one and two shards at the bench
    flags."""
    import torch

    from fcc_qp_tpu_torch import (FCCQPOptions, solve_batched,
                                  solve_batched_ds, to_ds_batch)
    from fcc_qp_tpu_torch.core.ds_engine import full_stages
    from fcc_qp_tpu_torch.core.solver import parity_stages
    from fcc_qp_tpu_torch.models.osc import CASSIE
    from fcc_qp_tpu_torch.parallel import (solve_batched_ds_sharded,
                                           solve_batched_sharded, summarize)
    from fcc_qp_tpu_torch.parallel.scaling_bench import run_scaling_bench
    from fcc_qp_tpu_torch.utils.io import to_qpbatch

    shape = CASSIE.shape
    cuda0 = torch.device("cuda", 0) if dev is None else torch.device(dev)
    opts = FCCQPOptions(**SHARD_OPTS)
    launches, times, graphs = {}, {}, {}
    qds, qpb = to_ds_batch(stacked), to_qpbatch(stacked)
    two = [cuda0, cuda0]
    for kind, stages, qp, sharded, eager_solve, inst in (
            ("ds", full_stages(shape, opts), qds,
             lambda: solve_batched_ds_sharded(qds, shape, opts, mesh=two),
             lambda: solve_batched_ds(qds, shape, opts, graphs=False),
             "admm_chunk_full_warp<double"),
            ("f64", parity_stages(shape, opts), qpb,
             lambda: solve_batched_sharded(qpb, shape, opts, mesh=two),
             lambda: solve_batched(qpb, shape, opts, graphs=False),
             "admm_chunk_full_warp<double")):
        launches[f"{kind}_captured"], graphs[kind] = sharded_captured(
            kind, stages, qp, sharded, eager_solve, inst)
    del qds, qpb
    q = lambda t: t.cpu().numpy()
    for Bn in (B, B - 1):
        sub = {k: v[:Bn] for k, v in stacked.items()}
        qds, qpb = to_ds_batch(sub), to_qpbatch(sub)
        for kind, ref_fn, sh_fn, bar in (
                ("ds", lambda: solve_batched_ds(qds, shape, opts),
                 lambda m: solve_batched_ds_sharded(qds, shape, opts,
                                                    mesh=m), 1e-8),
                ("f64", lambda: solve_batched(qpb, shape, opts),
                 lambda m: solve_batched_sharded(qpb, shape, opts,
                                                 mesh=m), 1e-10)):
            ref, _ = ref_fn()
            ref_sum = summarize(ref)
            for mesh in ([cuda0], [cuda0, cuda0]):
                tag = f"{kind}_B{Bn}_x{len(mesh)}"
                reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sol, _, summ = sh_fn(mesh)
                torch.cuda.synchronize()
                times[tag] = time.perf_counter() - t0
                launches[tag] = counts()
                check(tuple(sol.z.shape) == (Bn, 60),
                      f"sharded {tag}: z of shape {tuple(sol.z.shape)}")
                dn = int((q(sol.details.n_iter) != q(ref.details.n_iter)).sum())
                dz = float((sol.z - ref.z).abs().max())
                check(dn == 0, f"sharded {tag}: n_iter differs from the "
                      f"unsharded solve on {dn} instances")
                check(torch.equal(sol.details.solve_status,
                                  ref.details.solve_status),
                      f"sharded {tag}: statuses differ")
                check(dz <= bar, f"sharded {tag}: |dz| {dz:.3e} > {bar:.0e}")
                for f in ("n_solved", "n_instances", "max_iterations"):
                    check(int(getattr(summ, f)) == int(getattr(ref_sum, f)),
                          f"sharded {tag}: summary {f} differs")
                for f in ("max_residual_bounds", "max_residual_fcone",
                          "mean_iterations", "max_bounds_viol",
                          "max_fcone_viol"):
                    a, b = float(getattr(summ, f)), float(getattr(ref_sum, f))
                    check(abs(a - b) <= 1e-6 * (1.0 + abs(b)),
                          f"sharded {tag}: summary {f} {a} vs {b}")
                log(f"[sharded] {tag}: equal to the unsharded solve (n_iter, "
                    f"statuses, |dz| {dz:.3e}), summary "
                    f"{int(summ.n_solved)}/{int(summ.n_instances)} kSuccess, "
                    f"mean n_iter {float(summ.mean_iterations):.3f}; wall "
                    f"{times[tag]:.6f} s; launches " + json.dumps(launches[tag]))
    # the sweep's own workload, the bench's cold batch: the walking log's
    # first steps (every instance must converge there)
    qlog = to_ds_batch({k: v[:B] for k, v in walking.items()})
    sweep = run_scaling_bench(shape, qlog, bench, device_counts=(1, 2),
                              repeats=3, devices=[cuda0])
    log("[sharded] weak scaling over one and two shards on the one card "
        f"(per-shard batch {sweep['per_device_batch']}): "
        + json.dumps(sweep["results"]))
    return launches, times, sweep, graphs

# the bench entry point (phase 18): the models it runs, with their flags:
# the quadruped and the humanoid at the defaults, Cassie (whose path
# phases 2 and 5 time) at one repeat
ENTRY_RUNS = (("quadruped", []), ("humanoid", []),
              ("cassie", ["--repeats", "1"]))
# the record's keys: the JAX bench's with the replay (bench.py:266-342),
# and the port's "engine" and "device"
ENTRY_KEYS = {"metric", "unit", "model", "cold_solves_per_sec",
              "cold_pipelined_solves_per_sec", "cold_converged_pct",
              "cold_polish_accept_pct", "value", "warm_iters_p50",
              "replay_converged_pct", "replay_T", "warm_polish_accept_pct",
              "vs_baseline", "engine", "device"}
# the JAX package on the CPU at the bench flags with the model's polish
# Newton steps, on the bench's walking log (exp_full_reference.py,
# sections bench_<model> and bench_<model>8192): kSuccess of the cold
# solve of its first 512 steps (the first 512 instances of the bench's
# cold batch) and of all 8192, and kSuccess and warm polish acceptance of
# its steps 0-1023 replayed as 64 streams x 16 steps (the first 64
# streams of the bench's replay), as (count, of). The card's shares on
# the same instances must reach them less 1%
ENTRY_COLD_FIRST, ENTRY_STREAMS = 512, 64
ENTRY_JAX = {
    "cassie": dict(cold=(512, 512), cold_all=(8192, 8192),
                   replay=(1024, 1024), warm_accept=(960, 960)),
    "quadruped": dict(cold=(503, 512), cold_all=(7794, 8192),
                      replay=(1023, 1024), warm_accept=(950, 960)),
    "humanoid": dict(cold=(512, 512), cold_all=(8192, 8192),
                     replay=(1024, 1024), warm_accept=(956, 960)),
}
# the record keys of phase 18's kernel cases, per model
ENTRY_SUFFIX = {"quadruped": "quad", "humanoid": "hum"}


def entry_captures(before):
    """The captures made since the key set ``before`` of
    `core.graphs._CAPTURES`: {"cold" | "replay": {"cold" | "warm":
    capture_report}}."""
    from fcc_qp_tpu_torch.core import graphs

    out = {}
    for key in set(graphs._CAPTURES) - before:
        cap = graphs._CAPTURES[key]
        out["replay" if cap.with_cache else "cold"] = {
            ("warm" if w else "cold"): capture_report(cap, w)
            for w in sorted(cap._captured)}
    return out


def entry_checks(name, record, sol, sols, stacked, opts, steps):
    """Phase 18's bars on one model's bench run: the record's keys; no
    kFactorizationFailed, no NaN, finite solutions of the expected
    shapes; kSuccess residuals <= 1e-6; the equality bars of phases 2 and
    5; the JAX package's shares on the same instances (`ENTRY_JAX`) less
    1%; warm n_iter p50 <= 15. Returns the shares."""
    import numpy as np

    check(set(record) == ENTRY_KEYS, f"entry:{name}: record keys "
          f"{sorted(record)}")
    q = lambda t: t.cpu().numpy()
    n = stacked["b"].shape[1]
    jax = ENTRY_JAX[name]
    shares = {}
    for part, s in (("cold", sol), ("replay", sols)):
        rows = len(q(s.details.solve_status))
        tag = f"entry:{name}:{part}"
        b_eq = np.abs(stacked["b_eq"][:rows]).max(axis=1)
        d = s.details
        st, eqv = q(d.solve_status), q(d.equality_viol)
        ok, acc = st == 0, q(d.polish_accepted) > 0
        z = q(s.z)
        check(z.shape == (rows, n) and np.isfinite(z).all(),
              f"{tag}: solution not finite or of the wrong shape")
        check((st != 2).all(), f"{tag}: kFactorizationFailed")
        res = np.maximum(q(d.admm_residual_bounds),
                         q(d.admm_residual_friction_cone))
        check(not np.isnan(res).any(), f"{tag}: NaN residuals")
        check((res[ok] <= 1e-6).all(), f"{tag}: kSuccess residual above 1e-6")
        check((eqv[ok] <= 1e-8 * (1.0 + b_eq[ok])).all(),
              f"{tag}: relative equality residual above 1e-8 on kSuccess")
        # polish-accepted cold solves (and replay steps 0) to 1e-8; a warm
        # step accepted by the polish to its acceptance test's eps_bound
        # (phase 5; ROADMAP.md queue C)
        cold_row = (np.ones(rows, bool) if part == "cold"
                    else np.arange(rows) % steps == 0)
        check((eqv[ok & acc & cold_row] <= 1e-8).all(),
              f"{tag}: equality residual above 1e-8 on a polish-accepted "
              "cold solve")
        check((eqv[ok & acc] <= opts.eps_bound).all(),
              f"{tag}: equality residual above eps_bound on a "
              "polish-accepted step")
        held = ENTRY_COLD_FIRST if part == "cold" else ENTRY_STREAMS * steps
        count, of = jax[part]
        check(held <= rows and of == held, f"{tag}: {rows} rows")
        shares[part] = float(ok.mean())
        shares[f"{part}_held"] = float(ok[:held].mean())
        check(shares[f"{part}_held"] >= count / of - 0.01,
              f"{tag}: kSuccess {shares[f'{part}_held']:.4%} on the first "
              f"{held} < the JAX package's {count / of:.4%} less 1%")
        if part == "cold":
            count, of = jax["cold_all"]
            check(of == rows and shares["cold"] >= count / of - 0.01,
                  f"{tag}: kSuccess {shares['cold']:.4%} of {rows} < the "
                  f"JAX package's {count / of:.4%} less 1%")
    acc = q(sols.details.polish_accepted).reshape(-1, steps)[:, 1:] > 0
    count, of = jax["warm_accept"]
    shares["warm_accept"] = float(acc.mean())
    shares["warm_accept_held"] = float(acc[:ENTRY_STREAMS].mean())
    check(acc[:ENTRY_STREAMS].size == of
          and shares["warm_accept_held"] >= count / of - 0.01,
          f"entry:{name}: warm polish acceptance "
          f"{shares['warm_accept_held']:.4%} on the first {ENTRY_STREAMS} "
          f"streams < the JAX package's {count / of:.4%} less 1%")
    check(record["warm_iters_p50"] <= 15,
          f"entry:{name}: warm n_iter p50 {record['warm_iters_p50']}")
    return shares


def entry_logs(cache_dir):
    """Phase 18's walking logs for the models other than Cassie (whose log
    is phase 5's), generated on the host and cached under the bench's
    names in ``cache_dir``, one process a model (one BLAS thread each),
    all started together and waited for. Returns the seconds it took."""
    code = ("import sys\n"
            "from fcc_qp_tpu_torch import bench\n"
            "args = bench.parse_args(['--model', sys.argv[2]])\n"
            "bench.walking_log(args, bench.sizes(args)[1], sys.argv[1])\n")
    one = {k: "1" for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                            "MKL_NUM_THREADS")}
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", code, cache_dir, m],
                              cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT,
                                                 **one))
             for m, _ in ENTRY_RUNS if m != "cassie"]
    codes = [p.wait() for p in procs]
    check(codes == [0] * len(procs), f"entry: the walking logs were not "
          f"generated (exit codes {codes})")
    return time.perf_counter() - t0


def entry_phase(engine, specs, cassie_log, cassie_replay):
    """Phase 18: the bench entry point (`fcc_qp_tpu_torch.bench.run`, as
    ``python -m fcc_qp_tpu_torch.bench --model <name>`` runs it) for each
    of `ENTRY_RUNS`, its log cached in a directory of this run
    (`entry_logs`; Cassie's is phase 5's log, saved under the bench's
    cache name). Per model:
    counted from zero over the run; its record line; each capture's
    census (seconds, nodes by type, IF nodes, hand kernels per graph) and
    the run's peak memory; `entry_checks`; both reduced kernels launched.
    Cassie's replay equals phase 5's captured replay bit for bit (status,
    n_iter, z). For the quadruped and the humanoid, each reduced kernel
    against its plain version bit for bit on an all-active first chunk
    (f32: the bench solve's approach phase; f64: the endgame with no
    approach phase), the bench solve's last chunk with an iterating
    instance (the stragglers) and a warm replay step's last chunk, from
    recorded (uncaptured) solves, timed with bounds. Returns ``(launches
    per model, kernel cases {model: {kernel: {case: compare record}}},
    report)``."""
    import shutil

    import torch

    from fcc_qp_tpu_torch import bench as entry
    from fcc_qp_tpu_torch import replay_ds_streams, solve_batched_ds
    from fcc_qp_tpu_torch import to_ds_batch
    from fcc_qp_tpu_torch.core import graphs
    from fcc_qp_tpu_torch.models.osc import MODELS
    from fcc_qp_tpu_torch.utils.io import save_qp_log_packed

    cache_dir = os.path.join(ROOT, "test_data",
                             f"chip_smoke_entry_{os.getpid()}")
    os.makedirs(cache_dir, exist_ok=True)
    launches, cases, report = {}, {}, {}
    try:
        log(f"[entry] walking logs generated in {entry_logs(cache_dir):.3f} "
            "s (one process a model)")
        for name, extra in ENTRY_RUNS:
            argv = ["--model", name] + extra
            args = entry.parse_args(argv)
            cold_b, T = entry.sizes(args)
            steps = args.steps
            shape = MODELS[name].shape
            t0 = time.perf_counter()
            if name == "cassie":
                stacked = cassie_log
                save_qp_log_packed(os.path.join(
                    cache_dir, f"id_qp_log_cassie_T{T}.fqlog"), stacked)
            else:
                stacked = entry.walking_log(args, T, cache_dir)
            t_log = time.perf_counter() - t0
            before = set(graphs._CAPTURES)
            reset_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            mem0 = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            record, sol, sols = entry.run(argv, cache_dir=cache_dir)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches[name] = counts()
            peak_gb = (torch.cuda.max_memory_allocated() - mem0) / 1e9
            census = entry_captures(before)
            log(f"[entry:{name}] record: " + json.dumps(record))
            log(f"[entry:{name}] the run {wall:.3f} s (the log ready in "
                f"{t_log:.3f} s before it), peak {peak_gb:.3f} GB allocated; "
                "launches " + json.dumps(launches[name]) + "; captures "
                + json.dumps(census))
            check(sorted(census) == ["cold", "replay"]
                  and sorted(census["replay"]) == ["cold", "warm"],
                  f"entry:{name}: the run did not capture its cold solve "
                  f"and both replay kinds ({sorted(census)})")
            for kname in REDUCED_KERNELS:
                check(launches[name][kname] > 0,
                      f"entry:{name}: {kname} was not launched")
            opts = entry.options(args)
            shares = entry_checks(name, record, sol, sols, stacked, opts,
                                  steps)
            log(f"[entry:{name}] shares (whole batch / replay, and on the "
                "instances the JAX package was run on): " + json.dumps(shares))
            report[name] = dict(record=record, wall_s=wall, log_s=t_log,
                                peak_allocated_gb=peak_gb, captures=census,
                                shares=shares)
            if name == "cassie":
                for f in ("solve_status", "n_iter"):
                    check(torch.equal(getattr(sols.details, f),
                                      getattr(cassie_replay.details, f)),
                          f"entry:cassie: replay {f} differs from phase 5's")
                check(torch.equal(sols.z, cassie_replay.z),
                      "entry:cassie: replay z differs from phase 5's")
                log("[entry:cassie] the entry's replay equals phase 5's "
                    "captured replay bit for bit (status, n_iter, z)")
                continue
            # the kernels on this model's chunks, from recorded
            # (uncaptured) solves, not counted
            sub = lambda n: {k: v[:n] for k, v in stacked.items()}
            qp = to_ds_batch(sub(cold_b))
            _, rec_eg = recorded_solve(engine, lambda: solve_batched_ds(
                qp, shape, opts.replace(polish=False, phase1_tol=0.0,
                                        max_iter=64), graphs=False))
            _, rec_b = recorded_solve(engine, lambda: solve_batched_ds(
                qp, shape, opts, graphs=False))
            reps = to_ds_batch(sub(T))
            _, rec_r = recorded_solve(engine, lambda: replay_ds_streams(
                reps, shape, opts, n_streams=args.batch, graphs=False))
            del reps
            firsts = {"admm_chunk_f64": rec_eg, "admm_chunk_f32": rec_b}
            cases[name] = {}
            for kname, kernel, plain, prec, _ in specs:
                c = {}
                for case, rec, which in (("first", firsts[kname], "first"),
                                         ("tail", rec_b, "last_active"),
                                         ("warm", rec_r, "last_warm")):
                    got = getattr(rec[kname], which)
                    if got is None:
                        check(case == "warm" and kname == "admm_chunk_f64",
                              f"entry:{name}: no {case} chunk of {kname}")
                        log(f"[kernel] {kname}: not launched in a warm "
                            f"{name} replay step")
                        continue
                    c[case] = compare(kname, f"{case}_{name}", kernel, plain,
                                      *got, prec, exact=True)
                check(c["first"]["active"] == cold_b,
                      f"entry:{name}: {kname}'s first chunk is not all "
                      "active")
                check(c["tail"]["active"] > 0,
                      f"entry:{name}: no instance iterates in {kname}'s "
                      "last bench chunk")
                cases[name][kname] = c
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
    return launches, cases, report


# the public surface and the walking-log example (phase 19). The example
# (examples/replay_walking_torch.py) at its defaults: the drop-in loop
# over 400 synthesized steps and the batched solve of 400 and of 8192 (the
# bench's cold size), each on its own synthesized log; the JAX package's
# kSuccess counts on the same logs at the JAX example's options, on the
# CPU (exp_full_reference.py example_loop, example_batched,
# example_batched8192), as (count, of): the loop's within two, the
# batched shares less 1%
EXAMPLE_RUNS = (("loop", 400), ("batched", 400), ("batched", 8192))
EXAMPLE_JAX = {"loop400": (400, 400), "batched400": (400, 400),
               "batched8192": (8192, 8192)}
# timing=False calls queued back to back before one synchronize
QUEUE_DEPTH = 4
# the rho the rho=/operator= calls give (opts.rho elsewhere), and the
# instance `solve` takes (it converges there at FAST_OPTS' tolerances,
# as in tests/test_torch_public_surface.py)
SURFACE_RHO = 0.7
SURFACE_INSTANCE = 5


def example_module():
    """`examples/replay_walking_torch.py`, imported from its path."""
    import importlib.util

    path = os.path.join(ROOT, "examples", "replay_walking_torch.py")
    spec = importlib.util.spec_from_file_location("replay_walking_torch",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def drop_captures():
    """Drop every batched capture (each once its queued replays are
    done), so that each path after it captures anew and its wrappers
    count under the capture."""
    from fcc_qp_tpu_torch.core import graphs

    for cap in graphs._CAPTURES.values():
        cap.wait()
    graphs._CAPTURES.clear()


def example_phase(ex, out_dir):
    """Phase 19 (a): the example's `replay` on the card for each of
    `EXAMPLE_RUNS`, counted from zero; its plot written into
    ``out_dir``. Checks: a finite (T, 60) solution; no
    kFactorizationFailed; kSuccess within two of the JAX package's
    (loop) or its share less 1% (batched); on kSuccess the ADMM
    residuals <= 1e-6 and the equality residual <= 1e-8 (1 + max |b_eq|);
    the kernels of the mode launched; a PNG. Returns (launches per run,
    numbers per run, the stacked log of each run)."""
    import numpy as np

    from fcc_qp_tpu_torch.utils.io import stack_qp_dicts

    launches, report, logs = {}, {}, {}
    for mode, steps in EXAMPLE_RUNS:
        tag = f"{mode}{steps}"
        png = os.path.join(out_dir, f"{tag}.png")
        argv = ["--mode", mode, "--steps", str(steps), "--out", png]
        reset_counts()
        t0 = time.perf_counter()
        r = ex.replay(argv)
        wall = time.perf_counter() - t0
        launches[tag] = counts()
        logs[tag] = stack_qp_dicts(ex.load_log(ex.parse_args(argv)))
        b_eq = np.abs(logs[tag]["b_eq"]).max(axis=1)
        st = r["status"]
        ok = st == 0
        count, of = EXAMPLE_JAX[tag]
        check(r["z"].shape == (of, 60) and np.isfinite(r["z"]).all(),
              f"example:{tag}: solution not finite or of the wrong shape")
        check((st != 2).all(), f"example:{tag}: kFactorizationFailed")
        if mode == "loop":
            check(abs(int(ok.sum()) - count) <= 2, f"example:{tag}: "
                  f"kSuccess {int(ok.sum())}, the JAX package's {count}")
        else:
            check(ok.mean() >= count / of - 0.01, f"example:{tag}: kSuccess "
                  f"{ok.mean():.4%} < the JAX package's {count / of:.4%} "
                  "less 1%")
        check((r["residual"][ok] <= 1e-6).all(),
              f"example:{tag}: kSuccess residual above 1e-6")
        check((r["eq_viol"][ok] <= 1e-8 * (1.0 + b_eq[ok])).all(),
              f"example:{tag}: relative equality residual above 1e-8 on "
              "kSuccess")
        # the batched mode runs no approach phase (phase1_tol 0, polish
        # off): the f64 endgame kernel from the first iteration
        kernels = (("admm_chunk_full_f64",) if mode == "loop"
                   else ("admm_chunk_f64",))
        for name in kernels:
            check(launches[tag][name] > 0,
                  f"example:{tag}: {name} was not launched")
        ex.make_plots(r["z"], r["times"], r["iters"], r["fviol"],
                      r["bviol"], png)
        with open(png, "rb") as f:
            check(f.read(8) == b"\x89PNG\r\n\x1a\n",
                  f"example:{tag}: no PNG written")
        rep = dict(kSuccess=int(ok.sum()), of=of, wall_s=wall,
                   n_iter_p50=float(np.median(r["iters"])),
                   n_iter_max=int(r["iters"].max()),
                   max_residual=float(r["residual"][ok].max()),
                   max_eq_viol=float(r["eq_viol"][ok].max()))
        if mode == "loop":
            warm = r["walls"][1:] * 1e3
            rep.update(wall_p50_ms=float(np.median(warm)),
                       wall_p95_ms=float(np.percentile(warm, 95)),
                       first_solve_ms=float(r["walls"][0] * 1e3),
                       solve_time_p50_ms=float(np.median(r["times"][1:])
                                               * 1e3))
        else:
            rep.update(timed_wall_s=float(r["walls"][0]),
                       solves_per_s=steps / float(r["walls"][0]))
        report[tag] = rep
        log(f"[example:{tag}] " + json.dumps(rep) + "; launches "
            + json.dumps(launches[tag]) + f"; plot {os.path.basename(png)}")
    return launches, report, logs


def synchronizes(fn) -> bool:
    """Whether ``fn()`` synchronizes with the card (a read of a device
    tensor, a stream or device synchronize), by torch's sync debug mode
    set to raise; the mode is reset after."""
    import torch

    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as e:
        if "synchroniz" not in str(e):
            raise
        return True
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return False


def queued_untimed(tag, call):
    """Phase 19 (b): ``call(timing)`` once with ``timing=True`` (it
    captures), `QUEUE_DEPTH` synchronized ``timing=True`` calls, then
    `QUEUE_DEPTH` ``timing=False`` calls queued back to back before one
    synchronize, under torch's sync debug mode set to raise: no queued
    call synchronizes with the card (a read of a device tensor, a
    synchronize), which the mode is first shown to catch; every queued
    result equals the ``timing=True`` call's bit for bit (z, every
    diagnostic but the times, the warm state), its time fields zero.
    Returns the walls per call, the host's seconds to issue each queued
    call (the first from an idle card), how many had work still queued
    on the card when the last returned (events recorded behind each),
    and the device span of the last synchronized call (its
    ``solve_time``)."""
    import statistics

    import torch

    from fcc_qp_tpu_torch.parallel.mesh import leaves

    want, want_ws = call(True)
    walls = []
    for _ in range(QUEUE_DEPTH):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, _ = call(True)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    check(synchronizes(lambda: torch.ones(1, device="cuda").cpu()),
          f"{tag}: torch's sync debug mode does not catch a device read")
    torch.cuda.synchronize()
    outs, issue, done = [], [], []

    def queue():
        for _ in range(QUEUE_DEPTH):
            t1 = time.perf_counter()
            outs.append(call(False))
            issue.append(time.perf_counter() - t1)
            done.append(torch.cuda.Event())
            done[-1].record()

    t0 = time.perf_counter()
    check(not synchronizes(queue), f"{tag}: a timing=False call "
          "synchronized with the card")
    issued = time.perf_counter() - t0
    pending = [not e.query() for e in done]
    torch.cuda.synchronize()
    queued = time.perf_counter() - t0
    for i, (sol, ws) in enumerate(outs):
        check_same_solution(f"{tag}: queued call {i}", sol, want)
        for f in TIME_FIELDS:
            check(not getattr(sol.details, f).any(),
                  f"{tag}: queued call {i} has a nonzero {f}")
        check(all(torch.equal(a, b) for a, b in zip(leaves(ws),
                                                     leaves(want_ws))),
              f"{tag}: queued call {i}'s warm state differs")
    rep = dict(sync_wall_per_call_s=statistics.median(walls),
               sync_walls_s=walls,
               queued_wall_per_call_s=queued / QUEUE_DEPTH,
               queued_issue_s=issued, issue_s=issue,
               still_queued=sum(pending),
               device_solve_time_s=float(last.details.solve_time[0]))
    log(f"[untimed:{tag}] {QUEUE_DEPTH} timing=False calls queued: "
        f"{rep['queued_wall_per_call_s']:.6f} s a call ({issued:.6f} s to "
        f"issue all; each call {', '.join(f'{t:.6f}' for t in issue)} s, "
        f"the first from an idle card; {sum(pending)} still queued on the "
        f"card when the last returned), against "
        f"{rep['sync_wall_per_call_s']:.6f} s a synchronized timing=True "
        "call (median); each bit for bit the timing=True result, time "
        "fields zero")
    return rep


def surface_phase(ex, qp, bench, stacked, solver_mod, out_dir):
    """Phase 19: the public surface and the example. (a) `example_phase`;
    (b) `queued_untimed` for `solve_batched_ds` at the bench flags on
    phase 2's batch and for `solve_batched_fast` at `SHARD_OPTS` on the
    same instances; (c) ``rho=`` / ``operator=``: `solve` on one instance
    at `SURFACE_RHO` and `FAST_OPTS`' tolerances with the operator
    `ops.kkt.admm_operator` builds for it, and `solve_batched_fast` at
    `FAST_OPTS` (adaptive rho) with a
    scalar rho and with one rho per instance, each with its operator
    (built as the capture builds it: static, under cuSOLVER), each bit
    for bit the call that builds the operator itself (at
    ``opts.replace(rho=...)``, or with the same rho vector); (d) the
    kernels against their plain versions on this phase's paths, from
    recorded uncaptured solves: the reduced f64 kernel on the first and
    the last iterating chunk of the example's batched solve of 8192 steps
    (its largest; the example's options run no f32 approach phase), the
    reduced f32 kernel on those of the queued bench-flag solve,
    the full-layout kernel on the ``operator=`` solve's one launch and on
    the first chunk of the ``operator=`` fast solve. Every path counted
    from zero. Returns (launches {path: counts}, kernel cases {kernel:
    {case: compare record}}, report)."""
    import torch

    import fcc_qp_tpu_torch.core.ds_engine as engine
    from fcc_qp_tpu_torch import (FCCQPOptions, QPBatch, solve,
                                  solve_batched_ds, solve_batched_fast,
                                  to_ds_batch)
    from fcc_qp_tpu_torch.core import graphs
    from fcc_qp_tpu_torch.core.graphs import _cusolver
    from fcc_qp_tpu_torch.models.osc import CASSIE
    from fcc_qp_tpu_torch.ops import pallas_admm
    from fcc_qp_tpu_torch.ops.kkt import admm_operator
    from fcc_qp_tpu_torch.utils.io import to_qpbatch

    shape = CASSIE.shape
    drop_captures()
    launches, report, logs = example_phase(ex, out_dir)

    qpb = to_qpbatch(stacked)
    untimed = {}
    reset_counts()
    untimed["ds"] = queued_untimed("solve_batched_ds", lambda t:
                                   solve_batched_ds(qp, shape, bench,
                                                    timing=t))
    launches["untimed_ds"] = counts()
    # the host's seconds to launch the bench capture's two graphs alone,
    # from an idle card: what a queued call cannot hide
    cap = next(reversed(graphs._CAPTURES.values()))
    launch = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cap.run(False)
        launch.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    untimed["ds"]["graph_launch_s"] = launch
    log("[untimed:solve_batched_ds] the capture's two graphs launched "
        "alone from an idle card: " + ", ".join(f"{t:.6f}" for t in launch)
        + " s of host time")
    reset_counts()
    shard = FCCQPOptions(**SHARD_OPTS)
    untimed["fast"] = queued_untimed("solve_batched_fast", lambda t:
                                     solve_batched_fast(qpb, shape, shard,
                                                        timing=t))
    launches["untimed_fast"] = counts()
    report["untimed"] = untimed
    for path, names in (("untimed_ds", REDUCED_KERNELS),
                        ("untimed_fast", ("admm_chunk_full_f64",))):
        for name in names:
            check(launches[path][name] > 0,
                  f"{path}: {name} was not launched")

    # (c) a prebuilt operator: `solve` (the parity engine, which takes no
    # adaptive rho) on one instance, `solve_batched_fast` on the batch
    fast = FCCQPOptions(**FAST_OPTS)
    one = QPBatch(*(a[SURFACE_INSTANCE] for a in qpb.__dict__.values()))
    reset_counts()
    op1 = admm_operator(one.Q[None], one.b[None], one.A_eq[None],
                        one.b_eq[None], SURFACE_RHO)
    rho0 = torch.tensor(SURFACE_RHO, dtype=torch.float64, device="cuda")
    parity = fast.replace(adaptive_rho=False)
    (given1, _), rec_solve = recorded_full(solver_mod, lambda: solve(
        one, shape, parity, rho=rho0, operator=op1))
    own1, _ = solve(one, shape, parity.replace(rho=SURFACE_RHO))
    check_same_solution("solve(rho=, operator=)", given1, own1)
    rho_s = torch.full((B,), SURFACE_RHO, dtype=torch.float64,
                       device="cuda")
    rho_v = torch.linspace(0.25, 4.0, B, dtype=torch.float64, device="cuda")
    with _cusolver():
        op_s, op_v = (admm_operator(qpb.Q, qpb.b, qpb.A_eq, qpb.b_eq, r,
                                    static=True) for r in (rho_s, rho_v))
    given_s, _ = solve_batched_fast(qpb, shape, fast, rho=SURFACE_RHO,
                                    operator=op_s)
    own_s, _ = solve_batched_fast(qpb, shape,
                                  fast.replace(rho=SURFACE_RHO))
    check_same_solution("solve_batched_fast(rho=<scalar>, operator=)",
                        given_s, own_s)
    given_v, _ = solve_batched_fast(qpb, shape, fast, rho=rho_v,
                                    operator=op_v)
    own_v, _ = solve_batched_fast(qpb, shape, fast, rho=rho_v)
    check_same_solution("solve_batched_fast(rho=<per instance>, "
                        "operator=)", given_v, own_v)
    launches["operator"] = counts()
    check(launches["operator"]["admm_chunk_full_f64"] > 0,
          "operator=: admm_chunk_full_f64 was not launched")
    for tag, sol in (("solve", given1), ("fast_scalar", given_s),
                     ("fast_vector", given_v)):
        st = sol.details.solve_status.reshape(-1)
        check((st != 2).all() and torch.isfinite(sol.z).all(),
              f"operator={tag}: kFactorizationFailed or a NaN")
    report["operator"] = {
        tag: dict(kSuccess=int((s.details.solve_status == 0).sum()),
                  of=int(s.details.solve_status.numel()))
        for tag, s in (("solve", given1), ("fast_scalar", given_s),
                       ("fast_vector", given_v))}
    log("[operator] solve(rho=, operator=) and solve_batched_fast(rho=, "
        "operator=) (a scalar rho and one per instance) each bit for bit "
        "the call that builds its operator: " + json.dumps(
            report["operator"]) + "; launches " + json.dumps(
                launches["operator"]))

    # (d) the kernels on this phase's chunks (uncaptured, not counted), on
    # the example's largest batched run
    steps = max(n for mode, n in EXAMPLE_RUNS if mode == "batched")
    args = ex.parse_args(["--steps", str(steps)])
    batch = to_ds_batch(logs[f"batched{steps}"])
    ex_opts = FCCQPOptions(max_iter=args.max_iter, rho=args.rho,
                           eps_fcone=args.eps, eps_bound=args.eps,
                           scaling=True, splitting="constrained",
                           presolve="operator")
    _, rec_ex = recorded_solve(engine, lambda: solve_batched_ds(
        batch, shape, ex_opts, graphs=False))
    del batch
    _, rec_bench = recorded_solve(engine, lambda: solve_batched_ds(
        qp, shape, bench, graphs=False))
    _, rec_fast = recorded_full(solver_mod, lambda: solve_batched_fast(
        qpb, shape, fast, rho=rho_v, operator=op_v, graphs=False))
    cases = {}
    for name, kernel, plain, prec, rec, path in (
            ("admm_chunk_f64", pallas_admm.admm_chunk_f64,
             pallas_admm.admm_chunk_f64_plain, "f64", rec_ex, "example"),
            ("admm_chunk_f32", pallas_admm.admm_chunk_f32,
             pallas_admm.admm_chunk_f32_plain, "f32", rec_bench,
             "untimed")):
        c = {}
        for case, which in ((path, "first"), (f"tail_{path}",
                                              "last_active")):
            got = getattr(rec[name], which)
            check(got is not None, f"{name}: no {which} chunk in the "
                  f"{path} path's solve")
            c[case] = compare(name, case, kernel, plain, *got, prec,
                              exact=True)
        check(c[f"tail_{path}"]["active"] > 0, f"{name}: no instance "
              f"iterates in the {path} path's last chunk")
        cases[name] = c
    full_k = pallas_admm.admm_chunk_full_f64
    full_p = pallas_admm.admm_chunk_full_f64_plain
    cases["admm_chunk_full_f64"] = {
        "solve_operator": compare_full("solve_operator", full_k, full_p,
                                       *rec_solve.last),
        "fast_operator": compare_full("fast_operator", full_k, full_p,
                                      *rec_fast.first)}
    check(cases["admm_chunk_full_f64"]["solve_operator"]["B"] == 1,
          "the solve(operator=) launch is not one instance")
    check(cases["admm_chunk_full_f64"]["fast_operator"]["active"] == B,
          "the fast operator= solve's first chunk is not all active")
    return launches, cases, report


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
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[build] {line.strip()}")
    check_ptxas(info["ptxas"])
    card = smi_line()
    log(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. main path at the bench flags
    t0 = time.perf_counter()
    stacked = stack_qp_dicts(generate_osc_batch(CASSIE, B, seed=0))
    qp = to_ds_batch(stacked)
    log(f"[data] Cassie B={B} generated and moved in "
        f"{time.perf_counter() - t0:.2f} s")
    bench = FCCQPOptions(**BENCH_OPTS,
                         polish_newton_steps=CASSIE.polish_newton_steps)
    sol, launches_bench, walls, bench_graphs = captured_cold_phase(
        engine, qp, bench)
    log("[bench] timed walls (s): " + json.dumps(walls))
    wall = sorted(walls)[1]
    # the staged solve runs uncaptured (a synchronize per stage); its
    # launches give the host seconds per chunk
    stages = {}
    pallas_admm.reset_launch_counts()
    solve_batched_ds(qp, CASSIE.shape, bench, stage_times=stages)
    launches_staged = counts()
    # the operator stage under cuSOLVER, the backend of the captures (the
    # eager solve takes PyTorch's own choice, which may be MAGMA)
    from fcc_qp_tpu_torch.core.graphs import _cusolver
    stages_cusolver = {}
    with _cusolver():
        solve_batched_ds(qp, CASSIE.shape, bench,
                         stage_times=stages_cusolver)
    log(f"[bench] operator stage (staged, uncaptured): "
        f"{stages.get('operator', 0.0):.6f} s with PyTorch's choice of "
        f"linear-algebra backend, {stages_cusolver.get('operator', 0.0):.6f}"
        " s under cuSOLVER; hybrid f64 fallback calls "
        f"{stages.get('n_fallback_calls', 0)} ({stages.get('n_fallback', 0)}"
        " instances)")
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
        / max(launches_staged["admm_chunk_f32"], 1),
        "endgame": stages.get("endgame", 0.0)
        / max(launches_staged["admm_chunk_f64"], 1),
    }
    log("[bench] host seconds per chunk (staged stage seconds / launches): "
        + json.dumps(host_per_chunk))
    # one more bench solve, not counted, that keeps each kernel's inputs:
    # its last chunk is a straggler chunk
    _, rec_bench = recorded_solve(
        engine, lambda: solve_batched_ds(qp, CASSIE.shape, bench,
                                         graphs=False))

    # 3. two-phase path through the f64 endgame kernel (its wall includes
    # the recorder's copies of every chunk's inputs)
    two_phase = bench.replace(polish=False, phase1_tol=1e-2)
    pallas_admm.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stages2 = {}
    (sol2, _), rec_tp = recorded_solve(
        engine, lambda: solve_batched_ds(qp, CASSIE.shape, two_phase,
                                         stage_times=stages2, graphs=False))
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    launches_tp = {fn.__name__: fn.launches for fn in pallas_admm.KERNELS}
    ok2, st2, res2, _ = summarize("two_phase", sol2, launches_tp, wall2,
                                  stages2)
    check((st2 != 2).all(), "kFactorizationFailed in the two-phase solve")
    check(ok2.mean() >= 0.90, f"two-phase kSuccess {ok2.mean():.4%} < 90%")
    check((res2[ok2] <= 1e-6).all(), "two-phase kSuccess residual above 1e-6")
    for name in REDUCED_KERNELS:
        total = launches_bench[name] + launches_tp[name]
        check(total > 0, f"{name} was never launched")

    # humanoid (k = 47 > 32): the kernels' two-slot layout. Its
    # convergence is not checked (it fails in the reference itself).
    hqp = to_ds_batch(stack_qp_dicts(generate_osc_batch(HUMANOID, 1024,
                                                        seed=0)))
    k_h = len(engine.constrained_indices(hqp, HUMANOID.shape))
    check(k_h > 32, f"humanoid has k = {k_h} constrained rows, not > 32")
    t0 = time.perf_counter()
    _, rec_h = recorded_solve(
        engine, lambda: solve_batched_ds(hqp, HUMANOID.shape, two_phase,
                                         graphs=False))
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

    # 5. warm replay, and each kernel on its last warm-step chunk
    (launches_replay, rec_replay, log_stacked, replay_warm,
     replay_graphs, replay_sols) = replay_phase(engine, bench)
    for (name, kernel, plain, prec, _), r in zip(specs, records):
        r["launches_replay"] = launches_replay[name]
        r["launches"] += launches_replay[name]
        # in one replay of each captured graph pair, counted under capture
        r["launches_per_cold_graph"] = bench_graphs["launches"][name]
        r["launches_per_replay_step0"] = replay_graphs["cold"]["launches"][name]
        r["launches_per_warm_step"] = replay_graphs["warm"]["launches"][name]
        got = rec_replay[name].last_warm
        if got is None:
            check(name != "admm_chunk_f32",
                  "admm_chunk_f32 was not launched in a warm replay step")
            log(f"[kernel] {name}: not launched in a warm replay step")
            r.update(ms_warm=None, plain_ms_warm=None, bound_ms_warm=None,
                     bound_by_warm=None, active_warm=None,
                     max_abs_err_warm=None)
            continue
        w = compare(name, "warm", kernel, plain, *got, prec)
        r.update(ms_warm=w["ms"], plain_ms_warm=w["plain_ms"],
                 bound_ms_warm=w["bound_ms"], bound_by_warm=w["bound_by"],
                 active_warm=w["active"], max_abs_err_warm=w["max_abs_err"])

    # 6. the full-splitting engine (the package defaults' path) at
    # Cassie's full width, and 7. the drop-in FCCQP replay on both engines
    import fcc_qp_tpu_torch.core.solver as solver_mod
    from fcc_qp_tpu_torch.models.osc import QUADRUPED

    launches_full, rec_full, full_device, full_graphs = full_phase(engine)
    launches_dropin, rec_dropin, rec_dropin_ds, dropin_table = dropin_phase(
        solver_mod)
    for r in records:
        r["launches_full"] = launches_full[r["name"]]
        r["launches_dropin"] = sum(v[r["name"]]
                                   for v in launches_dropin.values())
        r["launches"] += r["launches_full"] + r["launches_dropin"]

    # 8. the full-layout kernel against its plain version: the full
    # solve's first chunk (every instance active) and last chunk (the
    # stragglers), one B = 1 chunk of the f64 drop-in replay, and (state
    # and counters only) a quadruped chunk, whose cone triple at rows
    # 30-32 straddles the two row slots of a warp
    full_k = pallas_admm.admm_chunk_full_f64
    full_p = pallas_admm.admm_chunk_full_f64_plain
    first = compare_full("first", full_k, full_p, *rec_full.first)
    tail = compare_full("tail", full_k, full_p, *rec_full.last)
    b1 = compare_full("dropin_b1", full_k, full_p, *rec_dropin.last)
    check(first["active"] == B, "the full solve's first chunk is not all "
          "active")
    check(tail["active"] > 0, "no instance iterates in the full solve's "
          "last chunk")
    check(b1["B"] == 1 and b1["active"] == 1, "the drop-in chunk is not one "
          "active instance")
    for (name, kernel, plain, prec, _), r in zip(specs, records):
        rec = rec_dropin_ds[name]
        check(rec.first is not None, f"{name}: not launched in the ds "
              f"drop-in's eager static solve")
        for case, got in (("b1", rec.first),
                          ("b1_last", rec.last_active or rec.last)):
            v = compare(name, case, kernel, plain, *got, prec, exact=True)
            check(v["B"] == 1, f"{name} [{case}]: B = {v['B']}, not 1")
            r.update({f"{key}_{case}": v[key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "active",
                "max_abs_err")})
        check(r["active_b1"] + r["active_b1_last"] > 0, f"{name}: the "
              f"instance iterates in neither B = 1 case")
    qqp = to_ds_batch(stack_qp_dicts(generate_osc_batch(QUADRUPED, 256,
                                                        seed=0)))
    check(QUADRUPED.shape.lambda_c_start % 32 in (30, 31),
          "the quadruped's cone segment does not straddle the row slots")
    _, rec_q = recorded_full(engine, lambda: solve_batched_ds(
        qqp, QUADRUPED.shape, FCCQPOptions(**dict(FULL_OPTS, max_iter=200)),
        graphs=False))
    straddle = compare_full("quadruped_straddle", full_k, full_p,
                            *rec_q.first, time_it=False)
    # row counts that are no model's, at every slot count: random
    # problems, the first chunk timed
    from fcc_qp_tpu_torch import ProblemShape
    generic_err, generic = 0.0, {}
    for dims in GENERIC_DIMS:
        gshape = ProblemShape(*dims)
        gqp = to_ds_batch(random_batch(*dims, 256, seed=dims[0]))
        _, rec_g = recorded_full(engine, lambda: solve_batched_ds(
            gqp, gshape, FCCQPOptions(**dict(FULL_OPTS, max_iter=200)),
            graphs=False))
        case = f"n{dims[0]}_nc{dims[2]}"
        for which in ("first", "last"):
            g = compare_full(f"generic_{case}_{which}", full_k, full_p,
                             *getattr(rec_g, which),
                             time_it=which == "first")
            generic_err = max(generic_err, g["max_abs_err"])
            if which == "first":
                generic[case] = g

    # 9. the humanoid (n = k = 76, the kernels' third row slot) on its
    # three paths, then each kernel on its first chunk there
    launches_h, rec_hfull, rec_hred = humanoid_phase(engine, two_phase)
    n76 = compare_full("humanoid_n76", full_k, full_p, *rec_hfull.first)
    check(n76["n"] == 76, "the humanoid chunk is not n = 76")
    for (name, kernel, plain, prec, _), r in zip(specs, records):
        k76 = compare(name, "k76", kernel, plain, *rec_hred[name].first, prec)
        check(k76["k"] == 76, f"{name}: the humanoid chunk is not k = 76")
        r["launches_humanoid"] = sum(v[name] for v in launches_h.values())
        r["launches"] += r["launches_humanoid"]
        r.update(ms_k76=k76["ms"], plain_ms_k76=k76["plain_ms"],
                 bound_ms_k76=k76["bound_ms"], bound_by_k76=k76["bound_by"],
                 active_k76=k76["active"], max_abs_err_k76=k76["max_abs_err"],
                 blocks_per_sm={k: pallas_admm.blocks_per_sm(name, k)
                                for k in (22, 47, 76)})

    # the kernels' resources: registers per instantiation (ptxas) and
    # resident blocks per SM (the occupancy calculator)
    ptxas = pallas_admm.build_info["ptxas"]
    log("[kernel] ptxas per instantiation (registers, stack, spill "
        "stores, spill loads): " + json.dumps(ptxas))
    full_blocks = {n: pallas_admm.blocks_per_sm("admm_chunk_full_f64", n)
                   for n in (24, 42, 60, 76, 90)}
    log("[kernel] resident blocks per SM by row count: admm_chunk_full_f64 "
        "(four instances a block at n <= 80, two above) "
        + json.dumps(full_blocks) + "; "
        + "; ".join(f"{r['name']} (four instances a block at k <= 64, one "
                    f"above) " + json.dumps(r["blocks_per_sm"])
                    for r in records))
    for r in records:
        inst = ("admm_chunk_warp<double" if r["name"] == "admm_chunk_f64"
                else "admm_chunk_warp<float")
        r["registers"] = {k: v[0] for k, v in ptxas.items()
                          if k.startswith(inst)}
    launches_hfull = sum(v["admm_chunk_full_f64"] for v in launches_h.values())
    records.append(dict(
        name="admm_chunk_full_f64", route="cuda",
        source="fcc_qp_tpu_torch/csrc/admm_chunk.cu",
        replaces="fcc_qp_tpu/ops/pallas_admm.py:445",
        launches=(launches_full["admm_chunk_full_f64"]
                  + sum(v["admm_chunk_full_f64"]
                        for v in launches_dropin.values())
                  + launches_hfull),
        launches_full=launches_full["admm_chunk_full_f64"],
        launches_dropin=sum(v["admm_chunk_full_f64"]
                            for v in launches_dropin.values()),
        launches_humanoid=launches_hfull,
        max_abs_err=first["max_abs_err"], ms=first["ms"],
        plain_ms=first["plain_ms"], bound_ms=first["bound_ms"],
        bound_by=first["bound_by"], library_ms=None,
        ms_tail=tail["ms"], plain_ms_tail=tail["plain_ms"],
        bound_ms_tail=tail["bound_ms"], bound_by_tail=tail["bound_by"],
        active_tail=tail["active"], max_abs_err_tail=tail["max_abs_err"],
        ms_b1=b1["ms"], plain_ms_b1=b1["plain_ms"],
        bound_ms_b1=b1["bound_ms"], bound_by_b1=b1["bound_by"],
        max_abs_err_b1=b1["max_abs_err"],
        us_per_iteration_b1=b1["ms"] * 1e3 / b1["iters"],
        max_abs_err_straddle=straddle["max_abs_err"],
        max_abs_err_generic=generic_err,
        ms_generic={c: g["ms"] for c, g in generic.items()},
        bound_ms_generic={c: g["bound_ms"] for c, g in generic.items()},
        ms_n76=n76["ms"], plain_ms_n76=n76["plain_ms"],
        bound_ms_n76=n76["bound_ms"], bound_by_n76=n76["bound_by"],
        active_n76=n76["active"], max_abs_err_n76=n76["max_abs_err"],
        blocks_per_sm=full_blocks, device_ms_full_solve=full_device["ms"],
        registers={k: v[0] for k, v in ptxas.items()
                   if k.startswith("admm_chunk_full_warp<double")},
    ))

    # 10-17. host IO, over-relaxation, adaptive rho on the reduced path,
    # the batch-level engine, the f32 parity engine, the parity replay,
    # serving and the sharded solves; each path counted from zero
    full_rec = records[2]
    io_rec = io_phase(log_stacked, replay_warm)
    launches_alpha, full_alpha, alpha_shares = alpha_phase(
        engine, qp, bench, two_phase, specs, records)
    launches_adapt, adapt_share = adaptive_phase(qp, bench)
    launches_fast, fast_out = fast_phase(stacked)
    launches_f32, f32_first, f32_out = f32_phase(stacked,
                                                           solver_mod)
    launches_preplay, preplay = parity_replay_phase(log_stacked)
    launches_serve, serve_table, serve_traces, census = serving_phase()
    launches_shard, shard_times, sweep, shard_graphs = sharded_phase(
        stacked, log_stacked, bench)
    def per_replay(name, graphs="warm"):
        """The kernel's launches in one replay of each engine's warm (or
        cold) graphs, counted under capture (`capture_census`)."""
        return {eng: census[eng][graphs][name] for eng in ("ds", "f64")}

    for r in records:
        nm = r["name"]
        paths = dict(
            alpha=sum(v[nm] for v in launches_alpha.values()),
            adaptive=launches_adapt[nm],
            fast=sum(v[nm] for v in launches_fast.values()),
            f32=launches_f32[nm],
            parity_replay=sum(v[nm] for v in launches_preplay.values()),
            serving=sum(v[nm] for v in launches_serve.values()),
            sharded=sum(v[nm] for v in launches_shard.values()))
        for path, n in paths.items():
            r[f"launches_{path}"] = n
        r["launches"] += sum(paths.values())
        r["launches_per_replay"] = per_replay(nm)
        r["launches_per_replay_cold"] = per_replay(nm, "cold")
    # the full-layout kernels' launches in one replay of each captured
    # graph pair of a full-layout engine, counted under capture
    per_graph = lambda rep, nm: rep["launches"][nm]
    full_rec.update(
        launches_per_full_graph=per_graph(full_graphs, "admm_chunk_full_f64"),
        launches_per_fast_graph={
            k: per_graph(v["graphs"], "admm_chunk_full_f64")
            for k, v in fast_out.items()},
        launches_per_parity_replay={
            k: {w: per_graph(v[w], "admm_chunk_full_f64")
                for w in ("cold", "warm")} for k, v in preplay.items()},
        launches_per_shard_graph={
            k: per_graph(v, "admm_chunk_full_f64")
            for k, v in shard_graphs.items()})
    full_rec.update(
        ms_alpha=full_alpha["ms"], plain_ms_alpha=full_alpha["plain_ms"],
        bound_ms_alpha=full_alpha["bound_ms"],
        bound_by_alpha=full_alpha["bound_by"],
        max_abs_err_alpha=full_alpha["max_abs_err"])
    f32_paths = dict(
        alpha=sum(v["admm_chunk_full_f32"] for v in launches_alpha.values()),
        adaptive=launches_adapt["admm_chunk_full_f32"],
        fast=sum(v["admm_chunk_full_f32"] for v in launches_fast.values()),
        f32=launches_f32["admm_chunk_full_f32"],
        parity_replay=sum(v["admm_chunk_full_f32"]
                          for v in launches_preplay.values()),
        serving=sum(v["admm_chunk_full_f32"] for v in launches_serve.values()),
        sharded=sum(v["admm_chunk_full_f32"]
                    for v in launches_shard.values()))
    records.append(dict(
        name="admm_chunk_full_f32", route="cuda",
        source="fcc_qp_tpu_torch/csrc/admm_chunk.cu",
        replaces="fcc_qp_tpu/ops/pallas_admm.py:445",
        launches=sum(f32_paths.values()),
        **{f"launches_{k}": v for k, v in f32_paths.items()},
        max_abs_err=f32_first["max_abs_err"], ms=f32_first["ms"],
        plain_ms=f32_first["plain_ms"], bound_ms=f32_first["bound_ms"],
        bound_by=f32_first["bound_by"], library_ms=None,
        launches_per_replay=per_replay("admm_chunk_full_f32"),
        launches_per_replay_cold=per_replay("admm_chunk_full_f32", "cold"),
        launches_per_f32_graph=f32_out["graphs"]["launches"][
            "admm_chunk_full_f32"],
        blocks_per_sm={n: pallas_admm.blocks_per_sm("admm_chunk_full_f32", n)
                       for n in (24, 42, 60, 76, 90)},
        registers={k: v[0] for k, v in ptxas.items()
                   if k.startswith("admm_chunk_full_warp<float")},
    ))
    log("[graphs] the captured B = 1 solve (drop-in, per Solve; serving, "
        "per depth, with each depth's profiled submit loop): "
        + json.dumps(dict(dropin=dropin_table, serving=serve_table,
                          traces=serve_traces, census=census)))
    log("[graphs:batched] the captured batched solves (phase 2, cold B = "
        f"{B}; phase 5, the replay's step 0 and warm steps at S = "
        f"{REPLAY_S}): " + json.dumps(dict(cold=bench_graphs,
                                           replay=replay_graphs)))
    log("[slice] the option and module paths: " + json.dumps(dict(
        io=io_rec, alpha_shares=alpha_shares, adaptive_share=adapt_share,
        fast=fast_out, f32=f32_out, sharded_walls=shard_times,
        scaling=sweep["results"])))
    log("[graphs:engines] the captured full-layout engines (phase 6, the "
        "full engine at B = 8192; phase 13, solve_batched_fast; phase 14, "
        "the parity engine on f32 data; phase 15, the parity replay; phase "
        "17, two shards of 4096): " + json.dumps(dict(
            full=full_graphs, fast={k: v["graphs"] for k, v in
                                    fast_out.items()},
            f32=f32_out["graphs"], parity_replay=preplay,
            sharded=shard_graphs)))

    # 18. the bench entry point for every model; each reduced kernel on
    # the quadruped's and the humanoid's chunks
    launches_entry, entry_cases, entry_report = entry_phase(
        engine, specs, log_stacked, replay_sols)
    for r in records:
        nm = r["name"]
        r["launches_entry"] = {m: v[nm] for m, v in launches_entry.items()}
        r["launches"] += sum(r["launches_entry"].values())
        r["launches_per_entry_graph"] = {
            m: {kind: {w: c[w]["launches"][nm] for w in c}
                for kind, c in rep["captures"].items()}
            for m, rep in entry_report.items()}
        for model, sfx in ENTRY_SUFFIX.items():
            for case, c in entry_cases[model].get(nm, {}).items():
                pre = "" if case == "first" else f"_{case}"
                r.update({f"{key}{pre}_{sfx}": c[key] for key in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "active", "k",
                    "max_abs_err")})
    log("[entry] the bench entry point per model (phase 18): "
        + json.dumps(entry_report))

    # 19. the public surface and the walking-log example
    import tempfile

    with tempfile.TemporaryDirectory() as out_dir:
        launches_surface, surface_cases, surface_report = surface_phase(
            example_module(), qp, bench, stacked, solver_mod, out_dir)
    for r in records:
        nm = r["name"]
        r["launches_surface"] = {p: v[nm] for p, v in launches_surface.items()}
        r["launches"] += sum(r["launches_surface"].values())
        for case, c in surface_cases.get(nm, {}).items():
            r.update({f"{key}_{case}": c[key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "active",
                "max_abs_err")})
    log("[surface] the public surface and the example (phase 19): "
        + json.dumps(surface_report))

    # 20. result lines
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
