"""The port's benchmark entry point: QP solves per second on one card
over the walking-log replay (the counterpart of the repository's JAX
`bench.py`, with its flags, data, options, timing and JSON keys).

    python -m fcc_qp_tpu_torch.bench [--model cassie|quadruped|humanoid|
                                      talos_mc]
    python -m fcc_qp_tpu_torch.bench --device cpu --batch 8 --steps 3 \\
        --cold-batch 16 --repeats 1

The headline is a warm-started replay of the model's synthetic walking
log at eps 1e-6 (`replay_ds_streams`: ``--batch`` streams of ``--steps``
consecutive steps); the cold half solves the log's first ``--cold-batch``
steps as one batch (`solve_batched_ds`, or with ``--engine f64|f32`` the
parity engine's `solve_batched` on f64 or f32 data). The models are
`models.osc.PORT_MODELS`: the JAX package's three and the port's
``talos_mc`` (n = 118), which runs on the default path only:
``--engine f64|f32`` and ``--splitting full`` take the full-layout
kernels, which hold n <= 96 rows (`ops.pallas_admm.check_rows`), so
they raise for it on the card. On the card every
solve replays the captured graphs the engines make at their first call
(the first call is timed apart); ``--device cpu`` runs the kernels'
plain versions. Without a card and without ``--device cpu`` it raises.

The log is cached as ``test_data/id_qp_log_<model>[_s<smoothness>]_T<T>
.fqlog`` (the JAX bench's name and bytes, so the two share the cache).
Diagnostics, the CUDA-event device time of each timed call among them,
go to stderr; the last stdout line is one JSON object with the JAX
bench's keys plus ``engine`` and ``device`` (the card's name and power
limit as `nvidia-smi` gives them). Not ported: ``--no-pallas`` (the port
has one path on the card; the plain versions belong to the tests) and
the watchdog flags ``--timeout`` / ``--_child``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from fcc_qp_tpu_torch import (FCCQPOptions, replay_ds_streams, solve_batched,
                              solve_batched_ds, to_ds_batch)
from fcc_qp_tpu_torch.core.ds_engine import resolve_device
from fcc_qp_tpu_torch.models.osc import PORT_MODELS, generate_osc_sequence
from fcc_qp_tpu_torch.utils.io import (load_qp_log_packed, save_qp_log_packed,
                                       stack_qp_dicts, to_qpbatch)
from fcc_qp_tpu_torch.utils.timing import sync

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# cold solves issued back to back before one synchronize
PIPELINE_DEPTH = 4
# the reference C++ solver's ~1e4 solves/s on one core (BASELINE.md)
BASELINE_SOLVES_PER_S = 1e4


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m fcc_qp_tpu_torch.bench")
    p.add_argument("--batch", type=int, default=4096,
                   help="replay stream count")
    p.add_argument("--cold-batch", type=int, default=None,
                   help="cold-batch size (default: 8192 for the full bench, "
                        "--batch for --no-replay runs)")
    p.add_argument("--steps", type=int, default=16,
                   help="warm-started steps per stream; the replay log is "
                        "batch*steps solves")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--max-iter", type=int, default=3000)
    p.add_argument("--rho", type=float, default=0.05)
    p.add_argument("--eps", type=float, default=1e-6)
    p.add_argument("--model", choices=sorted(PORT_MODELS), default="cassie",
                   help="talos_mc runs on --engine ds with constrained "
                        "splitting only (n = 118 > the full layout's 96)")
    p.add_argument("--smoothness", type=float, default=0.002,
                   help="per-step innovation rate of the synthetic log")
    p.add_argument("--engine", choices=["ds", "f64", "f32"], default="ds",
                   help="ds = the batched reduced engine; f64 / f32 = the "
                        "parity engine on f64 / f32 data (full layout: "
                        "n <= 96)")
    p.add_argument("--adaptive-rho", dest="adaptive", action="store_true",
                   default=False)
    p.add_argument("--no-adaptive-rho", dest="adaptive", action="store_false")
    p.add_argument("--no-scaling", dest="scaling", action="store_false",
                   default=True, help="disable cone-aware Ruiz equilibration")
    p.add_argument("--no-polish", dest="polish", action="store_false",
                   default=True, help="disable active-set polishing")
    p.add_argument("--polish-rounds", type=int, default=4)
    p.add_argument("--polish-newton-steps", type=int, default=None,
                   help="PDAS steps per attempt (default: the model's own)")
    p.add_argument("--splitting", choices=["constrained", "full"],
                   default="constrained")
    p.add_argument("--no-replay", dest="replay", action="store_false",
                   default=True, help="skip the warm replay headline")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a torch.profiler Chrome trace of one replay")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions)")
    return p.parse_args(argv)


def device_line(dev: torch.device) -> str:
    """The card's name and power limit as `nvidia-smi` gives them (``cpu``
    on the CPU)."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={dev.index or 0}"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def sizes(args) -> tuple:
    """``(cold batch, log length T)`` of the bench at ``args``
    (bench.py:151-160): the cold batch is the log's first steps, and the
    replay reads ``batch * steps`` of them."""
    cold_b = (args.cold_batch if args.cold_batch is not None
              else (max(8192, args.batch) if args.replay else args.batch))
    T = max(args.batch * args.steps, cold_b) if args.replay else cold_b
    return cold_b, T


def walking_log(args, T: int, cache_dir: str) -> dict:
    """The model's walking log of T steps, stacked, through the
    ``.fqlog`` cache in ``cache_dir``."""
    os.makedirs(cache_dir, exist_ok=True)
    sm = f"_s{args.smoothness:g}" if args.smoothness != 0.002 else ""
    cache = os.path.join(cache_dir, f"id_qp_log_{args.model}{sm}_T{T}.fqlog")
    if os.path.exists(cache):
        t0 = time.perf_counter()
        stacked = load_qp_log_packed(cache)
        log(f"loaded cached log {cache} in {time.perf_counter() - t0:.1f}s")
        return stacked
    t0 = time.perf_counter()
    stacked = stack_qp_dicts(generate_osc_sequence(
        PORT_MODELS[args.model], T, seed=0, smoothness=args.smoothness))
    save_qp_log_packed(cache, stacked)
    log(f"generated log in {time.perf_counter() - t0:.1f}s -> {cache}")
    return stacked


def options(args) -> FCCQPOptions:
    """The solver options of the bench at ``args`` (bench.py:191-200);
    the polish's Newton steps default to the model's own."""
    newton_steps = (args.polish_newton_steps
                    if args.polish_newton_steps is not None
                    else PORT_MODELS[args.model].polish_newton_steps)
    return FCCQPOptions(
        max_iter=args.max_iter, rho=args.rho,
        eps_fcone=args.eps, eps_bound=args.eps,
        adaptive_rho=args.adaptive, adaptive_rho_interval=100,
        adaptive_rho_max_adaptations=1, presolve="operator",
        scaling=args.scaling, splitting=args.splitting,
        kkt_refine_steps=1, polish=args.polish,
        polish_rounds=args.polish_rounds,
        polish_newton_steps=newton_steps,
    )


def timed_calls(call, n: int, dev: torch.device):
    """``n`` calls of ``call``, each timed on the host wall around a
    synchronize, with CUDA events around the same call on the card:
    ``(walls, device seconds or None, last result)``."""
    walls, device_s, out = [], [], None
    for _ in range(n):
        sync(dev)
        ev = ([torch.cuda.Event(enable_timing=True) for _ in range(2)]
              if dev.type == "cuda" else None)
        t0 = time.perf_counter()
        if ev:
            ev[0].record()
        out = call()
        if ev:
            ev[1].record()
        sync(dev)
        walls.append(time.perf_counter() - t0)
        if ev:
            device_s.append(ev[0].elapsed_time(ev[1]) * 1e-3)
    return walls, (device_s if dev.type == "cuda" else None), out


def _seconds(xs) -> str:
    return "not measured" if xs is None else "[" + ", ".join(
        f"{x:.6f}" for x in xs) + "] s"


def run(argv=None, cache_dir=None):
    """The benchmark at the flags ``argv`` (a list, as on the command
    line; None reads `sys.argv`). ``cache_dir``: where the log's
    ``.fqlog`` cache lives (default ``test_data/`` at the repository
    root). Returns ``(record, cold solution, replay solutions or None)``:
    the record is the JSON object `main` prints last."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    model = PORT_MODELS[args.model]
    shape = model.shape
    card = device_line(dev)
    log(f"device: {dev} ({card}), engine={args.engine}, model={args.model}, "
        f"polish={args.polish}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")

    cold_b, T = sizes(args)
    stacked = walking_log(args, T, cache_dir or os.path.join(ROOT,
                                                             "test_data"))
    cold_stacked = {k: v[:cold_b] for k, v in stacked.items()}

    opts = options(args)
    if args.engine == "ds":
        batch = to_ds_batch(cold_stacked, device=dev)
        run_cold = lambda: solve_batched_ds(batch, shape, opts, device=dev)
    else:
        dtype = torch.float64 if args.engine == "f64" else torch.float32
        batch = to_qpbatch(cold_stacked, dtype=dtype, device=dev)
        parity = opts.replace(adaptive_rho=False, scaling=False,
                              splitting="full", polish=False)
        run_cold = lambda: solve_batched(batch, shape, parity, device=dev)

    # cold batched throughput: the first call (the capture on the card)
    # apart, then the best of --repeats calls
    first, _, _ = timed_calls(run_cold, 1, dev)
    log(f"cold first call (capture+run): {first[0]:.3f}s")
    walls, device_s, (sol, _) = timed_calls(run_cold, args.repeats, dev)
    t_cold = min(walls)
    cold_rate = cold_b / t_cold
    log(f"cold walls {_seconds(walls)}; device time of the same calls "
        f"{_seconds(device_s)}")

    # pipelined: PIPELINE_DEPTH cold solves issued back to back, one
    # synchronize at the end
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(PIPELINE_DEPTH):
        run_cold()
    sync(dev)
    t_pipe = (time.perf_counter() - t0) / PIPELINE_DEPTH
    pipe_rate = cold_b / t_pipe

    d = sol.details
    q = lambda t: t.cpu().numpy()
    n_iter, status = q(d.n_iter), q(d.solve_status)
    conv = (status == 0).mean()
    cold_accept = 100.0 * float(q(d.polish_accepted).mean())
    log(f"cold: B={cold_b} best={t_cold * 1e3:.3f}ms ({cold_rate:.1f}/s; "
        f"pipelined depth={PIPELINE_DEPTH}: {pipe_rate:.1f}/s) iters "
        f"mean={n_iter.mean():.1f} p50={np.median(n_iter):.0f} "
        f"max={n_iter.max()} converged={conv * 100:.4f}% "
        f"max_resid=({q(d.admm_residual_bounds).max():.3e},"
        f"{q(d.admm_residual_friction_cone).max():.3e})")
    log(f"cold phases: f32_p50={np.median(q(d.n_iter_f32)):.0f} "
        f"ds_p50={np.median(q(d.n_iter_ds)):.0f} "
        f"polish_accept={cold_accept:.4f}% "
        f"attempts_mean={q(d.polish_attempts).mean():.4f}")

    out = {
        "metric": "qp_solves_per_sec_per_chip",
        "unit": "solves/s",
        "model": args.model,
        "cold_solves_per_sec": round(cold_rate, 1),
        "cold_pipelined_solves_per_sec": round(pipe_rate, 1),
        "cold_converged_pct": round(100.0 * conv, 2),
        "cold_polish_accept_pct": round(cold_accept, 2),
    }

    # the headline: the warm-started multi-stream replay (ds engine only)
    sols = None
    if args.replay and args.engine == "ds":
        T_r = args.batch * args.steps
        reps = to_ds_batch({k: v[:T_r] for k, v in stacked.items()},
                           device=dev)
        replay = lambda: replay_ds_streams(reps, shape, opts,
                                           n_streams=args.batch, device=dev)
        first, _, _ = timed_calls(replay, 1, dev)
        log(f"replay first call (capture+run): {first[0]:.3f}s")
        walls, device_s, (sols, _) = timed_calls(replay, args.repeats, dev)
        t_replay = min(walls)
        replay_rate = T_r / t_replay
        log(f"replay walls {_seconds(walls)}; device time of the same calls "
            f"{_seconds(device_s)}")
        if args.profile:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
            with profile(activities=acts) as prof:
                replay()
                sync(dev)
            os.makedirs(args.profile, exist_ok=True)
            path = os.path.join(args.profile,
                                f"replay_{args.model}_{os.getpid()}.json")
            prof.export_chrome_trace(path)
            log(f"profiler trace written to {path}")

        rd = sols.details
        n = q(rd.n_iter).reshape(args.batch, args.steps)
        st = q(rd.solve_status)
        conv_r = (st == 0).mean()
        warm = n[:, 1:] if args.steps > 1 else n
        log(f"warm replay: T={T_r} ({args.batch} streams x {args.steps}) "
            f"best={t_replay * 1e3:.3f}ms -> {replay_rate:.1f} solves/s "
            f"cold_iters p50={np.median(n[:, 0]):.0f} "
            f"warm_iters p50={np.median(warm):.0f} mean={warm.mean():.4f} "
            f"converged={conv_r * 100:.4f}% "
            f"max_resid=({q(rd.admm_residual_bounds).max():.3e},"
            f"{q(rd.admm_residual_friction_cone).max():.3e})")
        out["value"] = round(replay_rate, 1)
        out["warm_iters_p50"] = float(np.median(warm))
        out["replay_converged_pct"] = round(100.0 * conv_r, 2)
        out["replay_T"] = T_r
        acc_r = q(rd.polish_accepted).reshape(args.batch, args.steps)
        warm_acc = 100.0 * float(acc_r[:, 1:].mean())
        log(f"warm polish acceptance: {warm_acc:.4f}%")
        out["warm_polish_accept_pct"] = round(warm_acc, 2)
    else:
        out["value"] = round(cold_rate, 1)

    out["vs_baseline"] = round(out["value"] / BASELINE_SOLVES_PER_S, 3)
    out["engine"] = args.engine
    out["device"] = card
    return out, sol, sols


def main():
    record, _, _ = run()
    print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
