"""The port's benchmark: one cell of `BENCHMARK.json`, one run.

    python3 -m qpbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds the program (`fcc_qp_tpu_torch/`)
on a machine with an NVIDIA card. A run makes its data from ``--seed``
on the card, sets up (the kernels from the program's build cache in the
checkout, the captures of the cell's own shapes), calls the program in a
closed loop for ``--seconds``, reads its answers against the plain
reference, and prints one JSON line last on stdout: the cell's
end-to-end metrics (``--trace 0``) or its per-layer metrics, read from
the program's counters and from a `torch.profiler` trace of a short
steady stretch after the window (``--trace 1``). The numbers compared
with the reference go last on stderr and last in the line (``checks``).

Exits non-zero, printing no result, without a card (or with fewer than
the cell asks for), without the program in the checkout, or when `jax`,
`jaxlib`, `flax` or the JAX package `fcc_qp_tpu` was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROGRAM = "fcc_qp_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "fcc_qp_tpu")
# kernel and build caches, at fixed paths inside the checkout
CACHE = os.path.join(ROOT, ".qpbench_cache")
# traced stretches a run makes at most, one after another, while the
# profiler loses a marker of the window (`qpbench.trace.MarkersLost`)
TRACE_TRIES = 4


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def process_start_wall() -> float:
    """The wall-clock time this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of `FORBIDDEN`, whole
    (``fcc_qp_tpu_torch`` is not ``fcc_qp_tpu``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m qpbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _mean(pair):
    total, count = pair
    return float(total) / count if count else None


def record_of(drv, window: dict, trace) -> dict:
    """What the per-layer readers read: the driver's counters, the
    window's counts and the traced stretch (None when not traced)."""
    rec = {k: (_mean(v) if isinstance(v, tuple) else v)
           for k, v in drv.counters.items()}
    rec["window"] = window
    rec["trace"] = trace
    return rec


def trace_stretch(drv, workload: str):
    """The driver's traced stretch, reduced (None where the driver traces
    nothing); traced again, up to `TRACE_TRIES` times in all, where the
    profiler lost a marker of its window."""
    from qpbench import roofline
    from qpbench import trace as tracing

    for attempt in range(1, TRACE_TRIES + 1):
        tr = tracing.Tracer(drv.device)
        work = drv.traced(tr)
        if tr.prof is None:
            return None
        try:
            traced = tr.summary()
        except tracing.MarkersLost as e:
            log(f"[{workload}] traced stretch {attempt} of {TRACE_TRIES}: "
                f"{e}")
            if attempt == TRACE_TRIES:
                raise
            continue
        traced.update(work)
        if work.get("work") is not None:
            traced["least"] = roofline.least_seconds(work["work"])
        log(f"[{workload}] traced: window {traced['window_s']:.6f} s "
            f"(less the profiler's stalls, {traced['stall_s']:.6f} s), "
            f"busy {traced['busy_s']:.6f} s, admm_chunk "
            f"{traced['kernel_s']:.6f} s, {traced['n_device']} device "
            f"records; least {traced.get('least')}")
        return traced


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, root: str = ROOT,
             bench_dir: str = None) -> dict:
    """One run of the cell ``workload`` on ``device`` (the benchmark's
    `main` passes the card; tests pass the CPU): returns the result
    line as a dict. ``t_start``: the wall-clock start of the process,
    from which ``setup_s`` counts."""
    import numpy as np
    import torch

    from qpbench import check, drivers, spec

    bench_dir = bench_dir or os.path.join(root, "qpbench")
    cell = spec.cell(root, workload, bench_dir)
    drv = spec.driver(cell.traffic["driver"], bench_dir)(
        cell, torch.device(device), seed)
    drv.setup()
    t_window = time.time()
    setup_s = t_window - t_start
    log(f"[{workload}] set-up {setup_s:.3f} s; window of {seconds} s")
    win = drv.window(seconds)
    log(f"[{workload}] window: {win['calls']} calls, {win['attempted']} "
        f"QPs, {win['failed']} not kSuccess, {win['wall_s']:.3f} s; "
        f"{win['values']}")
    c = win["call_s"]
    log(f"[{workload}] seconds a call: first {list(c[:3])}, last "
        f"{list(c[-3:])}, min {c.min()}, median {float(np.median(c))}, "
        f"max {c.max()}")
    traced = trace_stretch(drv, workload) if trace else None
    dev = drv.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        device_rec = {"platform": "gpu",
                      "kind": torch.cuda.get_device_name(dev),
                      "count": 1, "memory_peak_bytes": int(peak)}
    else:
        device_rec = {"platform": "cpu", "kind": "cpu", "count": 1,
                      "memory_peak_bytes": 0}
    rec = record_of(drv, win, traced)
    qp, z, status = drv.sample()
    # the program's state goes before the reference runs
    drv.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    solved = status == drivers.K_SUCCESS
    qp = {k: v[solved] for k, v in qp.items()}
    d = drv.dims
    t0 = time.perf_counter()
    read = check.readings(qp, z[solved], d["ls"], d["nc"])
    correct, compared = check.verdict(read)
    log(f"[{workload}] reference over {read['n_read']} sampled answers "
        f"({int((~solved).sum())} sampled not kSuccess, not read; "
        f"{read['ref_unsolved']:.4f} of them unsolved by the reference) in "
        f"{time.perf_counter() - t0:.3f} s")

    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                v = setup_s
            else:
                v = win["values"][m["name"]]
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = spec.reader(m["name"], bench_dir)(rec, m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": int(win["attempted"]),
           "failed": int(win["failed"]), "metrics": metrics,
           "device": device_rec}
    if trace and traced is not None:
        out["device"]["busy_s"] = traced["busy_s"]
        out["device"]["window_s"] = traced["window_s"]
        out["breakdown"] = traced["breakdown"]
    out["checks"] = compared
    return out


def card_line() -> str:
    """The card's name and power limit as `nvidia-smi` prints them."""
    import subprocess

    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "--id=0"],
            capture_output=True, text=True, timeout=30)
        return res.stdout.strip() or "nvidia-smi printed nothing"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None) -> int:
    t_start = process_start_wall()
    args = parse_args(argv)
    for sub in ("triton", "torch_extensions", "nv"):
        os.makedirs(os.path.join(CACHE, sub), exist_ok=True)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv")
    if not os.path.isdir(os.path.join(ROOT, PROGRAM)):
        log(f"qpbench: the program ({PROGRAM}/) is not in {ROOT}")
        return 2
    sys.path.insert(0, ROOT)
    import torch

    # the host drives the card from one thread: no intra-op worker
    # threads spinning beside it
    torch.set_num_threads(1)

    from qpbench import spec

    cell = spec.cell(ROOT, args.workload)
    chips = [w for w in spec.benchmark(ROOT)["workloads"]
             if w["name"] == args.workload][0]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"qpbench: the cell needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            "; no CPU fallback")
        return 3
    import fcc_qp_tpu_torch

    where = os.path.dirname(os.path.abspath(fcc_qp_tpu_torch.__file__))
    if os.path.dirname(where) != ROOT:
        log(f"qpbench: {PROGRAM} was imported from {where}, not from the "
            "checkout")
        return 2
    log(f"[{cell.name}] {card_line()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   "cuda", t_start)
    found = forbidden_modules()
    if found:
        log(f"qpbench: loaded in this process: {', '.join(found)}")
        return 4
    for name, c in out["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
