"""Device synchronization and timing (port of `fcc_qp_tpu/utils/timing.py`).

PyTorch launches CUDA work asynchronously: a host clock read right after
a call measures the enqueue, not the work. `sync` is the barrier every
host-clock span must end in, `cuda_span` times a region with CUDA
events on the current stream, and `timed` is the JAX package's best-of-N
wall of a call.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch


def sync(device=None) -> None:
    """Block until all queued work on ``device`` has finished (no-op for
    the CPU, whose operations are synchronous)."""
    if device is None or torch.device(device).type == "cuda":
        if torch.cuda.is_available():
            torch.cuda.synchronize(device)


def _cuda_devices(tree, out: set) -> set:
    """The CUDA devices of the tensors in ``tree`` (a tensor, dataclass,
    named tuple, tuple, list or dict of them)."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            out.add(tree.device)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            _cuda_devices(getattr(tree, f.name), out)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _cuda_devices(v, out)
    return out


def timed(fn, *args, reps: int = 3, **kw):
    """Best-of-``reps`` wall time of ``fn(*args, **kw)``, each call ended
    by a true barrier: a synchronize of every card that holds a tensor of
    its result (the CPU needs none). The first call (which captures or
    builds what later calls replay) is excluded. Returns ``(best_seconds,
    last_result)``."""
    def call():
        out = fn(*args, **kw)
        for dev in _cuda_devices(out, set()):
            torch.cuda.synchronize(dev)
        return out

    out = call()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = call()
        best = min(best, time.perf_counter() - t0)
    return best, out


def stamp_solution_times(sol, solve_time: float, factor_time: float):
    """Broadcast host-measured per-phase wall times into a solution's
    details (every instance of a batched solve shares the wall clock)."""
    like = sol.details.admm_residual_bounds
    det = dataclasses.replace(
        sol.details,
        solve_time=torch.full_like(like, solve_time, dtype=torch.float64),
        factorization_time=torch.full_like(
            like, factor_time, dtype=torch.float64
        ),
    )
    return type(sol)(details=det, z=sol.z)


@contextlib.contextmanager
def cuda_span(out: dict, key: str):
    """Time the enclosed region with CUDA events on the current stream;
    writes milliseconds into ``out[key]`` on exit (synchronizes)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    yield
    end.record()
    end.synchronize()
    out[key] = start.elapsed_time(end)


class StageClock:
    """Accumulates synchronized wall seconds per named stage of a solve
    into ``out`` (`mark` closes the stage that ran since the previous
    mark), and instance counts (`count`). With ``out=None`` it neither
    synchronizes nor records, so an untimed solve keeps its asynchronous
    launches."""

    def __init__(self, out=None, device=None):
        self.out, self.device = out, device
        self.t = None
        if out is not None:
            sync(device)
            self.t = time.perf_counter()

    def mark(self, stage: str) -> None:
        if self.out is None:
            return
        sync(self.device)
        now = time.perf_counter()
        self.out[stage] = self.out.get(stage, 0.0) + (now - self.t)
        self.t = now

    def count(self, key: str, mask) -> None:
        """Adds the number of set entries of ``mask`` (or an int) to
        ``out[key]`` (a host read, so only when recording)."""
        if self.out is None:
            return
        n = int(mask.sum()) if isinstance(mask, torch.Tensor) else int(mask)
        self.out[key] = self.out.get(key, 0) + n

