"""The traced sub-window: `torch.profiler` over a short steady stretch
of the timed path, reduced to device busy time, kernel time by name and
the idle gaps by what the host was doing.

On the card the profiler records the device's activity and the host's
CUDA calls only (recording every host operator as well slows a
`FCCQP.Solve` several times over, and the idle share would measure the
profiler). The window is marked on the device: a spin kernel
(`torch.cuda._sleep`, `MARK`) is queued as the stretch starts and
another as it ends, and the window runs from the first marker's start
to the second's end. Nothing is synchronized at the start, so a
stretch that begins while earlier work is queued (a replay's later
steps) starts when that work ends; records outside the window are
clipped. The profiler drops a marker that runs too close to its own
start or stop (one stretch in six of the loop cell's lost one, on the
card, where the device is idle as the stretch starts and ends): the
host waits `EDGE_WAIT_S` after the profiler starts, before the first
marker, and after the second, before the profiler stops. A stretch
whose markers are still missing raises `MarkersLost`, and the run
traces it again. Device records are kernels, copies and sets (every
event the profiler places on the CUDA device, but the markers and the host's
annotations mirrored there); the busy time is the length of their
union. The profiler's own stalls of the host (`PROFILER_OWN`: its
activity buffers flushed, requested or full) are not the program's:
the time in them while the device was idle leaves both the idle time
and the window (``window_s`` is the window less that time, ``stall_s``),
so the idle share reads the program and not the profiler. Each idle gap
left is named by the innermost host activity open at its middle (over
the 2000 longest gaps), "(host, no CUDA call)" where the host was
between CUDA calls. On the CPU (tests) the window is a host annotation,
`WINDOW`.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

WINDOW = "qpbench.traced_window"
MARK = "spin_kernel"
# about half a microsecond at the H100's clock
MARK_CYCLES = 1000
# the host's wait between the profiler's start and the first marker,
# and between the second marker and the profiler's stop
EDGE_WAIT_S = 0.05
# entries of each breakdown list
TOP = 10
# the profiler's own host activity (CUPTI's activity buffers): time the
# host spends there is the trace's cost, not the program's
PROFILER_OWN = frozenset(("Buffer Flush", "Activity Buffer Request",
                          "Command Buffer Full"))


class MarkersLost(RuntimeError):
    """The profiler lost a marker of the traced window."""


class Tracer:
    """Starts and stops one profiled window; `summary` reduces it."""

    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None
        self._rf = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        cuda = self.device.type == "cuda"
        self.prof = profile(activities=[ProfilerActivity.CUDA if cuda
                                        else ProfilerActivity.CPU])
        self.prof.start()
        if cuda:
            time.sleep(EDGE_WAIT_S)
            torch.cuda._sleep(MARK_CYCLES)
        else:
            self._rf = torch.autograd.profiler.record_function(WINDOW)
            self._rf.__enter__()

    def stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda._sleep(MARK_CYCLES)
            torch.cuda.synchronize(self.device)
            time.sleep(EDGE_WAIT_S)
        else:
            self._rf.__exit__(None, None, None)
        self.prof.stop()

    @contextlib.contextmanager
    def window(self):
        self.start()
        try:
            yield self
        finally:
            self.stop()

    def summary(self, kernel_prefix: str = "admm_chunk") -> dict:
        """``busy_s``, ``window_s``, ``stall_s`` (the profiler's own
        stalls with the device idle, left out of ``window_s``),
        ``kernel_s`` (device seconds of the kernels whose name holds
        ``kernel_prefix``), ``n_device`` (device records) and the
        breakdown lists."""
        return reduce_events(self.prof.profiler.kineto_results.events(),
                             kernel_prefix)


def _short(name: str) -> str:
    """A kernel's name without its argument list and return type."""
    if "(" in name[1:]:
        name = name[:name.index("(", 1)]
    return name[5:] if name.startswith("void ") else name


def _union(starts: np.ndarray, ends: np.ndarray):
    """Merged intervals of sorted-by-start arrays: (starts, ends)."""
    if len(starts) == 0:
        return starts, ends
    cum_end = np.maximum.accumulate(ends)
    new = np.empty(len(starts), dtype=bool)
    new[0] = True
    new[1:] = starts[1:] > cum_end[:-1]
    idx = np.flatnonzero(new)
    m_starts = starts[idx]
    m_ends = np.maximum.reduceat(ends, idx)
    return m_starts, m_ends


def reduce_events(events, kernel_prefix: str = "admm_chunk") -> dict:
    on_dev = [str(e.device_type()).endswith("CUDA") for e in events]
    marks = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e, d in zip(events, on_dev) if d and MARK in e.name())
    win = [e for e, d in zip(events, on_dev) if not d and e.name() == WINDOW]
    if len(marks) >= 2:
        w0, w1 = marks[0][0], marks[-1][1]
    elif win:
        w0 = win[0].start_ns()
        w1 = w0 + win[0].duration_ns()
    else:
        raise MarkersLost(f"the traced window's markers are missing "
                          f"({len(marks)} of 2 recorded)")
    # a host range (`record_function`) is mirrored on the device's
    # timeline under the same name: not device work
    host_names = {e.name() for e, d in zip(events, on_dev) if not d}
    dev, host = [], []
    for e, is_dev in zip(events, on_dev):
        s = e.start_ns()
        d = e.duration_ns()
        name = e.name()
        if is_dev:
            if name in host_names or MARK in name:
                continue
            a, b = max(s, w0), min(s + d, w1)
            if b > a:
                dev.append((a, b, name or "(unnamed device record)"))
        elif name != WINDOW and d > 0:
            host.append((s, s + d, name))
    by_name: dict = {}
    kernel_ns = 0
    for a, b, name in dev:
        short = _short(name)
        by_name[short] = by_name.get(short, 0) + (b - a)
        if kernel_prefix in name:
            kernel_ns += b - a
    dev.sort()
    st = np.array([d[0] for d in dev], dtype=np.int64)
    en = np.array([d[1] for d in dev], dtype=np.int64)
    ms, me = _union(st, en)
    busy_ns = int((me - ms).sum()) if len(ms) else 0
    # the profiler's own stalls, clipped to the window, join the busy
    # intervals: what is left of the window between them is the idle
    stalls = [(max(a, w0), min(b, w1)) for a, b, name in host
              if name in PROFILER_OWN and min(b, w1) > max(a, w0)]
    bs = np.concatenate([st, np.array([a for a, _ in stalls], np.int64)])
    be = np.concatenate([en, np.array([b for _, b in stalls], np.int64)])
    order = np.argsort(bs, kind="stable")
    bs, be = _union(bs[order], be[order])
    stall_ns = (int((be - bs).sum()) if len(bs) else 0) - busy_ns
    window_s = (w1 - w0 - stall_ns) * 1e-9
    # idle gaps inside the window, named by the innermost host activity
    # open at the gap's middle
    g_starts = np.concatenate([[w0], be]) if len(bs) else np.array([w0])
    g_ends = np.concatenate([bs, [w1]]) if len(bs) else np.array([w1])
    gaps = g_ends - g_starts
    keep = gaps > 0
    g_starts, gaps = g_starts[keep], gaps[keep]
    order = np.argsort(-gaps)[:2000]
    hs = np.array([h[0] for h in host], dtype=np.int64)
    he = np.array([h[1] for h in host], dtype=np.int64)
    hn = [h[2] for h in host]
    idle_by: dict = {}
    for i in order:
        mid = g_starts[i] + gaps[i] // 2
        name = "(host, no CUDA call)"
        if len(hs):
            open_ = np.flatnonzero((hs <= mid) & (he >= mid))
            if len(open_):
                j = open_[np.argmin(he[open_] - hs[open_])]
                name = hn[j]
        idle_by[name] = idle_by.get(name, 0) + int(gaps[i])
    top = lambda d: [[k, v * 1e-9] for k, v in sorted(
        d.items(), key=lambda kv: -kv[1])[:TOP]]
    return dict(busy_s=busy_ns * 1e-9, window_s=window_s,
                stall_s=stall_ns * 1e-9,
                kernel_s=kernel_ns * 1e-9, n_device=len(dev),
                breakdown=dict(device_ops=top(by_name),
                               idle_gaps=top(idle_by)))
