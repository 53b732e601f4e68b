"""The replay driver: `replay_ds_streams` over ``streams`` x ``steps``
consecutive steps of a walking log, each call on the next of
``log_sets`` logs made at set-up (step 0 cold, the rest warm-started)."""

from __future__ import annotations

import time

import numpy as np
import torch

from qpbench import roofline
from qpbench.drivers import (Driver, K_SUCCESS, batch_last, bounded_rows,
                              rows_of)


class Replay(Driver):
    e2e = ("replay_solves_per_s",)
    tiny = dict(streams=4, steps=3, sample_per_call=3, trace_first=1,
                trace_steps=1)

    def setup(self) -> None:
        from fcc_qp_tpu_torch import replay_ds_streams

        t = self.traffic
        self.S, self.steps = int(t["streams"]), int(t["steps"])
        self.logs = []
        for _ in range(int(t["log_sets"])):
            log = self.make_log(self.S * self.steps)
            self.kb = bounded_rows(log)
            self.logs.append(batch_last(log))
            del log
        self.call = lambda log: replay_ds_streams(
            log, self.shape, self.opts, n_streams=self.S, device=self.device)
        for log in self.logs:  # the first call captures
            self.call(log)
        self.sync()

    def window(self, seconds: float) -> dict:
        ok = attempted = calls = 0
        S, steps = self.S, self.steps
        t0 = time.perf_counter()
        ends = []
        while True:
            log = self.logs[calls % len(self.logs)]
            sols, _ = self.call(log)
            d = sols.details
            st = d.solve_status
            ok += int((st == K_SUCCESS).sum())
            attempted += st.numel()
            warm = lambda a: a.view(S, steps)[:, 1:]
            self.add("warm_iters", warm(d.n_iter).sum(), S * (steps - 1))
            self.add("polish_accepted", warm(d.polish_accepted).sum(),
                     S * (steps - 1))
            rows = torch.from_numpy(self.pick(
                st.numel(), int(d.n_iter.argmax()))).to(self.device)
            self.samples.append((rows_of(log, rows), sols.z[rows], st[rows]))
            calls += 1
            ends.append(time.perf_counter())
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        return dict(values={"replay_solves_per_s": ok / wall},
                    attempted=attempted, failed=attempted - ok, calls=calls,
                    wall_s=wall, call_s=np.diff([t0] + ends))

    def traced(self, tracer) -> dict:
        """Warm steps ``trace_first`` .. ``trace_first + trace_steps - 1``
        of one replay call (a whole call is ~10^6 kernels)."""
        from fcc_qp_tpu_torch.core import graphs

        first = int(self.traffic.get("trace_first", 8))
        n = int(self.traffic.get("trace_steps", 2))
        orig = graphs.CapturedBatch.run
        count = [0]

        def run(cap, warm_start, between=None):
            i = count[0]
            count[0] += 1
            if i == first:
                tracer.start()
            out = orig(cap, warm_start, between)
            if i == first + n - 1:
                tracer.stop()
            return out

        graphs.CapturedBatch.run = run
        try:
            sols, _ = self.call(self.logs[0])
        finally:
            graphs.CapturedBatch.run = orig
        if count[0] < first + n:
            # the eager path (no card) runs no captured batch
            return dict(work=None)
        d = sols.details
        sel = lambda a: a.view(self.S, self.steps)[:, first:first + n]
        work = roofline.reduced_work(
            self.kb + self.dims["nc"], self.kb, self.dims["n_cones"],
            sel(d.n_iter_f32).flatten().tolist(),
            sel(d.n_iter_ds).flatten().tolist())
        return dict(work=work)

    def release(self) -> None:
        self.logs = None


DRIVER = Replay
