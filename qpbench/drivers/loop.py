"""The loop driver: the drop-in `FCCQP` on its ``engine``, one `Solve` +
`GetSolution` per step of a ``steps``-long log held in host memory (as
a controller passes its arrays), warm-started from step 1, wrapping to
step 0 cold."""

from __future__ import annotations

import time

import numpy as np
import torch

from qpbench import roofline
from qpbench.drivers import Driver, K_SUCCESS, KEYS


class Loop(Driver):
    e2e = ("solve_ms_p50",)
    tiny = dict(steps=40, warmup_steps=2, sample_size=5, trace_steps=2)

    def setup(self) -> None:
        from fcc_qp_tpu_torch import FCCQP

        t = self.traffic
        T = int(t["steps"])
        log = self.make_log(T)
        # a controller passes host arrays
        self.host = {k: v.cpu().numpy() for k, v in log.items()}
        del log
        n, m, nc, ls = (self.dims[k] for k in ("n", "m", "nc", "ls"))
        self.solver = FCCQP(n, m, nc, ls, engine=t.get("engine", "auto"),
                            device=self.device)
        self.solver.set_options(self.opts)
        self.T = T
        self.j = 0
        for _ in range(int(t.get("warmup_steps", 32))):
            self.step(record=False)
        self.sync()
        self.j = 0

    def step(self, record=True):
        """One control tick: Solve + GetSolution on log step ``j``."""
        j = self.j
        h = self.host
        self.solver.set_warm_start(j > 0)
        t0 = time.perf_counter()
        self.solver.Solve(*(h[k][j] for k in KEYS))
        r = self.solver.GetSolution()
        wall = time.perf_counter() - t0
        self.j = (j + 1) % self.T
        return j, wall, r

    def window(self, seconds: float) -> dict:
        n = self.dims["n"]
        cap = 1 << 20
        walls = np.empty(cap)
        dev_s = np.empty(cap)
        iters = np.empty(cap, dtype=np.int64)
        status = np.empty(cap, dtype=np.int64)
        idx = np.empty(cap, dtype=np.int64)
        zs = np.empty((cap, n))
        i = 0
        t0 = time.perf_counter()
        while True:
            j, wall, r = self.step()
            d = r.details
            walls[i], dev_s[i] = wall, d.solve_time
            iters[i], status[i], idx[i] = d.n_iter, d.solve_status, j
            zs[i] = r.z
            i += 1
            if time.perf_counter() - t0 >= seconds or i == cap:
                break
        wall = time.perf_counter() - t0
        walls, dev_s = walls[:i], dev_s[:i]
        self.counters["device_ms"] = dev_s * 1e3
        self.counters["host_ms"] = (walls - dev_s) * 1e3
        ok = int((status[:i] == K_SUCCESS).sum())
        # one sample of the whole window, with its hardest step
        k = min(i, int(self.traffic.get("sample_size", 1024)))
        rows = np.unique(np.append(self.rng.choice(i, size=k, replace=False),
                                   int(np.argmax(iters[:i]))))
        steps_ = idx[rows]
        qp = {k: torch.from_numpy(self.host[k][steps_]).to(self.device)
              for k in KEYS}
        self.samples.append((qp, torch.from_numpy(zs[rows]).to(self.device),
                             torch.from_numpy(status[rows]).to(
                                 self.device)))
        ms = walls * 1e3
        return dict(values={"solve_ms_p50": float(np.percentile(ms, 50))},
                    attempted=i, failed=i - ok, calls=i, wall_s=wall,
                    call_s=walls)

    def traced(self, tracer) -> dict:
        """``trace_steps`` ticks, continuing the warm chain."""
        dets = []
        with tracer.window():
            for _ in range(int(self.traffic.get("trace_steps", 300))):
                _, _, r = self.step()
                dets.append(r.details)
        if self.solver.engine == "ds":
            # the batched engine at B = 1: the reduced kernels
            kb = int(np.isfinite(self.host["ub"][0]).sum())
            work = roofline.reduced_work(
                kb + self.dims["nc"], kb, self.dims["n_cones"],
                [d.n_iter_f32 for d in dets], [d.n_iter_ds for d in dets])
        else:
            work = roofline.full_work(
                self.dims["n"], self.dims["nc"],
                [roofline.full_iterations(d.n_iter, self.opts.max_iter)
                 for d in dets])
        return dict(work=work)

    def release(self) -> None:
        self.solver = None


DRIVER = Loop
