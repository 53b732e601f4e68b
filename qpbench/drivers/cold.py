"""The cold driver: `solve_batched_ds` on cold batches of ``batch``
consecutive log steps, cycling over ``batches`` of them."""

from __future__ import annotations

import time

import numpy as np
import torch

from qpbench import roofline
from qpbench.drivers import (Driver, K_SUCCESS, batch_last, bounded_rows,
                              rows_of)


class Cold(Driver):
    e2e = ("cold_solves_per_s",)
    tiny = dict(batch=8, batches=2, sample_per_call=3)

    def setup(self) -> None:
        from fcc_qp_tpu_torch import solve_batched_ds

        t = self.traffic
        B, nb = int(t["batch"]), int(t["batches"])
        log = self.make_log(B * nb)
        self.kb = bounded_rows(log)
        self.batches = [batch_last({k: v[i * B:(i + 1) * B]
                                    for k, v in log.items()})
                        for i in range(nb)]
        del log
        self.call = lambda qp: solve_batched_ds(qp, self.shape, self.opts,
                                                device=self.device)
        for qp in self.batches:  # the first call captures
            self.call(qp)
        self.sync()

    def window(self, seconds: float) -> dict:
        ok = attempted = calls = 0
        t0 = time.perf_counter()
        ends = []
        while True:
            qp = self.batches[calls % len(self.batches)]
            sol, _ = self.call(qp)
            d = sol.details
            st = d.solve_status
            ok += int((st == K_SUCCESS).sum())
            attempted += st.numel()
            self.add("polish_accepted", d.polish_accepted.sum(), st.numel())
            self.add("endgame_iters", d.n_iter_ds.sum(), st.numel())
            rows = torch.from_numpy(self.pick(
                st.numel(), int(d.n_iter.argmax()))).to(self.device)
            self.samples.append((rows_of(qp, rows), sol.z[rows], st[rows]))
            calls += 1
            ends.append(time.perf_counter())
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        return dict(values={"cold_solves_per_s": ok / wall},
                    attempted=attempted, failed=attempted - ok, calls=calls,
                    wall_s=wall, call_s=np.diff([t0] + ends))

    def traced(self, tracer) -> dict:
        """One whole cold call (~1.8 x 10^5 kernels)."""
        with tracer.window():
            sol, _ = self.call(self.batches[0])
        d = sol.details
        work = roofline.reduced_work(
            self.kb + self.dims["nc"], self.kb, self.dims["n_cones"],
            d.n_iter_f32.tolist(), d.n_iter_ds.tolist())
        return dict(work=work)

    def release(self) -> None:
        self.batches = None


DRIVER = Cold
