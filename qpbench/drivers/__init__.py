"""What every driver of the benchmark's traffic shares. A traffic mix is
a data file (`qpbench/traffic/<mix>.json`) that names its driver
(``"driver"``) and gives its sizes; the driver is the module
`qpbench/drivers/<driver>.py`, found by that name (`qpbench.spec.driver`),
whose ``DRIVER`` is a subclass of `Driver`. A new way of submitting work
is a new module here; a new mix of an existing one is a data file.

The drivers of the committed mixes:

  replay  `replay_ds_streams` over ``streams`` x ``steps`` consecutive
          steps of a walking log, each call on the next of ``log_sets``
          logs made at set-up (step 0 cold, the rest warm-started);
  cold    `solve_batched_ds` on cold batches of ``batch`` consecutive
          log steps, cycling over ``batches`` of them;
  loop    the drop-in `FCCQP` on its ``engine``: one `Solve` +
          `GetSolution` per step of a ``steps``-long log held in host
          memory, warm-started from step 1, wrapping to step 0 cold.

Every driver is a closed loop with one call in flight: it makes its data
from the seed on the device, warms up every shape the window uses, then
calls the program back to back until ``seconds`` have passed (the last
call ends the window). It keeps, from the seed, a sample of the answers
each call produced (``sample_per_call`` random ones and the call's
hardest, by iterations) for the comparison with the reference, the
program's per-instance counters for the per-layer metrics, and, when
asked, traces a short steady stretch (``trace_*`` keys).

A driver class gives ``e2e`` (the end-to-end metrics its window
measures), ``tiny`` (the sizes at which the CPU tests run its mixes),
``setup``, ``window(seconds)``, ``traced(tracer)`` and ``release``.
"""

from __future__ import annotations

import numpy as np
import torch

from qpbench import gen

KEYS = gen.KEYS
# `FCCQPSolveStatus.kSuccess`
K_SUCCESS = 0


def options(cell):
    """The solver options of the cell: the mix's ``options``, with the
    configuration's own ``solver`` settings (the model's Newton steps)."""
    from fcc_qp_tpu_torch import FCCQPOptions

    return FCCQPOptions(**{**cell.traffic["options"],
                           **cell.config.get("solver", {})})


def problem_shape(cell):
    from fcc_qp_tpu_torch import ProblemShape

    d = gen.dims(cell.config["model"])
    return ProblemShape(num_vars=d["n"], num_eq=d["m"], nc=d["nc"],
                        lambda_c_start=d["ls"])


def bounded_rows(log: dict) -> int:
    """The number of coordinates with a finite bound (the same in every
    step of a log)."""
    return int((torch.isfinite(log["lb"][0]) | torch.isfinite(
        log["ub"][0])).sum())


class Driver:
    """What every driver shares: the data, the sample, the counters."""

    e2e: tuple = ()
    tiny: dict = {}

    def __init__(self, cell, device: torch.device, seed: int):
        self.cell = cell
        self.traffic = cell.traffic
        self.device = device
        self.g = gen.generator(seed, device)
        # the sample is drawn on the host, from the seed too
        self.rng = np.random.default_rng(int(seed) % (1 << 64))
        self.model = cell.config["model"]
        self.dims = gen.dims(self.model)
        self.shape = problem_shape(cell)
        self.opts = options(cell)
        self.samples = []      # (qp dict batch-leading, z, status)
        self.counters: dict = {}

    def make_log(self, T: int) -> dict:
        """A T-step walking log, its walk drawn from the run's seed."""
        return gen.walking_log(self.model, self.cell.config["generator"],
                               T, self.g, self.device)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def pick(self, n_rows: int, hardest: int) -> np.ndarray:
        """``sample_per_call`` distinct rows of a call, drawn from the
        seed, and the call's hardest row."""
        k = min(int(self.traffic.get("sample_per_call", 64)), n_rows)
        rows = self.rng.choice(n_rows, size=k, replace=False)
        return np.unique(np.append(rows, hardest))

    def add(self, key: str, total, count) -> None:
        t, c = self.counters.get(key, (0, 0))
        self.counters[key] = (t + total, c + count)

    def sample(self):
        """The sampled QPs (a batch-leading dict on the device) and the
        program's answers and statuses for them."""
        qp = {k: torch.cat([s[0][k] for s in self.samples])
              for k in KEYS}
        z = torch.cat([s[1] for s in self.samples])
        st = torch.cat([s[2] for s in self.samples])
        return qp, z, st

    def release(self) -> None:
        """Drop the program's data and state (the reference runs after)."""


def batch_last(log: dict):
    from fcc_qp_tpu_torch import QPBatchDS

    return QPBatchDS(*(log[k].movedim(0, -1).contiguous() for k in KEYS))


def rows_of(batch, rows: torch.Tensor) -> dict:
    """Rows of a batch-last `QPBatchDS` as a batch-leading dict."""
    return {k: getattr(batch, k).index_select(-1, rows).movedim(
        -1, 0).contiguous() for k in KEYS}
