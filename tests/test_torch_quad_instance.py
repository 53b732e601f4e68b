"""Instance 456 of the quadruped's bench cold batch (the walking log's
step 456, `generate_osc_sequence(QUADRUPED, 65536, seed=0,
smoothness=0.002)`, whose actuator bounds are a quantile over all 65536
steps) at the bench flags, alone, in both packages.

In the cold batch of the log's first 512 steps the packages give this
instance different statuses (JAX: kSuccess, polish accepted at its third
attempt after 228 f32 iterations; the port's plain versions: 203 f32
iterations, every attempt rejected, the f64 endgame to the cap). The
port's batched f32 products round with the batch they run in, which
moves this instance's approach and round chunks by 25 iterations (of
the 512, 12 more move by one iteration and one by 20); the polish
attempt at the other point then misreads the active set (ROADMAP.md
queue C). Alone, the two packages agree: both pinned here."""

import dataclasses

import numpy as np
import pytest
import torch

import fcc_qp_tpu as J
import fcc_qp_tpu_torch as T
from fcc_qp_tpu.core.ds_engine import solve_batched_ds, to_ds_batch
from fcc_qp_tpu.models.osc import MODELS as JMODELS
from fcc_qp_tpu_torch import bench
from fcc_qp_tpu_torch.models.osc import MODELS, generate_osc_sequence
from fcc_qp_tpu_torch.utils.io import stack_qp_dicts
from test_torch_public_surface import without_shared_cache  # noqa: F401

torch.set_num_threads(1)

INSTANCE = 456
# its outcome alone, in both packages
PINNED = dict(solve_status=0, n_iter=228, n_iter_f32=228, n_iter_ds=0,
              polish_attempts=4, polish_accepted=1)


@pytest.fixture(scope="module")
def instance():
    qps = generate_osc_sequence(MODELS["quadruped"], 65536, seed=0,
                                smoothness=0.002)
    return stack_qp_dicts(qps[INSTANCE:INSTANCE + 1])


def test_quadruped_instance_456_alone_in_both_packages(instance):
    model = MODELS["quadruped"]
    opts = bench.options(bench.parse_args(["--model", "quadruped"]))
    jsol, _ = solve_batched_ds(to_ds_batch(instance),
                               JMODELS["quadruped"].shape,
                               J.FCCQPOptions(**dataclasses.asdict(opts)),
                               timing=False)
    tsol, _ = T.solve_batched_ds(T.to_ds_batch(instance, device="cpu"),
                                 model.shape, opts, device="cpu")
    for name, sol in (("JAX", jsol), ("port", tsol)):
        got = {f: int(np.asarray(getattr(sol.details, f))[0]) for f in PINNED}
        assert got == PINNED, name
    assert float(tsol.details.admm_residual_friction_cone[0]) <= 1e-6
    assert np.abs(tsol.z.numpy() - np.asarray(jsol.z)).max() <= 1e-6
