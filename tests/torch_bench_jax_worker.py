"""Worker of the bench entry point's parity tests
(`tests/test_torch_bench.py`): the JAX package's side of a tiny bench run,
in a process of its own.

    python tests/torch_bench_jax_worker.py <out.npz> <model> <engine> \\
        <cold_batch> <streams> <steps> <fqlog>

It loads the walking log the port's bench cached (``<fqlog>``, through
the JAX package's own `load_qp_log_packed`) and solves it as the JAX
`bench.py` does at its default flags with the model's polish Newton
steps: ``engine`` ``ds`` runs `solve_batched_ds` on the first
``cold_batch`` steps and `replay_ds_streams` over the first
``streams * steps`` in ``streams`` streams, both on the plain XLA chunk
bodies (``use_pallas=False``), in two threads; ``f64`` / ``f32`` runs
the parity engine's `solve_batched` on the cold batch in that dtype at bench.py:204-211's
options (``streams`` 0: no replay). The solutions' z and diagnostics go
to ``<out.npz>`` under ``cold_*`` and ``replay_*``.

XLA on the CPU needs the SSE4.2 pin for the double-single arithmetic,
and the persistent compilation cache stays off: its reads and writes are
where test workers have crashed."""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_cpu_max_isa=SSE4_2").strip()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_enable_compilation_cache", False)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from fcc_qp_tpu import FCCQPOptions, solve_batched  # noqa: E402
from fcc_qp_tpu.core.ds_engine import (replay_ds_streams,  # noqa: E402
                                       solve_batched_ds, to_ds_batch)
from fcc_qp_tpu.models.osc import MODELS  # noqa: E402
from fcc_qp_tpu.utils.io import load_qp_log_packed, to_qpbatch  # noqa: E402

FIELDS = ("solve_status", "n_iter", "polish_accepted", "polish_attempts",
          "admm_residual_bounds", "admm_residual_friction_cone")

out_path, name, engine = sys.argv[1:4]
cold_b, streams, steps = (int(a) for a in sys.argv[4:7])
stacked = load_qp_log_packed(sys.argv[7])
model = MODELS[name]
# bench.py:191-200 at its default flags
opts = FCCQPOptions(
    max_iter=3000, rho=0.05, eps_fcone=1e-6, eps_bound=1e-6,
    adaptive_rho=False, adaptive_rho_interval=100,
    adaptive_rho_max_adaptations=1, presolve="operator", scaling=True,
    splitting="constrained", kkt_refine_steps=1, polish=True,
    polish_rounds=4, polish_newton_steps=model.polish_newton_steps)
part = lambda n: {k: v[:n] for k, v in stacked.items()}
out = {}


def keep(prefix, sol):
    out[f"{prefix}_z"] = np.asarray(sol.z)
    for f in FIELDS:
        out[f"{prefix}_{f}"] = np.asarray(getattr(sol.details, f))


if engine == "ds":
    # the cold solve and the replay are two programs: compiled (most of
    # this process's time) in two threads
    with ThreadPoolExecutor(2) as pool:
        cold = pool.submit(solve_batched_ds, to_ds_batch(part(cold_b)),
                           model.shape, opts, use_pallas=False, timing=False)
        replay = streams and pool.submit(
            replay_ds_streams, to_ds_batch(part(streams * steps)),
            model.shape, opts, n_streams=streams, use_pallas=False)
        keep("cold", cold.result()[0])
        if replay:
            keep("replay", replay.result()[0])
else:
    dtype = jnp.float64 if engine == "f64" else jnp.float32
    sol, _ = solve_batched(
        to_qpbatch(part(cold_b), dtype=dtype), model.shape,
        opts.replace(adaptive_rho=False, scaling=False, splitting="full",
                     polish=False), timing=False)
    keep("cold", sol)
np.savez(out_path, **out)
print(f"OK {name} {engine}: cold {cold_b}, replay {streams} x {steps}")
