"""Worker of the warm-replay parity tests (`tests/test_torch_replay.py`):
the JAX package's side, in a process of its own.

    python tests/torch_replay_jax_worker.py <out_dir> [<cache_dir>]

It computes, on the walking log and at the options of
`tests/test_warm_replay_bench.py`, each part the tests compare the port
with, and writes each as ``<out_dir>/<part>.npz`` (written under another
name and renamed, so a reader never sees half a file) as soon as it is
done:

* ``refresh``: a KKT seed built on step 0 and refreshed against step 1
  (the last four instances against unrelated QPs), with its inputs;
* ``warm_step``: step 0 solved cold with the operator cache, then step 1
  warm from it: the carried state and cache, the warm step's solution
  and cache;
* ``replay``: the warm replay of the log (S = 16 streams x 4 steps),
  one jitted step at a time, in global row order;
* ``long``: the same replay of three streams of the bench's 65536-step
  log (the three repeated to S = 16, the first 48 rows kept), with the
  48 steps themselves.

A failure writes its traceback to ``<out_dir>/error.txt`` and exits 1.

XLA on the CPU needs the SSE4.2 pin for the double-single arithmetic.
The persistent compilation cache is ``<cache_dir>`` where one is given,
used by this worker alone, else off: the test workers' shared cache is
where they have crashed, in its reads (a segmentation fault in
`get_executable_and_time`)."""

import os
import sys
import traceback

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_cpu_max_isa=SSE4_2").strip()
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

from fcc_qp_tpu.core import ds_engine as jeng  # noqa: E402
from fcc_qp_tpu.models.osc import (CASSIE, generate_osc_batch,  # noqa: E402
                                   generate_osc_sequence)
from fcc_qp_tpu.ops.ds_linalg import (  # noqa: E402
    kkt_inverse_f32_refresh, kkt_inverse_f32_seed)
from fcc_qp_tpu.utils.io import stack_qp_dicts  # noqa: E402
from test_warm_replay_bench import BENCH_OPTS, S, STEPS  # noqa: E402

# three streams of the bench's long log, 16 steps each (the tests' own
# copy of these numbers: LONG_STREAMS, LONG_STEPS)
LONG_STREAMS = (1938, 2889, 3268)
LONG_STEPS = 16


def save(out_dir, part, **arrays):
    tmp = os.path.join(out_dir, f".{part}.npz")
    np.savez(tmp, **{k: np.asarray(v) for k, v in arrays.items()})
    os.replace(tmp, os.path.join(out_dir, f"{part}.npz"))


def step_of(stacked, t, steps):
    return {k: v[t::steps] for k, v in stacked.items()}


def solution(prefix, sol):
    """The solution's details and z under ``<prefix>_<field>``."""
    out = {f"{prefix}_{f}": getattr(sol.details, f)
           for f in sol.details.__dataclass_fields__}
    out[f"{prefix}_z"] = sol.z
    return out


def replay(stacked, steps, con_idx):
    """The JAX package's warm replay of ``stacked`` (S streams of
    ``steps`` consecutive rows), one jitted step at a time: the function
    its `replay_ds_streams` scans over, with the same carried warm state
    and operator cache. Returns its details and z in global row order."""
    sols, ws, cache = [], None, None
    for t in range(steps):
        sol, ws, cache = jeng._solve_ds_reduced_jit(
            jeng.to_ds_batch(step_of(stacked, t, steps)), ws, CASSIE.shape,
            BENCH_OPTS, t > 0, con_idx, cache=cache, with_cache=True)
        sols.append(sol)

    def glob(get):
        a = np.stack([np.asarray(get(s)) for s in sols], axis=1)
        return a.reshape(-1, *a.shape[2:])

    out = {f"replay_{f}": glob(lambda s, f=f: getattr(s.details, f))
           for f in sols[0].details.__dataclass_fields__}
    out["replay_z"] = glob(lambda s: s.z)
    return out


def main(out_dir):
    log = stack_qp_dicts(generate_osc_sequence(CASSIE, S * STEPS, seed=0,
                                               smoothness=0.002))
    con_idx = jeng.constrained_indices(jeng.to_ds_batch(log), CASSIE.shape)

    # refresh: a seed on step 0, refreshed against step 1 (the last four
    # instances against unrelated QPs, where the refresh cannot contract)
    qp0 = jeng.to_ds_batch(step_of(log, 0, STEPS))
    far = stack_qp_dicts(generate_osc_batch(CASSIE, 4, seed=3))
    nxt = step_of(log, 1, STEPS)
    for k in nxt:
        nxt[k] = np.concatenate([nxt[k][:12], far[k]])
    qp1 = jeng.to_ds_batch(nxt)
    qs0, sc = jeng._scale_reduced(qp0, CASSIE.shape, BENCH_OPTS)
    qs1, _ = jeng._scale_reduced(qp1, CASSIE.shape, BENCH_OPTS, carried=sc)
    mask = np.zeros(CASSIE.shape.num_vars, np.float32)
    mask[list(con_idx)] = 1.0
    rho = (np.float32(BENCH_OPTS.rho) * mask[:, None]
           * np.ones((1, S), np.float32))
    X0, _ = kkt_inverse_f32_seed(qs0.Q, qs0.A_eq, rho)
    Xj, rj = kkt_inverse_f32_refresh(X0, qs1.Q, qs1.A_eq, rho)
    save(out_dir, "refresh", X0=X0, Xj=Xj, rj=rj, Q1=qs1.Q.hi,
         A1=qs1.A_eq.hi, rho=rho, con_idx=np.asarray(con_idx))

    # warm_step: step 0 cold with the operator cache, step 1 warm from it
    _, jws, jcache = jeng._solve_ds_reduced_jit(
        jeng.to_ds_batch(step_of(log, 0, STEPS)), None, CASSIE.shape,
        BENCH_OPTS, False, con_idx, with_cache=True)
    jsol, _, jcache1 = jeng._solve_ds_reduced_jit(
        jeng.to_ds_batch(step_of(log, 1, STEPS)), jws, CASSIE.shape,
        BENCH_OPTS, True, con_idx, cache=jcache, with_cache=True)
    save(out_dir, "warm_step",
         x_hi=jws.x.hi, x_lo=jws.x.lo, mu_x_hi=jws.mu_x.hi,
         mu_x_lo=jws.mu_x.lo, mu_lc_hi=jws.mu_lambda_c.hi,
         mu_lc_lo=jws.mu_lambda_c.lo, ws_rho=jws.rho,
         kkt_seed=jcache.kkt_seed, polish_seed=jcache.polish_seed,
         polish_cls=jcache.polish_cls, d=jcache.scales.d,
         e=jcache.scales.e, c=jcache.scales.c,
         polish_cls1=jcache1.polish_cls, d1=jcache1.scales.d,
         e1=jcache1.scales.e, c1=jcache1.scales.c, **solution("sol", jsol))

    # replay: the whole log
    save(out_dir, "replay", **replay(log, STEPS, con_idx))

    # long: three streams of the bench's long log; the whole log is
    # generated, since its actuator bounds are a quantile over every step
    qps = generate_osc_sequence(CASSIE, 65536, seed=0, smoothness=0.002)
    sub = stack_qp_dicts([qps[s * LONG_STEPS + t]
                          for s in LONG_STREAMS for t in range(LONG_STEPS)])
    del qps
    n = len(LONG_STREAMS)
    # on S = 16 streams (the three, repeated), the batch the compiled
    # steps take; every instance is solved independently of the others
    rows = np.concatenate([np.arange(n * LONG_STEPS)] * (-(-S // n)))
    full = replay({k: v[rows[:S * LONG_STEPS]] for k, v in sub.items()},
                  LONG_STEPS, con_idx)
    keep = n * LONG_STEPS
    save(out_dir, "long", **{k: v[:keep] for k, v in full.items()},
         **{f"qp_{k}": v for k, v in sub.items()})


if __name__ == "__main__":
    out_dir = sys.argv[1]
    if len(sys.argv) > 2:
        jax.config.update("jax_compilation_cache_dir", sys.argv[2])
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    else:
        jax.config.update("jax_enable_compilation_cache", False)
    try:
        main(out_dir)
    except BaseException:
        with open(os.path.join(out_dir, "error.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
