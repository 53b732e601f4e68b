"""The port's benchmark entry point (`python -m fcc_qp_tpu_torch.bench`),
on the CPU at a tiny size (``--device cpu --batch 8 --steps 3
--cold-batch 16 --repeats 1``): its JSON record against the JAX
`bench.py`'s keys, its cold solve and replay against the JAX package's
on the same log and options, its flags and its ``.fqlog`` cache.

The JAX side of each parity test runs in a process of its own
(`tests/torch_bench_jax_worker.py`), started before the port's side so
that its compile overlaps the port's run."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fcc_qp_tpu_torch import bench
from fcc_qp_tpu_torch.models.osc import MODELS
from fcc_qp_tpu_torch.utils.io import load_qp_log_packed

# torch's CPU thread pool runs the port's small batched products many
# times slower at its default thread count than at one or two, and the
# suite's test workers share the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_bench_jax_worker.py")
BATCH, STEPS, COLD = 8, 3, 16
TINY = ["--device", "cpu", "--batch", str(BATCH), "--steps", str(STEPS),
        "--cold-batch", str(COLD), "--repeats", "1"]
# the keys of bench.py's JSON line (bench.py:266-342): with the replay
# (ds engine) and without it (--no-replay, or the f64 / f32 engines); the
# port adds "engine" and "device"
COLD_KEYS = {"metric", "unit", "model", "cold_solves_per_sec",
             "cold_pipelined_solves_per_sec", "cold_converged_pct",
             "cold_polish_accept_pct", "value", "vs_baseline"}
REPLAY_KEYS = COLD_KEYS | {"warm_iters_p50", "replay_converged_pct",
                           "replay_T", "warm_polish_accept_pct"}
PORT_KEYS = {"engine", "device"}


def _log(tmp_path, argv):
    """The walking log the bench at ``argv`` solves, cached in
    ``tmp_path`` as the bench caches it; returns the file's path."""
    args = bench.parse_args(argv)
    _, T = bench.sizes(args)
    bench.walking_log(args, T, str(tmp_path))
    return str(tmp_path / f"id_qp_log_{args.model}_T{T}.fqlog")


def _start_jax(tmp_path, model, engine, streams, fqlog):
    out = tmp_path / f"jax_{model}_{engine}.npz"
    proc = subprocess.Popen(
        [sys.executable, WORKER, str(out), model, engine, str(COLD),
         str(streams), str(STEPS), fqlog],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
    return proc, out


def _jax_result(proc, out):
    _, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, err[-4000:]
    return np.load(out)


def _check_record(rec, keys, model, engine):
    assert set(rec) == keys | PORT_KEYS
    assert rec["metric"] == "qp_solves_per_sec_per_chip"
    assert rec["unit"] == "solves/s"
    assert (rec["model"], rec["engine"], rec["device"]) == (model, engine,
                                                           "cpu")
    for k in ("cold_solves_per_sec", "cold_pipelined_solves_per_sec",
              "value"):
        assert rec[k] > 0
    for k in ("cold_converged_pct", "cold_polish_accept_pct",
              "replay_converged_pct", "warm_polish_accept_pct"):
        if k in rec:
            assert 0.0 <= rec[k] <= 100.0
    assert rec["vs_baseline"] == round(rec["value"] / 1e4, 3)
    if "replay_T" in rec:
        assert rec["replay_T"] == BATCH * STEPS
        assert 0 <= rec["warm_iters_p50"] <= 3000


def _d(sol, name):
    return getattr(sol.details, name).numpy()


def _z_bars(z, zj, accepted):
    """`tests/test_torch_slice.py`'s z bars: 1e-6 where both packages'
    polish accepted, the JAX package's own 5e-3 between two valid
    solutions elsewhere."""
    if accepted.any():
        assert np.abs(z[accepted] - zj[accepted]).max() < 1e-6
    if len(z):
        assert np.abs(z - zj).max() < 5e-3


def _invariants(model, stacked, sol, eq_bar):
    """Every kSuccess instance of the port: its ADMM residuals, |A_eq z -
    b_eq| within ``eq_bar(stacked)`` per instance, the bounds and the
    friction cones (the drop-in step checks' 1e-5)."""
    ok = _d(sol, "solve_status") == 0
    z = sol.z.numpy()[ok]
    st = {k: v[ok] for k, v in stacked.items()}
    assert (_d(sol, "admm_residual_bounds")[ok] <= 1e-6).all()
    assert (_d(sol, "admm_residual_friction_cone")[ok] <= 1e-6).all()
    eq = np.abs(np.einsum("bij,bj->bi", st["A_eq"], z) - st["b_eq"]).max(1)
    assert (eq <= eq_bar(st)).all()
    assert (z >= st["lb"] - 1e-5).all() and (z <= st["ub"] + 1e-5).all()
    ls = MODELS[model].shape.lambda_c_start
    mu = st["friction_coeffs"]
    f = z[:, ls:ls + 3 * mu.shape[1]].reshape(len(z), -1, 3)
    assert (np.linalg.norm(f[..., :2], axis=-1) <= mu * f[..., 2]
            + 1e-5).all()


def test_record_keys_and_ranges(tmp_path):
    """A Cassie run at the tiny size: the record has bench.py's keys for
    the same flags plus ``engine`` and ``device``, each in range, and the
    solutions the shapes of the cold batch and the replay."""
    rec, sol, sols = bench.run(TINY, cache_dir=str(tmp_path))
    _check_record(rec, REPLAY_KEYS, "cassie", "ds")
    assert tuple(sol.z.shape) == (COLD, 60)
    assert tuple(sols.z.shape) == (BATCH * STEPS, 60)
    assert np.isfinite(sol.z.numpy()).all()
    assert np.isfinite(sols.z.numpy()).all()


def test_quadruped_equals_the_jax_bench(tmp_path):
    """The quadruped (k = 24, 6 polish Newton steps): the cold solve and
    the replay give the JAX package's statuses, n_iter and polish
    acceptance, instance for instance, and z within the slice test's
    bars."""
    argv = TINY + ["--model", "quadruped"]
    proc, out = _start_jax(tmp_path, "quadruped", "ds", BATCH,
                           _log(tmp_path, argv))
    rec, sol, sols = bench.run(argv, cache_dir=str(tmp_path))
    j = _jax_result(proc, out)
    _check_record(rec, REPLAY_KEYS, "quadruped", "ds")
    for prefix, s in (("cold", sol), ("replay", sols)):
        for name in ("solve_status", "n_iter", "polish_accepted"):
            np.testing.assert_array_equal(_d(s, name), j[f"{prefix}_{name}"],
                                          err_msg=f"{prefix} {name}")
        both = (_d(s, "polish_accepted") > 0) & (j[f"{prefix}_polish_accepted"]
                                                > 0)
        _z_bars(s.z.numpy(), j[f"{prefix}_z"], both)


def test_humanoid_against_the_jax_bench(tmp_path):
    """The humanoid (k = 47, the kernels' two-slot layout), held to counts
    and invariants rather than instance for instance: its f32 approach
    phase rounds differently in the two packages (on the bench log's
    first 512 steps n_iter differs on 82 instances, the statuses on none;
    exp_full_reference.py bench_humanoid). The port's kSuccess count at
    least the JAX package's less one, cold and in the replay; z within
    the slice test's bars wherever both converge; every port kSuccess
    held to the invariants (residuals, A_eq z, bounds, cones)."""
    argv = TINY + ["--model", "humanoid"]
    fqlog = _log(tmp_path, argv)
    proc, out = _start_jax(tmp_path, "humanoid", "ds", BATCH, fqlog)
    rec, sol, sols = bench.run(argv, cache_dir=str(tmp_path))
    j = _jax_result(proc, out)
    _check_record(rec, REPLAY_KEYS, "humanoid", "ds")
    stacked = load_qp_log_packed(fqlog)
    cold_eq = lambda st: 1e-8 * (1.0 + np.abs(st["b_eq"]).max(1))
    # a warm step the polish accepts is as exact as its acceptance test,
    # eps_bound (ROADMAP.md queue C)
    warm_eq = lambda st: np.maximum(cold_eq(st), 1e-6)
    for prefix, s, rows, eq_bar in (("cold", sol, COLD, cold_eq),
                                    ("replay", sols, BATCH * STEPS, warm_eq)):
        ok = _d(s, "solve_status") == 0
        jok = j[f"{prefix}_solve_status"] == 0
        assert ok.sum() >= jok.sum() - 1, (prefix, ok.sum(), jok.sum())
        both = ok & jok
        acc = (_d(s, "polish_accepted") > 0) & (
            j[f"{prefix}_polish_accepted"] > 0)
        _z_bars(s.z.numpy()[both], j[f"{prefix}_z"][both], acc[both])
        _invariants("humanoid", {k: v[:rows] for k, v in stacked.items()},
                    s, eq_bar)


@pytest.mark.parametrize("engine,extra", [("f64", []),
                                          ("f32", ["--no-replay"])])
def test_parity_engines_against_the_jax_bench(tmp_path, engine, extra):
    """``--engine f64`` and ``--engine f32 --no-replay`` on Cassie: the
    parity engine's `solve_batched` at bench.py:204-211's options in the
    data's dtype, with the JAX package's statuses instance for instance;
    the record has bench.py's keys without the replay's. On f64 data the
    n_iter are the JAX package's too. On f32 data at eps 1e-6 the
    iteration sits on the f32 floor, where XLA's and PyTorch's f32
    products, which round differently, move the stopping step (ROADMAP.md
    queue C; on these 16 instances by up to 23 of ~430 iterations): there
    z is held to `tests/test_torch_options.py`'s f32 bar and every
    kSuccess to its residuals."""
    argv = TINY + ["--engine", engine] + extra
    proc, out = _start_jax(tmp_path, "cassie", engine, 0,
                           _log(tmp_path, argv))
    rec, sol, sols = bench.run(argv, cache_dir=str(tmp_path))
    j = _jax_result(proc, out)
    _check_record(rec, COLD_KEYS, "cassie", engine)
    assert sols is None
    assert tuple(sol.z.shape) == (COLD, 60)
    assert sol.z.dtype == (torch.float64 if engine == "f64"
                           else torch.float32)
    np.testing.assert_array_equal(_d(sol, "solve_status"),
                                  j["cold_solve_status"])
    if engine == "f64":
        np.testing.assert_array_equal(_d(sol, "n_iter"), j["cold_n_iter"])
        return
    jz = j["cold_z"]
    rel = np.abs(sol.z.numpy() - jz).max(1) / (1 + np.abs(jz).max(1))
    assert rel.max() <= 2e-3
    ok = _d(sol, "solve_status") == 0
    for name in ("admm_residual_bounds", "admm_residual_friction_cone"):
        assert (_d(sol, name)[ok] <= 1e-6).all()


@pytest.mark.parametrize("flag", [["--no-pallas"], ["--timeout", "60"],
                                  ["--_child"]])
def test_unported_flags_are_errors(flag):
    """The JAX bench's Pallas switch and its watchdog flags are not
    ported: argparse refuses them."""
    with pytest.raises(SystemExit):
        bench.parse_args(TINY + flag)


def test_raises_without_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.run(["--batch", "8", "--steps", "3", "--cold-batch", "16"],
                  cache_dir=str(tmp_path))
    assert not os.listdir(tmp_path)   # nothing generated or cached


@pytest.mark.parametrize("smoothness", [0.002, 0.05])
def test_log_cache_is_shared_with_the_jax_bench(tmp_path, smoothness):
    """The bench's ``.fqlog`` cache has the JAX bench's name and bytes: a
    log the port cached loads bit for bit through the JAX package's
    `load_qp_log_packed`, and a log the JAX package cached under that name
    is what the port's bench loads, bit for bit the port's own."""
    from fcc_qp_tpu.models.osc import QUADRUPED as JQUADRUPED
    from fcc_qp_tpu.models.osc import generate_osc_sequence as jgenerate
    from fcc_qp_tpu.utils.io import load_qp_log_packed as jload
    from fcc_qp_tpu.utils.io import save_qp_log_packed as jsave

    argv = TINY + ["--model", "quadruped", "--smoothness", str(smoothness)]
    args = bench.parse_args(argv)
    sm = "" if smoothness == 0.002 else f"_s{smoothness:g}"
    name = f"id_qp_log_quadruped{sm}_T24.fqlog"
    port = bench.walking_log(args, 24, str(tmp_path / "port"))
    assert os.listdir(tmp_path / "port") == [name]
    back = jload(str(tmp_path / "port" / name))
    os.makedirs(tmp_path / "jax")
    jsave(str(tmp_path / "jax" / name),
          jgenerate(JQUADRUPED, 24, seed=0, smoothness=smoothness))
    loaded = bench.walking_log(args, 24, str(tmp_path / "jax"))
    for k, v in port.items():
        for other in (back[k], loaded[k]):
            assert other.dtype == np.float64
            assert np.array_equal(other.view(np.uint64), v.view(np.uint64))
