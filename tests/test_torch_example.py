"""The port's walking-log example (`examples/replay_walking_torch.py`) on
the CPU, against the JAX package's API called at the JAX example's
options (`examples/replay_walking.py`: the drop-in loop at rho 0.3, and
one `solve_batched_ds` with scaling, constrained splitting and the
operator presolve) on the same synthesized 16-step Cassie log.

Bars: statuses and n_iter equal (loop: the f64 engine, the reference
algorithm in both packages; batched: the example's options run no f32
approach phase, only the high-precision endgame on operators refined
from f32 seeds, and the packages agree step for step here as on 400
steps, `exp_full_reference.py example_batched`); |dz| <= 1e-9 (1 + max
|z|) for the loop (the f64 engine's bar on Cassie's raw data,
`tests/test_torch_api.py`) and 1e-6 for the batched solve (the ds
engine's bar there). The diagnostic PNG is written; the script runs
as a program and exits 0; without a card and without ``--device cpu``
it raises."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import fcc_qp_tpu as J
from fcc_qp_tpu.core.ds_engine import solve_batched_ds, to_ds_batch
from fcc_qp_tpu.models.osc import CASSIE, generate_osc_sequence
from fcc_qp_tpu.utils.io import stack_qp_dicts
from test_torch_public_surface import without_shared_cache  # noqa: F401

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "examples", "replay_walking_torch.py")
STEPS = 16
KEYS = ("Q", "b", "A_eq", "b_eq", "friction_coeffs", "lb", "ub")
# examples/replay_walking.py's options at its defaults
LOOP_OPTS = dict(rho=0.3, eps_fcone=1e-6, eps_bound=1e-6, max_iter=3000)
BATCHED_OPTS = dict(max_iter=3000, rho=0.05, eps_fcone=1e-6, eps_bound=1e-6,
                    scaling=True, splitting="constrained",
                    presolve="operator")


@pytest.fixture(scope="module")
def example():
    spec = importlib.util.spec_from_file_location("replay_walking_torch",
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax(mode):
    """The JAX package on the log the example synthesizes: (z, n_iter,
    status)."""
    qps = generate_osc_sequence(CASSIE, STEPS, seed=0)
    if mode == "loop":
        s = J.FCCQP(60, 38, 12, 38)
        s.set_options(J.FCCQPOptions(**LOOP_OPTS))
        rows = []
        for i, qp in enumerate(qps):
            s.set_warm_start(i > 0)
            s.Solve(*(qp[k] for k in KEYS))
            r = s.GetSolution()
            rows.append((np.asarray(r.z), r.details.n_iter,
                         r.details.solve_status))
        z, n, st = zip(*rows)
        return np.stack(z), np.asarray(n), np.asarray(st)
    sol, _ = solve_batched_ds(to_ds_batch(stack_qp_dicts(qps)), CASSIE.shape,
                              J.FCCQPOptions(**BATCHED_OPTS), timing=False)
    return (np.asarray(sol.z), np.asarray(sol.details.n_iter),
            np.asarray(sol.details.solve_status))


@pytest.mark.parametrize("mode", ["loop", "batched"])
def test_replay_matches_the_jax_example(example, mode, tmp_path):
    out = str(tmp_path / f"{mode}.png")
    r = example.replay(["--steps", str(STEPS), "--mode", mode, "--device",
                        "cpu", "--out", out])
    jz, jn, jst = _jax(mode)
    assert r["z"].shape == (STEPS, 60) and np.isfinite(r["z"]).all()
    np.testing.assert_array_equal(r["status"], jst)
    np.testing.assert_array_equal(r["iters"], jn)
    dz = np.abs(r["z"] - jz).max(axis=1)
    if mode == "loop":
        assert (dz <= 1e-9 * (1.0 + np.abs(jz).max(axis=1))).all()
        assert (r["times"] > 0).all() and len(r["walls"]) == STEPS
    else:
        assert dz.max() <= 1e-6
        assert len(r["walls"]) == 1 and r["walls"][0] > 0
    assert (r["fviol"] <= 1e-6).all() and (r["bviol"] <= 1e-6).all()
    example.make_plots(r["z"], r["times"], r["iters"], r["fviol"],
                       r["bviol"], out)
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_script_runs_on_the_cpu(tmp_path):
    out = tmp_path / "plots.png"
    proc = subprocess.run(
        [sys.executable, SCRIPT, "--device", "cpu", "--steps", "8", "--out",
         str(out)],
        capture_output=True, text=True, timeout=600, cwd=str(tmp_path),
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "batched replay:" in proc.stdout and out.exists()
    assert not (tmp_path / "replay_plots.png").exists()


def test_needs_a_card_without_device_cpu(example, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mode in ("loop", "batched"):
        with pytest.raises(RuntimeError, match="CUDA"):
            example.replay(["--steps", "2", "--mode", mode, "--out",
                            str(tmp_path / "x.png")])
    assert example.parse_args([]).out == "replay_plots_torch.png"
