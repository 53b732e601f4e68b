"""The TALOS multi-contact configuration and the two cells that came with
it (`talos-mc-cold`, `humanoid-replay`), as cases of what
`test_qpbench_gen.py` and `test_qpbench_correct.py` check for the first
cells: the generator's log against the program's NumPy original for the
port's own robot (`models.osc.PORT_MODELS`), the control not correct in
each new cell, and a run whose timed path is broken underneath read
``correct`` false for each fault the cell can have."""

import json
import os
import time

import numpy as np
import pytest
import torch

from fcc_qp_tpu_torch.models.osc import PORT_MODELS, generate_osc_sequence
from qpbench import gen, run, spec
from qpbench import test_qpbench_correct as correct_cases

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
T = 96
NEW_CELLS = ["talos-mc-cold", "humanoid-replay"]


def config(name):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        return json.load(f)


def make(name, T=T, seed=2**33 + 5, device="cpu"):
    c = config(name)
    return gen.walking_log(c["model"], c["generator"], T,
                           gen.generator(seed, device), device)


def original(name, T=T):
    c = config(name)
    g = dict(c["generator"])
    seed = g.pop("structure_seed")
    qps = generate_osc_sequence(PORT_MODELS[name], T, seed=seed, **g)
    return {k: np.stack([q[k] for q in qps]) for k in gen.KEYS}


def test_talos_dimensions_are_the_models():
    m = PORT_MODELS["talos_mc"]
    c = config("talos_mc")
    d = gen.dims(c["model"])
    s = m.shape
    assert (d["n"], d["m"], d["nc"], d["ls"]) == (
        s.num_vars, s.num_eq, s.nc, s.lambda_c_start) == (118, 62, 48, 70)
    assert (c["num_vars"], c["num_eq"], c["nc"], c["lambda_c_start"]) == (
        s.num_vars, s.num_eq, s.nc, s.lambda_c_start)
    for k in ("nv_dof", "nu", "nh", "nc", "nc_rows", "n_slack", "mu"):
        assert c["model"][k] == getattr(m, k)
    assert c["constrained_k"] == m.nu + m.nc == 80


def test_talos_block_layout_and_bound_pattern():
    log = {k: v.numpy() for k, v in make("talos_mc").items()}
    ref = original("talos_mc")
    for k in gen.KEYS:
        assert log[k].shape == ref[k].shape, k
    for k in ("Q", "A_eq", "b"):
        assert ((log[k] != 0) == (ref[k] != 0)).all(), k
    Q = log["Q"]
    assert np.allclose(Q, np.swapaxes(Q, 1, 2), rtol=0, atol=1e-12)
    assert (np.linalg.eigvalsh(Q) > 0).all()
    fin = np.isfinite(log["ub"])
    assert np.array_equal(fin, np.isfinite(ref["ub"]))
    assert np.array_equal(log["lb"][fin], -log["ub"][fin])
    assert np.array_equal(log["friction_coeffs"], ref["friction_coeffs"])
    nv = config("talos_mc")["model"]["nv_dof"]
    M = log["A_eq"][:, :nv, :nv]
    assert (np.linalg.eigvalsh(M) > 0).all()


def test_talos_bound_quantile_is_calibrated():
    c = config("talos_mc")
    log = make("talos_mc", T=200)
    m = c["model"]
    nv, nu = m["nv_dof"], m["nu"]
    u = gen.equality_optimum(log["Q"], log["b"], log["A_eq"],
                             log["b_eq"])[:, nv:nv + nu].abs().flatten()
    share = float((u <= log["ub"][0, nv]).double().mean())
    q = c["generator"]["bound_quantile"]
    assert abs(share - q) <= 1.0 / u.numel() + 1e-12


def test_talos_robot_is_the_originals():
    from fcc_qp_tpu_torch.models.osc import _spd

    c = config("talos_mc")
    m = c["model"]
    r = gen.robot(m, c["generator"]["structure_seed"])
    rng = np.random.default_rng(c["generator"]["structure_seed"])
    assert np.array_equal(r["M0"], _spd(rng, m["nv_dof"], cond=50.0))
    assert np.array_equal(r["Jc0"], rng.normal(size=(m["nc"], m["nv_dof"])))


@pytest.mark.parametrize("workload", NEW_CELLS)
def test_control_is_not_correct_in_the_new_cells(workload):
    correct_cases.test_control_is_not_correct(workload)


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in NEW_CELLS for f in correct_cases.FAULTS])
def test_a_broken_timed_path_is_not_correct_in_the_new_cells(
        tiny_root, monkeypatch, workload, fault):
    correct_cases._break(monkeypatch, workload, fault)
    out = run.run_cell(workload, 2**33 + 43, 0.5, False, "cpu",
                       time.time(), root=tiny_root,
                       bench_dir=os.path.join(tiny_root, "qpbench"))
    assert out["correct"] is False, out["checks"]


def test_new_cells_run_whole_and_correct_on_the_cpu(tiny_root):
    """Each new cell at the CPU's tiny sizes: a correct run whose line
    carries the cell's end-to-end metrics."""
    for workload in NEW_CELLS:
        out = run.run_cell(workload, 2**33 + 47, 0.5, False, "cpu",
                           time.time(), root=tiny_root,
                           bench_dir=os.path.join(tiny_root, "qpbench"))
        assert out["correct"] is True, (workload, out["checks"])
        e2e = {m["name"] for m in spec.cell(REPO, workload).end_to_end}
        assert set(out["metrics"]) == e2e


@pytest.mark.chip
def test_full_talos_log_on_the_card_in_seconds(card):
    make("talos_mc", T=16, device=card)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    log = make("talos_mc", T=16384, device=card)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    assert log["Q"].shape == (16384, 118, 118)
    assert seconds < 10.0, seconds
