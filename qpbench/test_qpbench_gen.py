"""The benchmark's walking-log generator against the program's NumPy
original (`fcc_qp_tpu_torch.models.osc.generate_osc_sequence`): the
same structure and calibration from another draw order."""

import json
import os
import time

import numpy as np
import pytest
import torch

from fcc_qp_tpu_torch.models.osc import MODELS, generate_osc_sequence
from qpbench import gen

HERE = os.path.dirname(os.path.abspath(__file__))
T = 96


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
    qps = generate_osc_sequence(MODELS[name], T, seed=seed, **g)
    return {k: np.stack([q[k] for q in qps]) for k in gen.KEYS}


@pytest.mark.parametrize("name", ["cassie", "humanoid"])
def test_dimensions_are_the_models(name):
    m = MODELS[name]
    c = config(name)
    d = gen.dims(c["model"])
    s = m.shape
    assert (d["n"], d["m"], d["nc"], d["ls"]) == (
        s.num_vars, s.num_eq, s.nc, s.lambda_c_start)
    assert (c["num_vars"], c["num_eq"], c["nc"], c["lambda_c_start"]) == (
        s.num_vars, s.num_eq, s.nc, s.lambda_c_start)
    for k in ("nv_dof", "nu", "nh", "nc", "nc_rows", "n_slack", "mu"):
        assert c["model"][k] == getattr(m, k)


@pytest.mark.parametrize("name", ["cassie", "humanoid"])
def test_block_layout_and_bound_pattern(name):
    log = {k: v.numpy() for k, v in make(name).items()}
    ref = original(name)
    for k in gen.KEYS:
        assert log[k].shape == ref[k].shape, k
    # the same blocks are structurally nonzero in every step
    for k in ("Q", "A_eq", "b"):
        assert ((log[k] != 0) == (ref[k] != 0)).all(), k
    # symmetric to rounding, as the original (its task block is a
    # product J'WJ, not symmetrised)
    Q = log["Q"]
    assert np.allclose(Q, np.swapaxes(Q, 1, 2), rtol=0, atol=1e-12)
    assert (np.linalg.eigvalsh(Q) > 0).all()
    # the actuators alone are bounded, symmetrically, the same in every
    # step
    fin = np.isfinite(log["ub"])
    assert np.array_equal(fin, np.isfinite(ref["ub"]))
    assert np.array_equal(fin, np.isfinite(log["lb"]))
    assert np.array_equal(log["lb"][fin], -log["ub"][fin])
    assert np.ptp(log["ub"][fin]) == 0
    assert np.array_equal(log["friction_coeffs"], ref["friction_coeffs"])
    # the mass matrix block of A_eq is symmetric positive definite
    nv = config(name)["model"]["nv_dof"]
    M = log["A_eq"][:, :nv, :nv]
    assert np.allclose(M, np.swapaxes(M, 1, 2))
    assert (np.linalg.eigvalsh(M) > 0).all()


@pytest.mark.parametrize("name", ["cassie", "humanoid"])
def test_bound_quantile_is_calibrated(name):
    c = config(name)
    log = make(name, T=200)
    m = c["model"]
    nv, nu = m["nv_dof"], m["nu"]
    u = gen.equality_optimum(log["Q"], log["b"], log["A_eq"],
                             log["b_eq"])[:, nv:nv + nu].abs().flatten()
    u_max = log["ub"][0, nv]
    q = c["generator"]["bound_quantile"]
    share = float((u <= u_max).double().mean())
    assert abs(share - q) <= 1.0 / u.numel() + 1e-12
    # and the original's calibration reads the same way on its own log
    ref = original(name, T=200)
    from fcc_qp_tpu_torch.models.osc import _equality_solve
    u_ref = np.abs(np.stack([
        _equality_solve(ref["Q"][t], ref["b"][t], ref["A_eq"][t],
                        ref["b_eq"][t])[nv:nv + nu] for t in range(200)]))
    share_ref = float((u_ref <= ref["ub"][0, nv]).mean())
    assert abs(share_ref - q) <= 1.0 / u_ref.size + 1e-12


@pytest.mark.parametrize("name", ["cassie", "humanoid"])
def test_robot_is_the_originals(name):
    """The fixed structure is the original's first draws at the
    configuration's structure seed."""
    from fcc_qp_tpu_torch.models.osc import _spd

    c = config(name)
    m = c["model"]
    r = gen.robot(m, c["generator"]["structure_seed"])
    rng = np.random.default_rng(c["generator"]["structure_seed"])
    assert np.array_equal(r["M0"], _spd(rng, m["nv_dof"], cond=50.0))
    if m["nh"]:
        assert np.array_equal(r["Jh0"], rng.normal(size=(m["nh"],
                                                         m["nv_dof"])))
    assert np.array_equal(r["Jc0"], rng.normal(size=(m["nc"], m["nv_dof"])))
    n_task = min(m["nv_dof"], 12)
    assert np.array_equal(r["Jt0"], rng.normal(size=(n_task, m["nv_dof"])))
    assert np.array_equal(r["w_task"], np.exp(rng.uniform(0, 2,
                                                          size=n_task)))


def test_walk_matches_its_recurrence():
    g = gen.generator(3, "cpu")
    alpha, T = 0.004, 300
    w = gen.smooth_walk(g, T, (2, 3), alpha, 0.5, "cpu")
    g = gen.generator(3, "cpu")
    x = torch.randn((6,), generator=g, dtype=torch.float64) * 0.5 * np.sqrt(
        alpha / (2 - alpha))
    u = torch.randn((3 * gen.WALK_BLOCK, 6), generator=g,
                    dtype=torch.float64) * alpha * 0.5
    out = []
    for t in range(T):
        x = (1 - alpha) * x + u[t]
        out.append(x.clone())
    ref = torch.stack(out).reshape(T, 2, 3)
    assert torch.allclose(w, ref, rtol=0, atol=1e-15)


def test_seed_decides_the_log():
    a = make("cassie", T=16, seed=2**33 + 1)
    b = make("cassie", T=16, seed=2**33 + 1)
    c = make("cassie", T=16, seed=2**33 + 2)
    for k in gen.KEYS:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["b_eq"], c["b_eq"])


@pytest.mark.chip
def test_full_log_on_the_card_in_seconds(card):
    make("cassie", T=16, device=card)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    log = make("cassie", T=65536, device=card)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    assert log["Q"].shape == (65536, 60, 60)
    assert seconds < 10.0, seconds


def test_the_walk_comes_from_the_seed():
    """A cold mix's log: the same seed gives the same QPs, another seed
    another walk of the same robot."""
    from qpbench import spec

    cell = spec.cell(os.path.dirname(HERE), "cassie-cold")
    Cold = spec.driver(cell.traffic["driver"])
    a = Cold(cell, torch.device("cpu"), 2**33 + 1).make_log(64)
    b = Cold(cell, torch.device("cpu"), 2**33 + 2).make_log(64)
    c = Cold(cell, torch.device("cpu"), 2**33 + 1).make_log(64)
    for k in gen.KEYS:
        assert torch.equal(a[k], c[k])
    assert not torch.equal(a["b_eq"], b["b_eq"])
    # the robot is the configuration's: the same sparsity in both walks
    assert torch.equal(a["A_eq"] == 0, b["A_eq"] == 0)
