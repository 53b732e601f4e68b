"""The TALOS multi-contact robot (`models.osc.TALOS_MC`, the port's own)
and the stage clock's sub-stage stamps around the polish's chains, on
the CPU: the robot's sizes against its benchmark configuration, the
JAX package's table left as it is, a cold solve at the benchmark's
flags against the plain reference, the polish chains' path at N2 = 196,
the chain work the benchmark counts, and the sub-stage bookkeeping,
which stamps nothing outside a capture. The card's side is
`tests/test_torch_talos_chip.py`."""

import json
import os

import pytest
import torch

from fcc_qp_tpu_torch.models.osc import (MODELS, PORT_MODELS, TALOS_MC,
                                         generate_osc_sequence)
from fcc_qp_tpu_torch.ops import polish
from fcc_qp_tpu_torch.utils import timing

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config():
    with open(os.path.join(ROOT, "qpbench", "configs", "talos_mc.json")) as f:
        return json.load(f)


def test_talos_dims_and_its_configuration():
    s = TALOS_MC.shape
    assert PORT_MODELS["talos_mc"] is TALOS_MC
    assert (s.num_vars, s.num_eq, s.nc, s.lambda_c_start) == (118, 62, 48,
                                                              70)
    k = TALOS_MC.nu + TALOS_MC.nc
    assert k == 80 and s.num_vars + s.num_eq + s.nc // 3 == 196
    c = _config()
    assert (c["num_vars"], c["num_eq"], c["nc"], c["lambda_c_start"],
            c["constrained_k"]) == (118, 62, 48, 70, 80)
    for key in ("nv_dof", "nu", "nh", "nc", "nc_rows", "n_slack", "mu"):
        assert c["model"][key] == getattr(TALOS_MC, key), key
    assert c["solver"]["polish_newton_steps"] == TALOS_MC.polish_newton_steps
    assert c["reduced"] == []


def test_models_is_the_jax_packages_three():
    assert set(MODELS) == {"cassie", "quadruped", "humanoid"}
    assert "talos_mc" not in MODELS
    assert {n: PORT_MODELS[n] for n in MODELS} == MODELS


def test_talos_log_from_the_numpy_generator():
    """The NumPy original makes the robot's QPs at their sizes, with the
    actuators alone bounded."""
    qps = generate_osc_sequence(TALOS_MC, 4, seed=0)
    s = TALOS_MC.shape
    q = qps[0]
    assert q["Q"].shape == (118, 118) and q["A_eq"].shape == (62, 118)
    assert q["friction_coeffs"].shape == (16,)
    bounded = torch.isfinite(torch.from_numpy(q["ub"]))
    assert int(bounded.sum()) == TALOS_MC.nu
    assert bool(bounded[TALOS_MC.nv_dof:s.lambda_c_start].all())


def test_cold_solve_at_the_bench_flags_matches_the_reference():
    """8 steps of the benchmark's walking log, solved cold at the cell's
    options on the CPU (the kernels' plain versions): every kSuccess
    answer reads within `qpbench.check.LIMITS` of the plain reference."""
    from fcc_qp_tpu_torch import FCCQPOptions, solve_batched_ds
    from qpbench import check, gen
    from qpbench.drivers import batch_last

    c = _config()
    d = gen.dims(c["model"])
    log = gen.walking_log(c["model"], c["generator"], 400,
                          gen.generator(2**33 + 7, "cpu"), "cpu")
    qp = {k: v[::50].contiguous() for k, v in log.items()}
    with open(os.path.join(ROOT, "qpbench", "traffic",
                           "cold_8192.json")) as f:
        traffic = json.load(f)
    opts = FCCQPOptions(**{**traffic["options"], **c["solver"]})
    sol, _ = solve_batched_ds(batch_last(qp), TALOS_MC.shape, opts,
                              device="cpu")
    ok = sol.details.solve_status == 0
    assert int(ok.sum()) >= 6, sol.details.solve_status
    read = check.readings({k: v[ok] for k, v in qp.items()}, sol.z[ok],
                          d["ls"], d["nc"])
    correct, compared = check.verdict(read)
    assert correct, compared


@pytest.mark.parametrize("mode", ["seed", "refresh"])
def test_polish_chains_at_talos_n2_take_cublas(mode):
    for B in (1, 64, 128, 1024, 8192):
        assert not polish.ns_kernel_takes(B, 196, mode)
    assert polish.ns_kernel_takes(8192, polish.NS_KERNEL_MAX_N2, mode)


def test_chain_work_is_the_same_on_either_path():
    from qpbench import chain_roofline, roofline

    site = dict(name="polish_chain", mode="seed", n2=196, chains=8192,
                visits=1)
    kernel = chain_roofline.chain_work([dict(site, path="kernel")])
    cublas = chain_roofline.chain_work([dict(site, path="cublas")])
    assert kernel == cublas
    # by hand: 80 products of 2 N2^3 a seed chain, M and X once each
    assert kernel[0]["flops"] == 8192 * 80 * 2 * 196 ** 3
    assert kernel[0]["bytes"] == 8192 * 2 * 4 * 196 ** 2
    refresh = chain_roofline.chain_work([dict(site, mode="refresh",
                                              chains=1024, visits=3)])
    assert refresh[0]["flops"] == 3 * 1024 * 5 * 2 * 196 ** 3
    least = roofline.least_seconds(kernel)
    assert least["bound_by"] == "operations"
    assert least["seconds"] == pytest.approx(
        8192 * 80 * 2 * 196 ** 3 / 67e12)


def test_bench_takes_talos():
    from fcc_qp_tpu_torch import bench

    args = bench.parse_args(["--model", "talos_mc"])
    assert args.model == "talos_mc" and args.engine == "ds"
    assert args.splitting == "constrained"
    with pytest.raises(SystemExit):
        bench.parse_args(["--model", "talos"])


@pytest.fixture
def fresh(monkeypatch):
    monkeypatch.setattr(timing, "_RECORDS", [])
    return timing


def test_sub_stages_stamp_nothing_outside_a_capture(fresh, monkeypatch):
    stamped = []
    monkeypatch.setattr(timing.CaptureRecord, "queue_stamp",
                        lambda self, row, slot, graph: stamped.append(slot))
    clock = timing.StageClock()
    assert clock.begin("polish_chain", mode="seed") is None
    clock.end(None)
    rec = fresh.capture_record("batch", ("k",), False, "cpu")
    with fresh.stamping(rec, "iteration"):
        # the graph's opening stamp only: the CPU captures nothing
        tok = clock.begin("polish_chain", mode="seed", n2=4, chains=2,
                          path="cublas")
        clock.end(tok)
    assert tok is None and stamped == [-1] and rec.sites == []
    # the polish's chains on the CPU: the plain chain, nothing stamped
    Mb = torch.eye(6).expand(3, 6, 6).contiguous() * 2.0
    X = polish.polish_ns(Mb)
    assert torch.allclose(X, 0.5 * torch.eye(6).expand(3, 6, 6))
    assert stamped == [-1]
    # eager stage times hold no sub-stage entry
    times = {}
    eager = timing.StageClock(times, "cpu")
    assert eager.begin("polish_chain", mode="seed") is None
    assert "polish_chain" not in times


def test_sub_stage_sites_by_hand(fresh, monkeypatch):
    """`open_site` and the end stamp: the slots they queue, the sites the
    record keeps, the stamps they count, and the snapshot's sums, on a
    record made on the CPU with the stamp kernel left out."""
    queued = []
    monkeypatch.setattr(timing.CaptureRecord, "queue_stamp",
                        lambda self, row, slot, graph: (
                            queued.append((row is self.sub, slot)),
                            self.stamps.__setitem__(
                                graph, self.stamps.get(graph, 0) + 1)))
    rec = fresh.capture_record("batch", ("k",), False, "cpu")
    assert rec.sub.shape == (fresh.SUB_ROW,)
    clock = timing.StageClock()
    for i, mode in enumerate(("seed", "rebuild", "refresh")):
        slot = rec.open_site("iteration", "polish_chain",
                             dict(mode=mode, n2=196, chains=8 << i,
                                  path="cublas"))
        clock.end((rec, "iteration", slot))
        assert slot == i
    assert queued == [(True, -1), (True, 0), (True, -1), (True, 1),
                      (True, -1), (True, 2)]
    assert rec.stamps == dict(iteration=6)
    assert [s["mode"] for s in rec.sites] == ["seed", "rebuild", "refresh"]
    rec.sub[1:7] = torch.tensor([30_000_000, 2, 5_000_000, 4, 1_000_000, 2])
    rec.row[1 + 2 * fresh.STAGES.index("polish")] = 40_000_000
    rec.replays = 2
    snap = fresh.telemetry()["captures"][0]
    assert [(s["ns"], s["visits"], s["chains"]) for s in snap["sites"]] == [
        (30_000_000, 2, 8), (5_000_000, 4, 16), (1_000_000, 2, 32)]
    assert snap["stages"]["polish"]["ns"] == 40_000_000
    # the benchmark's readers of it: 36 ms over 2 replays
    from qpbench import chain_roofline, roofline, spec

    read = lambda n: spec.reader(n)({}, n)
    assert read("polish_chain_ms.cold") == pytest.approx(18.0)
    least = roofline.least_seconds(chain_roofline.chain_work(snap["sites"]))
    assert read("polish_chain_roofline.cold") == pytest.approx(
        100.0 * least["seconds"] / 0.036)
    # no warm pair and no B = 1 pair was recorded
    assert chain_roofline.chain_sites("batch", True) is None
    with pytest.raises(RuntimeError):
        rec.sites.extend([{}] * (fresh.SUB_SITES - len(rec.sites)))
        rec.open_site("iteration", "polish_chain", {})


def test_chain_readers_find_nothing_in_older_records(fresh, monkeypatch):
    """A program whose snapshot has no ``sites`` (the parent of the
    sub-stage stamps) gives both readers nothing to read."""
    from qpbench import spec

    rec = fresh.capture_record("batch", ("k",), False, "cpu")
    rec.replays = 3
    snap = fresh.telemetry()
    for c in snap["captures"]:
        del c["sites"]
    monkeypatch.setattr(timing, "telemetry", lambda device=None: snap)
    for name in ("polish_chain_ms.cold", "polish_chain_roofline.cold"):
        assert spec.reader(name)({}, name) is None
