"""The harness on the CPU: cells, configurations, mixes and metric
readers found by name; the last line's keys; no CPU fallback; the
import rules; `BENCHMARK.json` within the format's limits."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys
import time

import pytest

from qpbench import run, spec

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_cell_resolves_by_name():
    b = bench()
    for w in b["workloads"]:
        c = spec.cell(REPO, w["name"])
        # the mix's driver is a module found by its name
        drv = spec.driver(c.traffic["driver"])
        assert os.path.isfile(os.path.join(
            HERE, "drivers", c.traffic["driver"] + ".py"))
        assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
        assert len(c.end_to_end) >= 2 and c.per_layer
        for m in c.per_layer:
            assert callable(spec.reader(m["name"]))
        # every end-to-end metric the cell reports, its driver measures
        for m in c.end_to_end:
            assert m["name"] == "setup_s" or m["name"] in drv.e2e
    with pytest.raises(KeyError):
        spec.driver("no_such_driver")


def test_benchmark_json_keeps_to_its_format():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["qpbench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]] + [
        w["name"] for w in b["workloads"]] + [
        m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads"):
        ns = [x["name"] for x in b[group]]
        assert len(ns) == len(set(ns))
    ms = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(ms) == len(set(ms))
    used = {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith("qpbench/")
        assert os.path.exists(os.path.join(REPO, c["file"]))
        with open(os.path.join(REPO, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"] == []
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.exists(os.path.join(HERE, "traffic",
                                           w["traffic"] + ".json"))
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in cells
            assert "workloads" not in moved or w in moved["workloads"]
    for w in cells:
        reported = [m for m in b["end_to_end"]
                    if "workloads" not in m or w in m["workloads"]]
        assert len(reported) >= 2
        assert any(w in m["workloads"] for m in b["per_layer"])
    assert len(json.dumps(b)) < 64 * 1024


def _run(root, workload, trace, seconds=0.5):
    return run.run_cell(workload, 2**33 + 21, seconds, trace, "cpu",
                        time.time(), root=root,
                        bench_dir=os.path.join(root, "qpbench"))


def test_last_line_has_the_required_keys(tiny_root):
    out = _run(tiny_root, "cassie-cold", False)
    assert set(out) == LINE_KEYS
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"cold_solves_per_s", "setup_s"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert out["correct"] is True
    assert out["attempted"] >= 16 and out["failed"] == 0
    json.dumps(out)
    traced = _run(tiny_root, "cassie-cold", True)
    assert set(traced) == LINE_KEYS | {"breakdown"}
    assert {"busy_s", "window_s"} <= set(traced["device"])
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    # the CPU has no device trace: only the counters' metrics
    assert set(traced["metrics"]) == {"polish_accept_pct.cold",
                                      "endgame_iters_mean.cold"}


def test_new_files_add_a_cell_without_an_edit(tiny_root):
    """A new configuration, mix, driver and per-layer metric: only new
    files and new entries in BENCHMARK.json."""
    qdir = os.path.join(tiny_root, "qpbench")
    with open(os.path.join(qdir, "configs", "cassie.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "cassie_soft"
    cfg["generator"] = {**cfg["generator"], "smoothness": 0.01}
    with open(os.path.join(qdir, "configs", "cassie_soft.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(qdir, "traffic", "tiny_cold_8192.json")) as f:
        mix = json.load(f)
    mix["batch"] = 6
    mix["driver"] = "cold_again"
    with open(os.path.join(qdir, "traffic", "tiny_cold_6.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(qdir, "drivers", "cold_again.py"), "w") as f:
        f.write("from qpbench.drivers.cold import Cold\n\n\n"
                "class Again(Cold):\n    pass\n\n\n"
                "DRIVER = Again\n")
    with open(os.path.join(qdir, "metrics", "calls_in_window.py"), "w") as f:
        f.write("def read(rec, name):\n    return rec['window']['calls']\n")
    with open(os.path.join(tiny_root, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"].append({"name": "cassie_soft", "source": "x",
                         "file": "qpbench/configs/cassie_soft.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "soft-cold", "config": "cassie_soft",
                           "traffic": "tiny_cold_6", "chips": 1, "why": "x"})
    for m in b["end_to_end"]:
        if m["name"] == "cold_solves_per_s":
            m["workloads"].append("soft-cold")
    b["per_layer"].append({"name": "calls_in_window.cold", "unit": "calls",
                           "better": "higher", "source": "host_clock",
                           "layer": "x", "moves": "cold_solves_per_s",
                           "workloads": ["soft-cold"]})
    with open(os.path.join(tiny_root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    out = _run(tiny_root, "soft-cold", False)
    assert out["attempted"] % 6 == 0 and out["correct"]
    assert set(out["metrics"]) == {"cold_solves_per_s", "setup_s"}
    traced = _run(tiny_root, "soft-cold", True)
    assert traced["metrics"]["calls_in_window.cold"]["value"] >= 1


def test_no_card_no_result(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "cassie-cold", "--seed", "1",
                   "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_no_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and qpbench/."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "qpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-m", "qpbench.run", "--workload", "cassie-cold",
         "--seed", "1", "--seconds", "1"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout == ""


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    import types

    assert run.forbidden_modules() == [] or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "fcc_qp_tpu_torch_x", types.ModuleType(
        "fcc_qp_tpu_torch_x"))
    assert "fcc_qp_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "fcc_qp_tpu.core",
                        types.ModuleType("fcc_qp_tpu.core"))
    assert "fcc_qp_tpu" in run.forbidden_modules()


def _loaded_after(imports: str) -> set:
    code = (f"import sys\n{imports}\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return set(ast.literal_eval(res.stdout.strip().splitlines()[-1]))


def test_nothing_the_benchmark_runs_loads_jax():
    tops = _loaded_after(
        "from qpbench import run, drivers, check, gen, roofline, trace, "
        "spec, calibrate\nimport fcc_qp_tpu_torch\n"
        "from fcc_qp_tpu_torch.core import graphs, api, ds_engine\n"
        "for m in spec.benchmark(run.ROOT)['per_layer']:\n"
        "    spec.reader(m['name'])\n"
        "for w in spec.benchmark(run.ROOT)['workloads']:\n"
        "    c = spec.cell(run.ROOT, w['name'])\n"
        "    spec.driver(c.traffic['driver'])")
    assert not tops & set(run.FORBIDDEN)
    assert "fcc_qp_tpu_torch" in tops


def test_the_reference_imports_nothing_of_the_program():
    tops = _loaded_after("import qpbench.reference, qpbench.check")
    assert not tops & ({"fcc_qp_tpu_torch"} | set(run.FORBIDDEN))
    for path in ("reference/__init__.py", "check.py", "gen/__init__.py",
                 "roofline.py"):
        with open(os.path.join(HERE, path)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in (
                    {"fcc_qp_tpu_torch"} | set(run.FORBIDDEN)), (path, n)


class _Event:
    def __init__(self, name, dev, start, dur):
        self._n, self._d, self._s, self._u = name, dev, start, dur

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u


@pytest.mark.parametrize("marked", [False, True])
def test_trace_reduction_by_hand(marked):
    """The window from the host annotation (CPU) or from the two marker
    kernels (the card)."""
    from qpbench import trace

    window = ([_Event("spin_kernel(long)", True, 100, 1),
               _Event("spin_kernel(long)", True, 1099, 1)] if marked else
              [_Event(trace.WINDOW, False, 100, 1000),
               _Event(trace.WINDOW, True, 100, 1000)])
    ev = window + [
        # a step's host range, mirrored on the device
        _Event("replay_warm_step", False, 150, 800),
        _Event("replay_warm_step", True, 150, 800),
        _Event("cudaGraphLaunch", False, 160, 30),
        _Event("cudaStreamSynchronize", False, 700, 390),
        # kernels: one before the window (clipped), two overlapping
        _Event("void admm_chunk_warp<float, 1, false>(int)", True, 50, 100),
        _Event("gemm", True, 200, 300),
        _Event("void admm_chunk_warp<double, 1, false>(int)", True, 400,
               200),
        _Event("", True, 900, 50),
    ]
    r = trace.reduce_events(ev)
    assert r["window_s"] == pytest.approx(1000e-9)
    # union: [100, 150) + [200, 600) + [900, 950)
    assert r["busy_s"] == pytest.approx(500e-9)
    assert r["kernel_s"] == pytest.approx(250e-9)
    ops = dict(r["breakdown"]["device_ops"])
    assert ops == pytest.approx({"admm_chunk_warp<float, 1, false>": 50e-9,
                                 "gemm": 300e-9,
                                 "admm_chunk_warp<double, 1, false>": 200e-9,
                                 "(unnamed device record)": 50e-9},
                               rel=1e-9)
    gaps = dict(r["breakdown"]["idle_gaps"])
    # [150, 200) under the launch (inside the step's range); [600, 900)
    # and [950, 1100) under the synchronize
    assert gaps == pytest.approx({"cudaGraphLaunch": 50e-9,
                                  "cudaStreamSynchronize": 450e-9},
                                 rel=1e-9)


def test_a_lost_end_marker_is_named():
    """A stretch whose end marker the profiler lost has no window."""
    from qpbench import trace

    ev = [_Event("spin_kernel(long)", True, 0, 1),
          _Event("gemm", True, 100, 100)]
    with pytest.raises(trace.MarkersLost, match="1 of 2"):
        trace.reduce_events(ev)


@pytest.mark.parametrize("lost", [1, run.TRACE_TRIES])
def test_a_lost_marker_traces_the_stretch_again(tiny_root, monkeypatch,
                                                lost):
    """The run traces its stretch again while the profiler loses a
    marker, up to `run.TRACE_TRIES` stretches, and fails after that."""
    from qpbench import trace

    real = trace.Tracer.summary
    calls = []

    def summary(self, *a, **k):
        calls.append(1)
        if len(calls) <= lost:
            raise trace.MarkersLost("the traced window's markers are "
                                    "missing (1 of 2 recorded)")
        return real(self, *a, **k)

    monkeypatch.setattr(trace.Tracer, "summary", summary)
    if lost == run.TRACE_TRIES:
        with pytest.raises(trace.MarkersLost):
            _run(tiny_root, "cassie-cold", True)
        assert len(calls) == run.TRACE_TRIES
    else:
        out = _run(tiny_root, "cassie-cold", True)
        assert len(calls) == lost + 1
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_the_profilers_own_stalls_leave_the_window():
    """Idle time under the profiler's buffer flushes is the trace's cost:
    it leaves the idle time and the window, and no gap is named after
    it; the device's busy time is unchanged."""
    from qpbench import trace

    ev = [_Event("spin_kernel(long)", True, 0, 1),
          _Event("spin_kernel(long)", True, 999, 1),
          _Event("gemm", True, 100, 100),
          _Event("gemm", True, 700, 100),
          # the host stalled in a flush for [250, 600), the device idle
          _Event("Buffer Flush", False, 250, 350),
          # a request that overlaps device work counts only where idle
          _Event("Activity Buffer Request", False, 750, 100),
          _Event("cudaGraphLaunch", False, 600, 100),
          _Event("cudaGraphLaunch", False, 200, 50)]
    r = trace.reduce_events(ev)
    assert r["busy_s"] == pytest.approx(200e-9)
    # stalls with the device idle: [250, 600) and [800, 850)
    assert r["stall_s"] == pytest.approx(400e-9)
    assert r["window_s"] == pytest.approx(600e-9)
    gaps = dict(r["breakdown"]["idle_gaps"])
    assert not set(gaps) & trace.PROFILER_OWN
    # [0, 100) and [850, 1000) with no CUDA call, [200, 250) and
    # [600, 700) under the launches
    assert gaps == pytest.approx({"(host, no CUDA call)": 250e-9,
                                  "cudaGraphLaunch": 150e-9}, rel=1e-9)
    assert sum(gaps.values()) == pytest.approx(r["window_s"] - r["busy_s"])
