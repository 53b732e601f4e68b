"""What a run reads, found by name: the cell in `BENCHMARK.json`, its
configuration (`qpbench/configs/<config>.json`), its traffic mix
(`qpbench/traffic/<traffic>.json`), the mix's driver
(`qpbench/drivers/<driver>.py`, the mix's ``"driver"``) and the readers
of its per-layer metrics (`qpbench/metrics/<metric>.py`, the metric's
name up to its first dot). A new cell, configuration, mix, driver or
metric is a new entry and new files; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: list   # the BENCHMARK.json entries this cell reports
    per_layer: list


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str) -> dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(root: str, workload: str, bench_dir: str = HERE) -> Cell:
    """The cell ``workload`` of the `BENCHMARK.json` at ``root``, with
    its configuration and traffic files from ``bench_dir``."""
    spec = benchmark(root)
    wl = [w for w in spec["workloads"] if w["name"] == workload]
    if not wl:
        raise KeyError(f"no workload named {workload!r} in BENCHMARK.json")
    w = wl[0]
    cfgs = [c for c in spec["configs"] if c["name"] == w["config"]]
    if not cfgs:
        raise KeyError(f"no configuration named {w['config']!r}")
    config = _load_json(os.path.join(root, cfgs[0]["file"]))
    traffic = _load_json(os.path.join(bench_dir, "traffic",
                                      w["traffic"] + ".json"))
    return Cell(
        name=workload, config=config, traffic=traffic,
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, workload)],
    )


def _module(bench_dir: str, folder: str, base: str):
    """The module ``<bench_dir>/<folder>/<base>.py``, loaded from its
    file (so that a copy of the benchmark elsewhere finds its own)."""
    path = os.path.join(bench_dir, folder, base + ".py")
    if not os.path.isfile(path):
        raise KeyError(f"no {folder}/{base}.py in {bench_dir}")
    mod_spec = importlib.util.spec_from_file_location(
        f"qpbench_{folder}_{base}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reader(metric: str, bench_dir: str = HERE):
    """The ``read(record, metric)`` function of the per-layer metric
    ``metric``, from ``metrics/<name up to the first dot>.py``."""
    return _module(bench_dir, "metrics", metric.split(".")[0]).read


def driver(name: str, bench_dir: str = HERE):
    """The driver class named ``name`` by a mix, from
    ``drivers/<name>.py`` (its ``DRIVER``)."""
    return _module(bench_dir, "drivers", name).DRIVER
