"""Settings of the benchmark's own tests (``python -m pytest qpbench``).

Tests that need the card carry the ``chip`` marker and take the
``card`` fixture, which skips them where there is no CUDA device; the
decision is made when the test runs, never when a module is imported.
The rest run on the CPU at tiny sizes: ``tiny_root`` is a copy of the
benchmark whose cells keep their configurations and options but run
tiny traffic (a few streams, steps and instances: each driver's
``tiny``).
"""

import json
import os
import shutil

import pytest
import torch

from qpbench import spec

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "`python -m pytest qpbench -m chip`")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_tiny_root(dest: str) -> str:
    """A copy of the repository's benchmark (BENCHMARK.json and
    qpbench/) under ``dest`` whose cells run tiny traffic."""
    shutil.copytree(HERE, os.path.join(dest, "qpbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    tdir = os.path.join(dest, "qpbench", "traffic")
    for w in bench["workloads"]:
        with open(os.path.join(tdir, w["traffic"] + ".json")) as f:
            t = json.load(f)
        # the sizes its driver gives for the CPU
        t.update(spec.driver(t["driver"]).tiny)
        name = "tiny_" + w["traffic"]
        with open(os.path.join(tdir, name + ".json"), "w") as f:
            json.dump(t, f)
        w["traffic"] = name
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(str(tmp_path))
