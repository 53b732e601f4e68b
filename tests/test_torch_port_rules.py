"""Rules of the port (`fcc_qp_tpu_torch`, `chip_smoke.py` and
`examples/replay_walking_torch.py`): it imports neither JAX nor the
JAX package, pins full-f32 matmuls, runs on the card unless asked for
the CPU, solves every option of the option set (those an earlier slice
rejected included), sends CPU tensors to the kernels' plain versions
without launching anything, and `chip_smoke.py` refuses to report
without a card."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import fcc_qp_tpu_torch as T
from fcc_qp_tpu_torch.models.osc import CASSIE, generate_osc_batch
from fcc_qp_tpu_torch.ops import pallas_admm as tk
from fcc_qp_tpu_torch.utils.io import stack_qp_dicts

# torch's CPU thread pool runs the port's small batched products many
# times slower at its default thread count than at one or two, and the
# suite's test workers share the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SUBPROCESS_SOLVE = """
import sys
import torch
import fcc_qp_tpu_torch as T
from fcc_qp_tpu_torch.models.osc import CASSIE, generate_osc_batch
from fcc_qp_tpu_torch.utils.io import stack_qp_dicts
torch.set_num_threads(1)
qp = T.to_ds_batch(stack_qp_dicts(generate_osc_batch(CASSIE, 4, seed=0)),
                   device="cpu")
opts = T.FCCQPOptions(max_iter=3000, rho=0.05, eps_fcone=1e-6,
                      eps_bound=1e-6, presolve="operator", scaling=True,
                      splitting="constrained", polish=True, polish_rounds=4)
sol, _ = T.solve_batched_ds(qp, CASSIE.shape, opts, device="cpu")
assert sol.z.shape == (4, 60)
import fcc_qp_tpu_torch.core.batched, fcc_qp_tpu_torch.core.serving
import fcc_qp_tpu_torch.bench
import fcc_qp_tpu_torch.parallel, fcc_qp_tpu_torch.parallel.scaling_bench
import fcc_qp_tpu_torch.utils.io
import importlib.util
spec = importlib.util.spec_from_file_location(
    "replay_walking_torch", "examples/replay_walking_torch.py")
example = importlib.util.module_from_spec(spec)
spec.loader.exec_module(example)
r = example.replay(["--steps", "2", "--mode", "loop", "--device", "cpu"])
assert r["z"].shape == (2, 60)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "fcc_qp_tpu.")))
print("LEAKED", bad)
"""


def test_package_imports_no_jax_and_solves_on_cpu():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", _SUBPROCESS_SOLVE], capture_output=True,
        text=True, env=env, cwd=ROOT, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LEAKED []" in out.stdout, out.stdout


def _port_sources():
    pkg = os.path.join(ROOT, "fcc_qp_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield os.path.join(ROOT, "examples", "replay_walking_torch.py")


def test_no_module_imports_jax_or_the_jax_package():
    """Every module of the port, and chip_smoke.py: no import of ``jax``
    or of ``fcc_qp_tpu`` (the port's own name starts alike)."""
    import ast

    for path in _port_sources():
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "fcc_qp_tpu"), (
                    f"{os.path.relpath(path, ROOT)} imports {name}")


def test_bench_entry_point_is_scanned_and_has_no_fallback():
    """The bench entry point is among the sources the import rule scans;
    no handler anywhere in it (nothing catches a kernel's failure to
    build or to launch, nothing retries on the CPU), and the card is its
    default device."""
    import ast

    from fcc_qp_tpu_torch import bench

    path = os.path.join(ROOT, "fcc_qp_tpu_torch", "bench.py")
    assert path in set(_port_sources())
    tree = ast.parse(open(path).read())
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
    assert bench.parse_args([]).device == "cuda"


def test_walking_example_is_scanned_and_has_no_fallback():
    """The walking-log example is among the sources the import rule
    scans (and the subprocess check runs it); it catches nothing, and the
    card is its default device."""
    import ast
    import importlib.util

    path = os.path.join(ROOT, "examples", "replay_walking_torch.py")
    assert path in set(_port_sources())
    tree = ast.parse(open(path).read())
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
    spec = importlib.util.spec_from_file_location("replay_walking_torch",
                                                  path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    assert example.parse_args([]).device == "cuda"
    assert example.parse_args([]).out != "replay_plots.png"


def test_tf32_pinned_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    stacked = stack_qp_dicts(generate_osc_batch(CASSIE, 2, seed=0))
    with pytest.raises(RuntimeError, match="CUDA"):
        T.to_ds_batch(stacked)
    qp = T.to_ds_batch(stacked, device="cpu")
    opts = T.FCCQPOptions(presolve="operator", scaling=True,
                          splitting="constrained")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.solve_batched_ds(qp, CASSIE.shape, opts)


def test_new_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.FCCQP(60, 38, 12, 38)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.FCCQP(60, 38, 12, 38, engine="ds")
    st = stack_qp_dicts(generate_osc_batch(CASSIE, 2, seed=0))
    qp = T.QPBatch(**{k: torch.from_numpy(v) for k, v in st.items()})
    one = T.QPBatch(**{k: torch.from_numpy(v[0]) for k, v in st.items()})
    for call in (lambda: T.solve_batched(qp, CASSIE.shape),
                 lambda: T.solve(one, CASSIE.shape),
                 lambda: T.replay(qp, CASSIE.shape),
                 lambda: T.warm_start_f64_from_numpy(
                     st["b"], st["b"], st["b"][:, :12])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # the full-splitting engine (the package defaults) too
    with pytest.raises(RuntimeError, match="CUDA"):
        T.solve_batched_ds(T.to_ds_batch(st, device="cpu"), CASSIE.shape)


def test_slice_six_entry_points_default_to_cuda(tmp_path):
    """The batch-level engine, the server, the sharded solves, the mesh
    and the IO loaders: CUDA unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    from fcc_qp_tpu_torch import parallel
    from fcc_qp_tpu_torch.utils import io

    st = stack_qp_dicts(generate_osc_batch(CASSIE, 2, seed=0))
    qp = T.QPBatch(**{k: torch.from_numpy(v) for k, v in st.items()})
    qds = T.to_ds_batch(st, device="cpu")
    w = T.WarmStart.zeros(CASSIE.shape, (2,))
    io.save_warm_start(str(tmp_path / "w.npz"), w)
    for call in (lambda: T.solve_batched_fast(qp, CASSIE.shape),
                 lambda: T.FCCQPServer(CASSIE.shape),
                 lambda: parallel.make_mesh(),
                 lambda: parallel.solve_batched_sharded(qp, CASSIE.shape),
                 lambda: parallel.solve_batched_ds_sharded(qds,
                                                           CASSIE.shape),
                 lambda: io.to_qpbatch(st),
                 lambda: io.load_warm_start(str(tmp_path / "w.npz"))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


BASE = dict(presolve="operator", scaling=True, splitting="constrained")


@pytest.mark.parametrize("kw", [dict(adaptive_rho=True), dict(alpha=1.5)])
def test_uncovered_options_raise(kw):
    """The options the port once rejected with `NotImplementedError`
    (adaptive rho on the reduced path, over-relaxation) no longer raise:
    they solve (their parity with the JAX package:
    tests/test_torch_options.py)."""
    qp = T.to_ds_batch(
        stack_qp_dicts(generate_osc_batch(CASSIE, 2, seed=0)), device="cpu"
    )
    sol, _ = T.solve_batched_ds(qp, CASSIE.shape,
                                T.FCCQPOptions(**{**BASE, **kw}), device="cpu")
    _solved(sol, 2)


def _solved(sol, B):
    z = sol.z.numpy()
    assert z.shape == (B, CASSIE.shape.num_vars) and np.isfinite(z).all()
    st = sol.details.solve_status.numpy()
    assert np.isin(st, (0, 1)).all()


@pytest.mark.parametrize("kw", [
    dict(kkt_factor="ds"), dict(splitting="full"), dict(presolve="exact"),
])
def test_formerly_uncovered_options_solve(kw):
    """The options an earlier slice rejected now solve on the CPU (their
    parity with the JAX package: tests/test_torch_full_engine.py)."""
    qp = T.to_ds_batch(
        stack_qp_dicts(generate_osc_batch(CASSIE, 2, seed=0)), device="cpu"
    )
    sol, _ = T.solve_batched_ds(qp, CASSIE.shape,
                                T.FCCQPOptions(**{**BASE, **kw}), device="cpu")
    _solved(sol, 2)


def test_replay_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    qp = T.to_ds_batch(
        stack_qp_dicts(generate_osc_batch(CASSIE, 4, seed=0)), device="cpu"
    )
    opts = T.FCCQPOptions(presolve="operator", scaling=True,
                          splitting="constrained")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.replay_ds_streams(qp, CASSIE.shape, opts, n_streams=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.replay_ds(qp, CASSIE.shape, opts)


@pytest.mark.parametrize("kw", [dict(adaptive_rho=True), dict(alpha=1.5)])
def test_replay_uncovered_options_raise(kw):
    """As `test_uncovered_options_raise`, through the replay: the options
    no longer raise, and every step solves."""
    qp = T.to_ds_batch(
        stack_qp_dicts(generate_osc_batch(CASSIE, 4, seed=0)), device="cpu"
    )
    sols, _ = T.replay_ds_streams(qp, CASSIE.shape,
                                  T.FCCQPOptions(**{**BASE, **kw}),
                                  n_streams=2, device="cpu")
    _solved(sols, 4)


@pytest.mark.parametrize("kw", [
    dict(kkt_factor="ds"), dict(splitting="full"), dict(presolve="exact"),
])
def test_replay_formerly_uncovered_options_solve(kw):
    qp = T.to_ds_batch(
        stack_qp_dicts(generate_osc_batch(CASSIE, 4, seed=0)), device="cpu"
    )
    sols, _ = T.replay_ds_streams(qp, CASSIE.shape,
                                  T.FCCQPOptions(**{**BASE, **kw}),
                                  n_streams=2, device="cpu")
    _solved(sols, 4)


def _chunk_inputs(dtype, B=8, k=7, kb=4, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    F = rng.normal(size=(k, k, 1)) * 0.1 + np.eye(k)[:, :, None]
    args = (
        t(np.repeat(F, B, axis=2)), t(rng.normal(size=(k, B))),
        t(-np.ones((kb, B))), t(np.ones((kb, B))),
        t(np.full(((k - kb) // 3, B), 0.8)), t(np.full(B, 0.05)),
        1e-2, 1e-2,
        t(rng.normal(size=(k, B))), t(rng.normal(size=(k, B))),
        t(rng.normal(size=(k, B)) * 0.1), t(np.zeros((k, B))),
        torch.zeros(B, dtype=torch.bool),
        torch.full((B,), 100, dtype=torch.int32),
        torch.zeros(B, dtype=torch.int32),
        *(t(np.zeros(B)) for _ in range(4)),
    )
    return args, dict(kb=kb, K=5, max_iter=100, weights=t(np.ones((k, B))))


@pytest.mark.parametrize("prec", ["f64", "f32", "full_f64", "full_f32"])
def test_cpu_tensors_take_plain_version(prec):
    dtype = torch.float32 if prec.endswith("f32") else torch.float64
    wrapper = getattr(tk, f"admm_chunk_{prec}")
    plain = getattr(tk, f"admm_chunk_{prec}_plain")
    args, kw = _chunk_inputs(dtype)
    if prec.startswith("full"):
        args, kw = _full_chunk_inputs(args, kw)
    tk.reset_launch_counts()
    got = wrapper(*args, **kw)
    want = plain(*args, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert all(fn.launches == 0 for fn in tk.KERNELS)
    itv = got[8] if prec.startswith("full") else got[6]
    assert int(itv.min()) == 5  # every instance ran the whole chunk


def _full_chunk_inputs(args, kw):
    """The same instances in the full layout: n = 7 rows, the cone triple
    at rows 2-4 between box rows, box and cone duals apart."""
    (F, xc, lb, ub, muf, rho, eb, ef, x, s, mu, v, done, n_iter, itv,
     *res) = args
    k, B = x.shape
    perm = torch.tensor([0, 1, 4, 5, 6, 2, 3])   # rows 2-4 hold the cone
    inf = torch.full((3, B), float("inf"), dtype=x.dtype)
    lb7 = torch.cat([lb[:2], -inf, lb[2:]])
    ub7 = torch.cat([ub[:2], inf, ub[2:]])
    full = (F[perm][:, perm].contiguous(), xc[perm].contiguous(), lb7, ub7,
            muf, rho, eb, ef, x[perm].contiguous(), s[perm].contiguous(),
            s[4:].contiguous(), mu[perm].contiguous(), mu[4:].contiguous(),
            v[perm].contiguous(), done, n_iter, itv, *res)
    return full, dict(ls=2, K=kw["K"], max_iter=kw["max_iter"],
                      gate=tk.GATE_SPLIT)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        capture_output=True, text=True, cwd=ROOT, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    # a directory holding chip_smoke.py and nothing else of the repo
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = subprocess.run(
        [sys.executable, str(tmp_path / "chip_smoke.py")],
        capture_output=True, text=True, cwd=tmp_path, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout

