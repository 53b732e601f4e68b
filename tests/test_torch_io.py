"""Host IO of the port (`fcc_qp_tpu_torch.utils.io`) against the JAX
package's (`fcc_qp_tpu.utils.io`): the packed ``.fqlog`` log, the
reference npz log and the warm-start files. Every format round-trips bit
for bit, the port writes the JAX package's bytes, and files written by
either package load in the other. No JAX program is compiled."""

import numpy as np
import pytest
import torch

import fcc_qp_tpu.utils.io as jio
import fcc_qp_tpu_torch as T
from fcc_qp_tpu.core.ds_engine import WarmStartDS as JWarmStartDS
from fcc_qp_tpu.models.osc import CASSIE, generate_osc_sequence
from fcc_qp_tpu.ops.ds import DS
from fcc_qp_tpu.types import WarmStart as JWarmStart
from fcc_qp_tpu_torch.utils import io

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def log():
    return generate_osc_sequence(CASSIE, 5, seed=3)


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


def test_fqlog_round_trip_and_bytes(log, tmp_path):
    mine, theirs = tmp_path / "port.fqlog", tmp_path / "jax.fqlog"
    io.save_qp_log_packed(str(mine), log)
    jio.save_qp_log_packed(str(theirs), log)
    assert mine.read_bytes() == theirs.read_bytes()
    want = io.stack_qp_dicts(log)
    for got in (io.load_qp_log_packed(str(mine)),
                io.load_qp_log_packed(str(theirs)),
                jio._load_qp_log_packed_numpy(str(mine))):
        assert sorted(got) == sorted(io.QP_KEYS)
        for k in io.QP_KEYS:
            assert _bits_equal(got[k], want[k]), k
    # a stacked dict writes the same bytes as the list it came from
    stacked = tmp_path / "stacked.fqlog"
    io.save_qp_log_packed(str(stacked), want)
    assert stacked.read_bytes() == mine.read_bytes()


def test_npz_round_trip_both_ways(log, tmp_path):
    mine, theirs = tmp_path / "port.npz", tmp_path / "jax.npz"
    io.save_qp_log_npz(str(mine), log)
    jio.save_qp_log_npz(str(theirs), log)
    for got in (io.load_qp_log_npz(str(mine)), io.load_qp_log_npz(str(theirs)),
                jio.load_qp_log_npz(str(mine))):
        assert len(got) == len(log)
        for a, b in zip(got, log):
            for k in io.QP_KEYS:
                assert _bits_equal(a[k], np.asarray(b[k], np.float64)), k


@pytest.mark.parametrize("kind", ["WarmStart", "WarmStartDS"])
def test_warm_start_round_trip(kind, tmp_path):
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(rng.normal(size=s))
    if kind == "WarmStart":
        warm = T.WarmStart(x=t(4, 60), mu_x=t(4, 60), mu_lambda_c=t(4, 12))
    else:
        warm = T.WarmStartDS(x=t(60, 4), mu_x=t(60, 4), mu_lambda_c=t(12, 4),
                             rho=t(4).float())
    path = str(tmp_path / "w.npz")
    io.save_warm_start(path, warm)
    back = io.load_warm_start(path, device="cpu")
    assert type(back).__name__ == kind
    fields = warm._asdict() if kind == "WarmStartDS" else warm.__dict__
    for k, v in fields.items():
        got = getattr(back, k)
        assert got.dtype == v.dtype and torch.equal(got, v), k


def test_jax_warm_start_files_load(tmp_path):
    """Files the JAX package's `save_warm_start` writes, of each kind: a
    `WarmStart` loads as it is, a `WarmStartDS` with each hi/lo pair
    summed in f64; a port `WarmStart` file loads in the JAX package."""
    rng = np.random.default_rng(1)
    a = lambda *s: rng.normal(size=s)
    w = JWarmStart(x=a(3, 60), mu_x=a(3, 60), mu_lambda_c=a(3, 12))
    jio.save_warm_start(str(tmp_path / "w.npz"), w)
    got = io.load_warm_start(str(tmp_path / "w.npz"), device="cpu")
    assert isinstance(got, T.WarmStart)
    for k in ("x", "mu_x", "mu_lambda_c"):
        assert _bits_equal(getattr(got, k).numpy(), getattr(w, k))

    def ds(*s):
        hi = rng.normal(size=s).astype(np.float32)
        lo = (rng.normal(size=s) * 1e-9).astype(np.float32)
        return DS(hi, lo)

    wd = JWarmStartDS(x=ds(60, 3), mu_x=ds(60, 3), mu_lambda_c=ds(12, 3),
                      rho=np.full(3, 0.05, np.float32))
    jio.save_warm_start(str(tmp_path / "wd.npz"), wd)
    got = io.load_warm_start(str(tmp_path / "wd.npz"), device="cpu")
    assert isinstance(got, T.WarmStartDS)
    for k in ("x", "mu_x", "mu_lambda_c"):
        d = getattr(wd, k)
        want = d.hi.astype(np.float64) + d.lo.astype(np.float64)
        assert _bits_equal(getattr(got, k).numpy(), want)
    assert _bits_equal(got.rho.numpy(), wd.rho)

    tw = T.WarmStart(*(torch.from_numpy(getattr(w, k))
                       for k in ("x", "mu_x", "mu_lambda_c")))
    io.save_warm_start(str(tmp_path / "port.npz"), tw)
    back = jio.load_warm_start(str(tmp_path / "port.npz"))
    for k in ("x", "mu_x", "mu_lambda_c"):
        assert _bits_equal(np.asarray(getattr(back, k)), getattr(w, k))


@pytest.mark.parametrize("damage", ["magic", "version", "truncated",
                                    "header"])
def test_bad_fqlog_raises(log, tmp_path, damage):
    path = tmp_path / "a.fqlog"
    io.save_qp_log_packed(str(path), log)
    raw = bytearray(path.read_bytes())
    if damage == "magic":
        raw[:4] = b"XXXX"
    elif damage == "version":
        raw[4:8] = np.array([2], "<u4").tobytes()
    elif damage == "truncated":
        raw = raw[:-8]
    else:
        raw = raw[:12]
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError):
        io.load_qp_log_packed(str(path))


def test_to_qpbatch_dtype_and_device(log):
    st = io.stack_qp_dicts(log)
    for dtype in (torch.float64, torch.float32):
        qp = io.to_qpbatch(st, dtype=dtype, device="cpu")
        assert qp.Q.dtype == dtype and tuple(qp.Q.shape) == (5, 60, 60)
        assert torch.equal(qp.b, torch.from_numpy(st["b"]).to(dtype))
    with pytest.raises(TypeError):
        io.to_qpbatch(st, dtype=torch.float16, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            io.to_qpbatch(st)


def test_default_log_path():
    assert io.default_log_path("walking", "/data") == jio.default_log_path(
        "walking", "/data")
    assert io.default_log_path().endswith("test_data/id_qp_log_walking.npz")
