"""Host-side QP log and warm-start IO (port of `fcc_qp_tpu/utils/io.py`).

A QP log is a list of dicts with the reference npz schema, keys
``Q, b, A_eq, b_eq, friction_coeffs, lb, ub``. This module reads and
writes it in two formats the JAX package shares:

* the reference's npz (an object array of dicts, `save_qp_log_npz` /
  `load_qp_log_npz`);
* the packed ``.fqlog`` (`save_qp_log_packed` / `load_qp_log_packed`):
  magic ``FQLG``, a u32 version (1), a u32 header ``T, n, m, n_cones``,
  then the seven fields as contiguous little-endian f64 blocks in
  `QP_KEYS` order. A file written here is byte-identical to the JAX
  package's for the same log. (The JAX package's C++ reader is a speed
  path over the same bytes; the numpy reader below is the format's spec.)

`stack_qp_dicts` stacks a log into a dict of ``(T, ...)`` f64 arrays,
the contiguous host layout that `to_qpbatch` and
`core.ds_engine.to_ds_batch` move to the device. `save_warm_start` /
`load_warm_start` persist a warm state as npz, one array per field path,
in the JAX package's key scheme, so the JAX package's warm-start files
load here.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import numpy as np
import torch

QP_KEYS = ("Q", "b", "A_eq", "b_eq", "friction_coeffs", "lb", "ub")


def save_qp_log_npz(path: str, qps: Sequence[dict]) -> None:
    """Write the reference npz schema (an object array of dicts)."""
    arr = np.empty(len(qps), dtype=object)
    for i, qp in enumerate(qps):
        arr[i] = {k: np.asarray(qp[k], dtype=np.float64) for k in QP_KEYS}
    np.savez(path, qps=arr)


def load_qp_log_npz(path: str) -> list:
    """Read the reference npz schema: the list of QP dicts."""
    with np.load(path, allow_pickle=True) as data:
        return list(data["qps"])


def stack_qp_dicts(qps: Sequence[dict]) -> dict:
    """Stack a list of schema dicts into one dict of (T, ...) arrays."""
    return {
        k: np.stack([np.asarray(qp[k], dtype=np.float64) for qp in qps])
        for k in QP_KEYS
    }


def to_qpbatch(stacked: dict, dtype=torch.float64, device=None):
    """A stacked (T-leading) host dict as the port's batch-leading
    `types.QPBatch` in ``dtype`` (f64 or f32) on ``device`` (default
    CUDA; raises when there is no card)."""
    from fcc_qp_tpu_torch.core.ds_engine import resolve_device
    from fcc_qp_tpu_torch.types import QPBatch

    if dtype not in (torch.float64, torch.float32):
        raise TypeError(f"dtype must be float64 or float32, got {dtype}")
    dev = resolve_device(device)
    return QPBatch(*(
        torch.from_numpy(np.ascontiguousarray(stacked[k], np.float64))
        .to(dev, dtype) for k in QP_KEYS))


_MAGIC = b"FQLG"
_VERSION = 1


def save_qp_log_packed(path: str, qps) -> None:
    """Write a log (a list of QP dicts, or a dict already stacked by
    `stack_qp_dicts`) as a packed ``.fqlog`` file."""
    s = stack_qp_dicts(qps) if not isinstance(qps, dict) else qps
    T, n = s["b"].shape
    m = s["b_eq"].shape[1]
    n_cones = s["friction_coeffs"].shape[1]
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(np.array([_VERSION], dtype="<u4").tobytes())
        f.write(np.array([T, n, m, n_cones], dtype="<u4").tobytes())
        for k in QP_KEYS:
            f.write(np.ascontiguousarray(s[k], dtype="<f8").tobytes())


def load_qp_log_packed(path: str) -> dict:
    """Read a packed ``.fqlog`` file into a stacked dict of (T, ...) f64
    arrays. Raises `ValueError` on a bad magic, an unknown version or a
    file shorter than its header says."""
    with open(path, "rb") as f:
        if f.read(4) != _MAGIC:
            raise ValueError(f"{path}: not an fqlog file")
        head = f.read(4)
        version = int(np.frombuffer(head, "<u4")[0]) if len(head) == 4 else -1
        if version != _VERSION:
            raise ValueError(f"{path}: unsupported fqlog version {version}")
        dims = f.read(16)
        if len(dims) != 16:
            raise ValueError(f"{path}: truncated fqlog header")
        T, n, m, n_cones = (int(v) for v in np.frombuffer(dims, "<u4"))
        shapes = {
            "Q": (T, n, n), "b": (T, n), "A_eq": (T, m, n), "b_eq": (T, m),
            "friction_coeffs": (T, n_cones), "lb": (T, n), "ub": (T, n),
        }
        out = {}
        for k in QP_KEYS:
            cnt = int(np.prod(shapes[k]))
            raw = f.read(cnt * 8)
            if len(raw) != cnt * 8:
                raise ValueError(f"{path}: truncated fqlog data in {k}")
            out[k] = np.frombuffer(raw, "<f8").astype(np.float64).reshape(
                shapes[k])
        return out


def default_log_path(name: str = "walking", root: str | None = None) -> str:
    """Where the reference keeps its logs: ``test_data/id_qp_log_<name>.npz``
    under the repository root (or under ``root``)."""
    root = root or os.path.join(os.path.dirname(__file__), "..", "..",
                                "test_data")
    return os.path.abspath(os.path.join(root, f"id_qp_log_{name}.npz"))


# The warm-start files: npz with ``__kind__`` (the class name) and one
# array per field path. The JAX package's `WarmStartDS` stores each
# double-single field as ``<field>/hi`` and ``<field>/lo`` f32 words; this
# package's `WarmStartDS` and both packages' `WarmStart` store each field
# as it is (f64; rho f32).


def save_warm_start(path: str, warm) -> None:
    """Persist a `types.WarmStart` or a `core.ds_engine.WarmStartDS`
    (bit-exact: every field as its own dtype)."""
    fields = (warm._asdict() if hasattr(warm, "_asdict") else
              {f.name: getattr(warm, f.name)
               for f in dataclasses.fields(warm)})
    payload = {"__kind__": np.asarray(type(warm).__name__)}
    for k, v in fields.items():
        payload[k] = v.detach().cpu().numpy()
    np.savez(path, **payload)


def load_warm_start(path: str, device=None):
    """Load a warm state written by `save_warm_start` of either package
    onto ``device`` (default CUDA; raises when there is no card). A JAX
    package `WarmStartDS` loads as this package's, each hi/lo pair summed
    in f64 (as `core.ds_engine.warm_start_from_numpy` does)."""
    from fcc_qp_tpu_torch.core.ds_engine import WarmStartDS, resolve_device
    from fcc_qp_tpu_torch.types import WarmStart

    dev = resolve_device(device)
    with np.load(path) as f:
        kind = str(f["__kind__"])
        data = {k: f[k] for k in f.files if k != "__kind__"}

    def field(name):
        if f"{name}/hi" in data:
            a = (data[f"{name}/hi"].astype(np.float64)
                 + data[f"{name}/lo"].astype(np.float64))
        else:
            a = data[name]
        return torch.from_numpy(np.array(a, order="C")).to(dev)

    if kind == "WarmStartDS":
        return WarmStartDS(x=field("x"), mu_x=field("mu_x"),
                           mu_lambda_c=field("mu_lambda_c"),
                           rho=field("rho"))
    if kind == "WarmStart":
        return WarmStart(x=field("x"), mu_x=field("mu_x"),
                         mu_lambda_c=field("mu_lambda_c"))
    raise ValueError(f"{path}: unknown warm-start kind {kind!r}")
