"""Host-side QP log helpers (port of the framework-free part of
`fcc_qp_tpu/utils/io.py`).

A QP log is a list of dicts with the reference npz schema, keys
``Q, b, A_eq, b_eq, friction_coeffs, lb, ub``. `stack_qp_dicts` stacks
one into a dict of ``(T, ...)`` f64 arrays, the contiguous host layout
that `core.ds_engine.to_ds_batch` moves to the device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

QP_KEYS = ("Q", "b", "A_eq", "b_eq", "friction_coeffs", "lb", "ub")


def stack_qp_dicts(qps: Sequence[dict]) -> dict:
    """Stack a list of schema dicts into one dict of (T, ...) arrays."""
    return {
        k: np.stack([np.asarray(qp[k], dtype=np.float64) for qp in qps])
        for k in QP_KEYS
    }
