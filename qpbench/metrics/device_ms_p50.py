"""Median of the drop-in `Solve`'s own device span
(`details.solve_time`, CUDA events around the graph replays) over the
window's steps, in ms."""

import numpy as np


def read(rec: dict, name: str):
    v = rec.get("device_ms")
    return None if v is None or len(v) == 0 else float(np.median(v))
