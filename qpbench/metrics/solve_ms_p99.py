"""The 99th percentile of the host wall of `Solve` + `GetSolution` over
every step of the window, in ms. A controller misses its tick on this
tail; across runs it spreads too widely (15-23% between quartiles at
51 s) for an end-to-end bound, so it is read here, beside the median."""

import numpy as np


def read(rec: dict, name: str):
    w = rec.get("window") or {}
    s = w.get("call_s")
    return None if s is None or len(s) == 0 else float(
        np.percentile(s, 99) * 1e3)
