"""Median over the window's steps of the host's share of a control
tick: the step's wall time (`Solve` + `GetSolution`) less its device
span (`details.solve_time`), in ms: validation, packing, the copies and
the launches."""

import numpy as np


def read(rec: dict, name: str):
    v = rec.get("host_ms")
    return None if v is None or len(v) == 0 else float(np.median(v))
