"""Share of the traced stretch in which no kernel, copy or set ran on
the device, in %: over the window less the profiler's own stalls
(`qpbench.trace`), so it reads the program and not the profiler."""


def read(rec: dict, name: str):
    tr = rec.get("trace")
    if not tr or tr.get("window_s", 0) <= 0 or tr.get("busy_s", 0) <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
