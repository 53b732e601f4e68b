"""The ADMM chunk kernels' share of their roofline in the traced
stretch: the least time the card could take for the iterations the
solves report (`qpbench.roofline`) over the profiler's device time of
every kernel whose name holds ``admm_chunk``, in %."""


def read(rec: dict, name: str):
    tr = rec.get("trace")
    if not tr or not tr.get("least") or tr.get("kernel_s", 0) <= 0:
        return None
    return 100.0 * tr["least"]["seconds"] / tr["kernel_s"]
