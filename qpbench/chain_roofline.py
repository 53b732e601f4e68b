"""The least time one NVIDIA H100 could take for the PDAS polish's
Newton-Schulz chains, from the sites the program's stage clock records
inside its captures (`fcc_qp_tpu_torch.utils.timing.CaptureRecord`:
each chain site's mode, N2, chain count and path, and its visits).

Work, per chain on an N2 x N2 f32 KKT: 2 N2^3 flops a product, 80
products a seed chain (a cold seed, or a masked rebuild pass: 40
iterations of X <- X (2I - M X)) and 5 a refresh chain (one residual
product, then two guarded steps of two products each); bytes: M read
and X written once a chain (4 N2^2 each). Every chain of a visited
site counts (the site's chain count, the pass's batch or capacity),
whichever path ran it: the hand kernel (which skips a rebuild pass's
masked-off chains) or the batched cuBLAS products. Against the FP32
peak and HBM bandwidth of `qpbench.roofline`.
"""

from __future__ import annotations

from qpbench import roofline

# products of one chain, by the site's mode
PRODUCTS = {"seed": 80, "rebuild": 80, "refresh": 5}


def chain_sites(kind: str = "batch", warm: bool = False):
    """``(sites, replays)``: the polish's chain sites over every capture
    of ``kind`` and ``warm`` in the program's telemetry, each with its
    ``ns`` and ``visits`` summed over the captures' replays, and those
    replays; None where there is nothing to read (no card, no capture,
    or a program whose records keep no sub-stage sites)."""
    try:
        from fcc_qp_tpu_torch.utils.timing import telemetry
    except ImportError:
        return None
    caps = [c for c in telemetry()["captures"]
            if c["kind"] == kind and c["warm"] == warm]
    if not caps or any("sites" not in c for c in caps):
        return None
    sites = [s for c in caps for s in c["sites"]
             if s.get("name") == "polish_chain"]
    replays = sum(c["replays"] for c in caps)
    if not replays or not sum(s["visits"] for s in sites):
        return None
    return sites, replays


def chain_work(sites) -> list:
    """The f32 phase of the chains of ``sites`` (dicts with ``mode``,
    ``n2``, ``chains`` and ``visits``), as `roofline.least_seconds`
    takes it."""
    flops = nbytes = 0
    for s in sites:
        n2, chains = int(s["n2"]), int(s["chains"]) * int(s["visits"])
        flops += chains * PRODUCTS[s["mode"]] * 2 * n2 ** 3
        nbytes += chains * 2 * roofline.WORD["f32"] * n2 * n2
    return [dict(prec="f32", flops=flops, bytes=nbytes)]
