#!/usr/bin/env python3
"""A captured B = 1 replay's device time, for the tree at ``<root>``:

    python3 exp_serve_replay_ab.py <root>

imports `fcc_qp_tpu_torch` from the checkout at ``<root>`` and measures
what `chip_smoke.py`'s serving phase reports as ``replay_device_ms``: an
`FCCQPServer` at depth 1 on each engine solves the 64-step walking log
at that phase's options (`chip_smoke.SERVE_DS_OPTS`, `SERVE_F64_OPTS`),
then its warm graphs are replayed 20 times back to back behind a spin
kernel (`chip_smoke.time_cuda`). Prints one JSON line per engine. Run
two trees alternately (parent, change, change, parent) in one call to
compare them on one card.
"""

from __future__ import annotations

import json
import sys


def main() -> int:
    import torch

    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print("usage: exp_serve_replay_ab.py <root>, on a CUDA card",
              file=sys.stderr)
        return 2
    root = sys.argv[1]
    sys.path.insert(0, root)
    import chip_smoke as cs
    import fcc_qp_tpu_torch
    from fcc_qp_tpu_torch import FCCQPOptions, FCCQPServer
    from fcc_qp_tpu_torch.models.osc import CASSIE, generate_osc_sequence
    from fcc_qp_tpu_torch.ops import pallas_admm

    pallas_admm.build_kernels()
    seq = generate_osc_sequence(CASSIE, cs.SERVE_STEPS, seed=1)
    opts = {"ds": FCCQPOptions(**cs.SERVE_DS_OPTS),
            "f64": FCCQPOptions(**cs.SERVE_F64_OPTS)}
    for engine in ("ds", "f64"):
        server = FCCQPServer(CASSIE.shape, opts[engine], depth=1,
                             engine=engine)
        for qp in seq:
            server.submit(*(qp[k] for k in cs.KEYS))
        server.drain()
        ms = [cs.time_cuda(lambda: server._solve.run(warm_start=True),
                           reps=20)[0] for _ in range(3)]
        print(json.dumps(dict(tree=root, package=fcc_qp_tpu_torch.__file__,
                              engine=engine, replay_device_ms=ms,
                              card=cs.smi_line())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
