"""Whether the port's failures on a cold batch are the port's or the
algorithm's: the same QPs through the JAX package's `solve_batched_ds`
on the CPU, with the cell's options, against the port's statuses.

    # on the card: the first <n> QPs of one cold batch of a cell, the
    # port's answers and statuses, saved to an npz
    python3 exp_talos_failures.py save --workload talos-mc-cold \\
        --seed <s> --n 512 --out talos_cold_512.npz
    # on the CPU: the JAX package on those QPs, in blocks
    python3 exp_talos_failures.py jax --npz talos_cold_512.npz

``save`` imports no JAX; ``jax`` runs the JAX package on the CPU, with
the double-single flags its CPU tests set.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)


def _cell(workload):
    from qpbench import spec

    return spec.cell(ROOT, workload)


def _port_solve(qp: dict, cell, device):
    """The port's cold solve of the batch-leading dict ``qp``."""
    from fcc_qp_tpu_torch import solve_batched_ds
    from qpbench.drivers import batch_last, options, problem_shape

    sol, _ = solve_batched_ds(batch_last(qp), problem_shape(cell),
                              options(cell), device=device)
    return sol


def _jax_solve(qp: dict, cell, block: int):
    """The JAX package's cold solve of ``qp`` (NumPy, batch-leading) on
    the CPU, ``block`` QPs a call: (status, n_iter, polish_accepted, z)."""
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_cpu_max_isa=SSE4_2").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from fcc_qp_tpu import FCCQPOptions, ProblemShape
    from fcc_qp_tpu.core.ds_engine import solve_batched_ds, to_ds_batch
    from qpbench import gen

    d = gen.dims(cell.config["model"])
    shape = ProblemShape(num_vars=d["n"], num_eq=d["m"], nc=d["nc"],
                         lambda_c_start=d["ls"])
    opts = FCCQPOptions(**{**cell.traffic["options"],
                           **cell.config.get("solver", {})})
    B = qp["b"].shape[0]
    outs = []
    for s in range(0, B, block):
        t0 = time.perf_counter()
        sol, _ = solve_batched_ds(to_ds_batch({k: v[s:s + block]
                                               for k, v in qp.items()}),
                                  shape, opts, timing=False)
        det = sol.details
        outs.append((np.asarray(det.solve_status), np.asarray(det.n_iter),
                     np.asarray(det.polish_accepted), np.asarray(sol.z)))
        print(f"jax block {s}: {time.perf_counter() - t0:.1f} s, "
              f"{int((outs[-1][0] != 0).sum())} not kSuccess", flush=True)
    return tuple(np.concatenate([o[i] for o in outs]) for i in range(4))


def _report(name, status, n_iter, accepted):
    print(json.dumps(dict(
        who=name, n=int(status.size), failed=int((status != 0).sum()),
        failed_share=float((status != 0).mean()),
        n_iter_mean=float(n_iter.mean()),
        polish_accept=float(accepted.mean()),
        failed_rows=np.flatnonzero(status != 0).tolist())), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 exp_talos_failures.py")
    p.add_argument("what", choices=("save", "jax"))
    p.add_argument("--workload", default="talos-mc-cold")
    p.add_argument("--seed", type=int, default=2**33 + 7)
    p.add_argument("--n", type=int, default=512)
    p.add_argument("--block", type=int, default=64)
    p.add_argument("--npz", default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    torch.set_num_threads(1)
    from qpbench import gen

    if args.what == "jax":
        data = np.load(args.npz)
        qp = {k: data[k] for k in gen.KEYS}
        cell = _cell(str(data["workload"]))
        _report("port (card)", data["status"], data["n_iter"],
                data["polish_accepted"])
        st, it, acc, z = _jax_solve(qp, cell, args.block)
        _report("jax (cpu)", st, it, acc)
        both = (st != 0) & (data["status"] != 0)
        print(f"failed in both: {int(both.sum())}; port only: "
              f"{int(((data['status'] != 0) & (st == 0)).sum())}; jax only: "
              f"{int(((st != 0) & (data['status'] == 0)).sum())}")
        return 0
    # the cell's whole first batch, as its driver solves it
    cell = _cell(args.workload)
    dev = torch.device("cuda")
    log = gen.walking_log(cell.config["model"], cell.config["generator"],
                          int(cell.traffic["batch"]),
                          gen.generator(args.seed, dev), dev)
    _port_solve(log, cell, dev)   # the first call captures
    sol = _port_solve(log, cell, dev)
    det = sol.details
    n = args.n
    keep = {k: v[:n].cpu().numpy() for k, v in log.items()}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez_compressed(
        args.out, workload=args.workload, seed=args.seed, **keep,
        status=det.solve_status[:n].cpu().numpy(),
        n_iter=det.n_iter[:n].cpu().numpy(),
        polish_accepted=det.polish_accepted[:n].cpu().numpy(),
        z=sol.z[:n].cpu().numpy())
    st = det.solve_status.cpu().numpy()
    print(f"whole batch of {st.size}: {int((st != 0).sum())} not kSuccess "
          f"({(st != 0).mean():.6f}); saved the first {n}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
