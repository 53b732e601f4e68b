"""Walking-log replay with the reference's diagnostic plots, on the
PyTorch/CUDA port (`fcc_qp_tpu_torch`).

The port's twin of `examples/replay_walking.py`: it loads (or
synthesizes) a Cassie walking log with the reference npz schema,
replays it, and draws the reference's four diagnostic figures: solution
traces sliced as ``vdot = z[:, :22], u = z[:, 22:32], lambda_h =
z[:, 32:38], lambda_c = z[:, 38:]``, solve times, iteration counts, and
constraint violations.

Two replay modes:

* ``--mode loop``: a serial warm-started loop through the drop-in
  `FCCQP` class, one solve per timestep (the reference's semantics);
  reports the latency of each solve. On the card every `Solve` replays
  the captured f64 engine (the full-layout ADMM kernel).
* ``--mode batched`` (default): the whole log as one equilibrated,
  reduced-splitting batched solve (`solve_batched_ds` with polish off
  and no f32 approach phase, so the f64 ADMM kernel runs from the first
  iteration); reports amortized throughput from the second call
  (`utils.timing.timed`).

Runs on the card unless ``--device cpu`` is given, and raises when there
is no card. The plot goes to ``--out`` (default
``replay_plots_torch.png``).

Usage:
  python examples/replay_walking_torch.py [--steps 400] [--mode batched]
      [--npz test_data/id_qp_log_walking.npz] [--out replay_plots_torch.png]
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--mode", choices=["batched", "loop"], default="batched")
    p.add_argument("--npz", type=str, default=None,
                   help="reference-schema npz log (default: synthesize)")
    p.add_argument("--out", type=str, default="replay_plots_torch.png")
    p.add_argument("--rho", type=float, default=0.05)
    p.add_argument("--eps", type=float, default=1e-6)
    p.add_argument("--max-iter", type=int, default=3000)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p.parse_args(argv)


def load_log(args):
    """The log's first ``args.steps`` steps: ``args.npz`` where it exists,
    else a synthesized Cassie walking log."""
    from fcc_qp_tpu_torch.models.osc import CASSIE, generate_osc_sequence
    from fcc_qp_tpu_torch.utils.io import load_qp_log_npz

    if args.npz and os.path.exists(args.npz):
        qps = load_qp_log_npz(args.npz)[: args.steps]
        print(f"loaded {len(qps)} steps from {args.npz}")
    else:
        qps = generate_osc_sequence(CASSIE, args.steps, seed=0)
        print(f"synthesized {len(qps)} Cassie walking steps")
    return qps


def replay(argv=None) -> dict:
    """Replays the log as ``argv`` says. Returns numpy arrays: the
    solutions ``z`` (T, 60), the solve times ``times`` (s), ``iters``,
    ``status``, the cone and bound violations ``fviol`` / ``bviol``, the
    larger ADMM residual ``residual`` and the equality residual
    ``eq_viol`` of each step, and ``walls``: the host wall of each
    `Solve` (loop) or of the timed batched call (batched)."""
    args = parse_args(argv)
    from fcc_qp_tpu_torch import FCCQP, FCCQPOptions, solve_batched_ds
    from fcc_qp_tpu_torch import to_ds_batch
    from fcc_qp_tpu_torch.core.ds_engine import resolve_device
    from fcc_qp_tpu_torch.models.osc import CASSIE
    from fcc_qp_tpu_torch.utils.io import stack_qp_dicts
    from fcc_qp_tpu_torch.utils.timing import timed

    dev = resolve_device(args.device)
    qps = load_log(args)
    T = len(qps)
    shape = CASSIE.shape
    if args.mode == "loop":
        solver = FCCQP(shape.num_vars, shape.num_eq, shape.nc,
                       shape.lambda_c_start, device=dev)
        solver.set_options(FCCQPOptions(
            rho=0.3, eps_fcone=args.eps, eps_bound=args.eps,
            max_iter=args.max_iter,
        ))
        keys = ("Q", "b", "A_eq", "b_eq", "friction_coeffs", "lb", "ub")
        rows, walls = [], []
        for i, qp in enumerate(qps):
            solver.set_warm_start(i > 0)
            t0 = time.perf_counter()
            solver.Solve(*(qp[k] for k in keys))
            r = solver.GetSolution()
            walls.append(time.perf_counter() - t0)
            d = r.details
            rows.append((r.z, d.solve_time, d.n_iter, d.solve_status,
                         d.friction_cone_viol, d.bounds_viol,
                         max(d.admm_residual_bounds,
                             d.admm_residual_friction_cone),
                         d.equality_viol))
        z, times, iters, status, fviol, bviol, residual, eq_viol = (
            np.asarray(c) for c in zip(*rows))
        walls = np.asarray(walls)
    else:
        batch = to_ds_batch(stack_qp_dicts(qps), device=dev)
        opts = FCCQPOptions(
            max_iter=args.max_iter, rho=args.rho,
            eps_fcone=args.eps, eps_bound=args.eps,
            scaling=True, splitting="constrained", presolve="operator",
        )
        wall, (sol, _) = timed(solve_batched_ds, batch, shape, opts,
                               device=dev, reps=1)
        q = lambda t: t.cpu().numpy()
        d = sol.details
        z = q(sol.z).astype(np.float64)
        iters, status = q(d.n_iter), q(d.solve_status)
        fviol, bviol = q(d.friction_cone_viol), q(d.bounds_viol)
        residual = np.maximum(q(d.admm_residual_bounds),
                              q(d.admm_residual_friction_cone))
        eq_viol = q(d.equality_viol)
        times = np.full(T, wall / T)
        walls = np.asarray([wall])
        print(f"batched replay: {T / wall:.0f} solves/s "
              f"({wall / T * 1e6:.0f} us/solve amortized)")
    return dict(z=z, times=times, iters=iters, status=status, fviol=fviol,
                bviol=bviol, residual=residual, eq_viol=eq_viol, walls=walls)


def card_line() -> str:
    """The card's name and power limit, as `nvidia-smi` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    args = parse_args(argv)
    r = replay(argv)
    iters, fviol, bviol = r["iters"], r["fviol"], r["bviol"]
    print(f"iters: p50={np.median(iters):.0f} max={np.max(iters)}  "
          f"kSuccess {(r['status'] == 0).sum()}/{len(iters)}  "
          f"viol max: cone={np.max(fviol):.2e} bounds={np.max(bviol):.2e}")
    if args.mode == "loop":
        times, walls = r["times"], r["walls"]
        warm_t = times[1:] if len(times) > 1 else times
        warm_w = walls[1:] if len(walls) > 1 else walls
        where = (f"on {card_line()}" if args.device == "cuda"
                 else "on the CPU (plain versions of the kernels)")
        print(f"per-solve latency {where}: cold={times[0] * 1e3:.3f}ms "
              f"warm solve_time p50={np.median(warm_t) * 1e3:.3f}ms "
              f"min={np.min(warm_t) * 1e3:.3f}ms; wall per Solve p50="
              f"{np.median(warm_w) * 1e3:.3f}ms "
              f"p95={np.percentile(warm_w, 95) * 1e3:.3f}ms "
              "(the reference: ~0.1 ms per solve on the robot's CPU)")
    make_plots(r["z"], r["times"], iters, np.asarray(fviol),
               np.asarray(bviol), args.out)
    return 0


PANEL_W, PANEL_H, MARGIN = 640, 300, 40
COLORS = ((31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40),
          (148, 103, 189), (140, 86, 75), (227, 119, 194), (127, 127, 127),
          (188, 189, 34), (23, 190, 207))


def _panel(draw, x0, y0, title, series, log=False):
    """One panel at ``(x0, y0)``: ``series`` is a list of ``(y values,
    color)`` drawn over the timestep axis, on one y scale (log10 with
    ``log``), with its title and the y range."""
    ys = [np.log10(np.maximum(y, 1e-16)) if log else np.asarray(y, float)
          for y, _ in series]
    lo = min(float(y.min()) for y in ys)
    hi = max(float(y.max()) for y in ys)
    hi = hi if hi > lo else lo + 1.0
    w, h = PANEL_W - 2 * MARGIN, PANEL_H - 2 * MARGIN
    draw.rectangle((x0 + MARGIN, y0 + MARGIN, x0 + MARGIN + w,
                    y0 + MARGIN + h), outline=(0, 0, 0))
    rng = (f"1e{lo:.1f} .. 1e{hi:.1f}" if log else f"{lo:.3g} .. {hi:.3g}")
    draw.text((x0 + MARGIN, y0 + 8), f"{title}   [{rng}]", fill=(0, 0, 0))
    draw.text((x0 + MARGIN, y0 + MARGIN + h + 6), "timestep",
              fill=(0, 0, 0))
    for y, (_, color) in zip(ys, series):
        t = np.arange(len(y))
        px = x0 + MARGIN + t * w / max(len(y) - 1, 1)
        py = y0 + MARGIN + h - (y - lo) * h / (hi - lo)
        pts = list(zip(px.tolist(), py.tolist()))
        if len(pts) > 1:
            draw.line(pts, fill=color, width=1)
        else:
            draw.point(pts, fill=color)


def make_plots(z, times, iters, fviol, bviol, out):
    """The reference's diagnostic panels (solution slices, solve time and
    iterations, constraint violations), drawn with Pillow alone."""
    from PIL import Image, ImageDraw

    img = Image.new("RGB", (2 * PANEL_W, 3 * PANEL_H), "white")
    draw = ImageDraw.Draw(img)
    slices = {
        "vdot": z[:, :22],
        "u": z[:, 22:32],
        "lambda_h": z[:, 32:38],
        "lambda_c": z[:, 38:50],
    }
    for k, (name, zz) in enumerate(slices.items()):
        _panel(draw, (k % 2) * PANEL_W, (k // 2) * PANEL_H, name,
               [(zz[:, c], COLORS[c % len(COLORS)])
                for c in range(zz.shape[1])])
    # the iterations on the solve time's log axis, spanning its range
    it = np.asarray(iters, float)
    tl = np.log10(np.maximum(times * 1e6, 1e-16))
    scaled = 10 ** (tl.min() + (it - it.min()) * max(tl.max() - tl.min(), 1.0)
                    / max(it.max() - it.min(), 1.0))
    _panel(draw, 0, 2 * PANEL_H, f"solve time (us, log; blue), iterations "
           f"{int(it.min())}..{int(it.max())} (orange)",
           [(times * 1e6, COLORS[0]), (scaled, COLORS[1])], log=True)
    _panel(draw, PANEL_W, 2 * PANEL_H, "constraint violations (log): "
           "friction cone (blue), bounds (orange)",
           [(fviol, COLORS[0]), (bviol, COLORS[1])], log=True)
    img.save(out)
    print(f"wrote {out}")


if __name__ == "__main__":
    sys.exit(main())
