"""The comparison that decides ``correct``: the program's answers
against the plain reference (`qpbench.reference`), on the same QPs.

For a sample of the answers a run produced in its window (drawn from the
seed, with each call's hardest instance in it), the reference solves the
QP itself in f64 and the answer is read three ways, each as the worst
over the sample:

  eq_resid  max_i |A_eq z - b_eq|_i / (1 + max |b_eq|), the answer's
            equality residual, computed here in f64 from the data;
  z_gap     max |z - z*| / (1 + max |z*|), the distance to the
            reference's optimum z*;
  obj_gap   |f(z) - f(z*)| / (1 + |f(z*)|), the objective's gap.

Answers the program itself reports as not solved (any status but
kSuccess) are counted as failed by the run and are not read here; an
instance on which the reference does not reach its own tolerance is read
by ``eq_resid`` only, and a run whose reference leaves more than 1% of
its sample unsolved is not judged correct. Each limit sits between the
largest reading of sound runs and the smallest reading of the control
(the reference itself in f32), as `PERF.md` sets out with the readings.
"""

from __future__ import annotations

import torch

from qpbench import reference

# name -> limit: each between the largest reading of sound runs of the
# program and the smallest of the control, over every cell (PERF.md
# gives the readings)
LIMITS = {
    "eq_resid": 3e-8,
    "z_gap": 7e-4,
    "obj_gap": 1e-6,
}
# a run is judged only if the f64 reference itself solves at least this
# share of its sample (those it does not are read by eq_resid alone)
REFERENCE_SOLVED = 0.99
# rows per reference solve
BLOCK = 512


def _residuals(qp: dict, z: torch.Tensor):
    f64 = torch.float64
    A, beq = qp["A_eq"].to(f64), qp["b_eq"].to(f64)
    r = (A @ z.to(f64)[..., None])[..., 0] - beq
    return r.abs().amax(1) / (1.0 + beq.abs().amax(1))


def readings(qp: dict, z: torch.Tensor, ls: int, nc: int,
             dtype=torch.float64, candidate=None) -> dict:
    """The numbers compared for the answers ``z`` (B, n) to the QPs of
    the batch-leading dict ``qp``: the reference solves each QP in f64
    (in blocks of `BLOCK` rows). ``candidate``: a function ``qp ->
    answers`` put in the program's place (the control), else ``z`` is
    read. Returns the readings and the sample's counts."""
    B = qp["b"].shape[0]
    eq, zg, og, unsolved = [], [], [], 0
    for s in range(0, B, BLOCK):
        blk = {k: v[s:s + BLOCK] for k, v in qp.items()}
        ref = reference.solve(blk, ls, nc, torch.float64)
        zs = (candidate(blk) if candidate is not None
              else z[s:s + BLOCK]).to(torch.float64)
        eq.append(_residuals(blk, zs))
        ok = ref.converged
        unsolved += int((~ok).sum())
        zr = ref.z
        gap = (zs - zr).abs().amax(1) / (1.0 + zr.abs().amax(1))
        P = reference._Problem(blk, ls, nc, torch.float64)
        fz, fr = P.objective(zs), P.objective(zr)
        ogap = (fz - fr).abs() / (1.0 + fr.abs())
        zg.append(gap[ok])
        og.append(ogap[ok])
    worst = lambda parts: float(torch.cat(parts).max()) if sum(
        p.numel() for p in parts) else 0.0
    return dict(eq_resid=worst(eq), z_gap=worst(zg), obj_gap=worst(og),
                ref_unsolved=unsolved / max(B, 1), n_read=B)


def verdict(read: dict) -> tuple:
    """``(correct, compared)``: compared is ``{name: {"value", "limit"}}``
    for every limit; a reading that is not a number fails, and so does
    an empty sample or one the reference could not solve."""
    compared = {}
    ok = (read.get("n_read", 0) > 0
          and read["ref_unsolved"] <= 1.0 - REFERENCE_SOLVED)
    for name, limit in LIMITS.items():
        v = read[name]
        compared[name] = {"value": v, "limit": limit}
        ok = ok and v == v and v <= limit
    return ok, compared


def control_answers(ls: int, nc: int):
    """The control: the reference in f32 (the precision below the
    configuration's f64) put in the program's place."""
    return lambda qp: reference.solve(qp, ls, nc, torch.float32).z
