"""Batched ADMM engines: the reduced-subspace path (the port's main
path) and the full-splitting engine with the reference's semantics.

Port of the reduced path of `fcc_qp_tpu/core/ds_engine.py`. The JAX
engine keeps its state in double-single f32 pairs because the TPU has no
f64 ALU; this engine keeps it in native f64 wherever the JAX engine
uses ds, and in f32 wherever the JAX engine is plain f32 (the
Newton-Schulz inverse seeds and the approach phase). Data and state are
batch-LAST (``(n, B)`` vectors, ``(n, m, B)`` matrices) so that the
one-warp-per-instance ADMM kernels read each row of the batch in one
coalesced load.

One cold solve (`solve_batched_ds`) runs, in order:
  1. Ruiz scaling (`ops.scaling`), factors bit-equal to the JAX engine's;
  2. the reduced KKT operator: f32 NS seed (+ f64 column refinement
     unless the exact build is deferred, `_lazy_exact`);
  3. the plain-f32 approach phase to a coarse tolerance, in chunks of
     the CUDA kernel `ops.pallas_admm.admm_chunk_f32`;
  4. PDAS active-set polish (`ops.polish`) with gathered retry rounds;
  5. the deferred exact operator for instances polish did not accept,
     and the f64 endgame in chunks of `ops.pallas_admm.admm_chunk_f64`;
  6. the final primal, violations and status.

The full-splitting engine (`_prepare_full`, `_iterate_full`) is the
reference algorithm over all n variables at the package defaults
(``splitting='full'``, no scaling, no polish): the f64-refined KKT
operator, the exact (or operator) presolve, then the ADMM loop in chunks
of the CUDA kernel `ops.pallas_admm.admm_chunk_full_f64`, with adaptive
rho refactoring the whole batch between chunks. `solve_batched_ds` takes
it whenever neither scaling, constrained splitting nor polish is on.

The JAX engine's `lax.while_loop` over chunks is a Python loop here.
The eager path (``static=False``) tests convergence between chunks on
the host (one read per chunk, and one per gathered pass). With
``static=True`` (the form `core.graphs` captures as CUDA graphs, at any
batch size; `reduced_stages`, `full_stages`) neither engine reads
anything back: each loop runs to the bound its shapes and options give
it (the chunk loops ``n_chunks`` passes, each gathered loop the
``ceil(B / C)`` passes that cover the batch at its capacity C), and
every chunk, polish round, rescue pass, adaptation, operator rebuild and
fallback the eager path may skip is a `ops.device_branch.branch` on its
device flag: an IF node of the graph under a capture, computed and
selected otherwise. The results are the eager ones bit for bit.
Both engines take over-relaxation (``alpha``, inside the kernels) and
adaptive rho (between chunks: the residual-balance rule, the scaled
duals rescaled to keep the unscaled ones, the operator rebuilt only when
some rho changed, the checks backing off exponentially).

Warm replay (`replay_ds_streams`) splits a log into parallel streams,
solves step 0 of every stream cold and each later step warm, carrying
an `OperatorCache` from step to step: the previous step's KKT seed is
refreshed instead of rebuilt, the Ruiz factors are reused, and the
polish starts from the carried seed and classification before any ADMM
iteration. `replay_ds` is the serial single-stream replay.

The kernels take at most 96 rows (n on the full engine, k on the
reduced path; `ops.pallas_admm.MAX_ROWS`): the reduced path covers every
model of `models/osc.py` (talos_mc's k = 80 on three row slots), the
full engine the JAX package's three but not talos_mc (n = 118). Larger
problems raise on the card.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from collections import OrderedDict
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from fcc_qp_tpu_torch.config import FCCQPOptions, ProblemShape
from fcc_qp_tpu_torch.ops.device_branch import branch, gathered_loop
from fcc_qp_tpu_torch.ops.ds_linalg import (
    assemble_kkt_ds,
    exact_capacity,
    gather_capacity,
    index_tensor,
    kkt_inverse_blocks_refined_ds,
    kkt_inverse_f32_refresh,
    kkt_inverse_f32_seed,
    kkt_solve_refined_ds,
    matvec_ds,
    pass_count,
    refine_inverse_columns_ds,
    solve_from_seed_ds,
    transpose_ds,
)
from fcc_qp_tpu_torch.ops.pallas_admm import (
    GATE_OFF,
    GATE_SPLIT,
    admm_chunk_f32,
    admm_chunk_f64,
    admm_chunk_full_f64,
)
from fcc_qp_tpu_torch.ops.polish import polish_reduced
from fcc_qp_tpu_torch.ops.projections import sqrt_rn
from fcc_qp_tpu_torch.ops.scaling import Scaling, apply_scaling, ruiz_scaling
from fcc_qp_tpu_torch.types import (
    FCCQPDetails,
    FCCQPSolution,
    FCCQPSolveStatus,
    QPBatch,
    WarmStart,
)
from fcc_qp_tpu_torch.utils.io import QP_KEYS
from fcc_qp_tpu_torch.utils.timing import (
    StageClock,
    span,
    stamp_solution_times,
    sync,
)
from fcc_qp_tpu_torch.utils.tree import pad_batch


class QPBatchDS(NamedTuple):
    """QP batch, f64, batch-last: Q (n,n,B), b (n,B), A_eq (m,n,B),
    b_eq (m,B), friction_coeffs (nc/3,B), lb/ub (n,B). (The name is the
    JAX engine's; the data is native f64, not double-single.)"""

    Q: torch.Tensor
    b: torch.Tensor
    A_eq: torch.Tensor
    b_eq: torch.Tensor
    friction_coeffs: torch.Tensor
    lb: torch.Tensor
    ub: torch.Tensor

    @property
    def batch(self) -> int:
        return self.b.shape[-1]


class WarmStartDS(NamedTuple):
    """ADMM state carried across solves, full-space and UNSCALED,
    batch-last f64; rho (B,) f32."""

    x: torch.Tensor
    mu_x: torch.Tensor
    mu_lambda_c: torch.Tensor
    rho: torch.Tensor


class OperatorCache(NamedTuple):
    """Carried f32 operator seeds of sequential (replay) solves: the
    port of `fcc_qp_tpu.core.ds_engine.OperatorCache`.

    A control-rate replay moves the QP data ~0.1% a step, so the seed
    builds (the Schur KKT inverse, `ops.ds_linalg.kkt_inverse_f32_seed`,
    and the polish KKT inverse, `ops.polish.polish_ns`) are
    replaced by a few guarded Newton-Schulz refresh steps against the
    new step's data. Every refreshed seed is residual-checked and falls
    back to the cold build per instance.

    Layouts differ from the JAX package's where its seeds are batch-last:
    ``kkt_seed`` is batch-LEADING here (`operator_cache_from_numpy`
    converts).
    """

    kkt_seed: Optional[torch.Tensor] = None     # (B, N, N) f32
    polish_seed: Optional[torch.Tensor] = None  # (B, N2, N2) f32
    # the packed classification (`ops.polish.pack_classification`) the
    # polish seed was last refreshed against: the next step's first
    # assembly uses it, so the carried seed and the KKT rows match
    polish_cls: Optional[torch.Tensor] = None   # (2*kb + 2*ncones, B) bool
    # carried Ruiz factors (`ops.scaling.Scaling`): an exact power-of-two
    # change of variables, so reusing them keeps the scaled KKT, and with
    # it every carried seed, from jumping when a recomputed factor would
    # cross a power of two
    scales: Optional[Scaling] = None


def field_dims(shape: ProblemShape):
    """The unbatched shape of each of the seven QP fields (Q, b, A_eq,
    b_eq, friction_coeffs, lb, ub)."""
    n, m, k = shape.num_vars, shape.num_eq, shape.n_cones
    return ((n, n), (n,), (m, n), (m,), (k,), (n,), (n,))


def zero_batch(shape: ProblemShape, B: int, device, dtype=torch.float64,
               batch_last: bool = True):
    """A batch of ``B`` zero QPs, the input buffers of a captured solve:
    a batch-last `QPBatchDS` (the ds engines), or a batch-leading
    `types.QPBatch` (the others)."""
    kw = dict(dtype=dtype, device=device)
    if batch_last:
        return QPBatchDS(*(torch.zeros((*d, B), **kw)
                           for d in field_dims(shape)))
    return QPBatch(*(torch.zeros((B, *d), **kw) for d in field_dims(shape)))


class Stages(NamedTuple):
    """An engine's read-free (static) solve of a batch in two stages: the
    form `core.graphs.CapturedBatch` captures as an operator graph and an
    iteration graph, and runs uncaptured on the CPU.

    * ``key``: the engine and its configuration (with the batch size and
      device, a capture's cache key);
    * ``inputs(B, device)``: zeroed input buffers for a batch of B, in the
      layout the stages read (a batch-last `QPBatchDS`, or a
      batch-leading `types.QPBatch` in the data's dtype);
    * ``prepare(qp, warm, cache, warm_start)``: the operator stage;
    * ``iterate(qp, prep, warm, cache, warm_start)``: the rest, returning
      ``(solution, warm)``, with ``cached`` ``(solution, warm,
      OperatorCache)``;
    * ``cached``: whether the solve threads an `OperatorCache` from solve
      to solve (the reduced path's replay).

    ``warm`` and ``cache`` are None on a cold solve (``cache`` also where
    the engine carries none)."""

    key: tuple
    inputs: Callable
    prepare: Callable
    iterate: Callable
    cached: bool = False


def reduced_stages(shape: ProblemShape, opts: FCCQPOptions, con_idx,
                   cached: bool = False) -> Stages:
    """The reduced path's stage pair for the classification ``con_idx``
    (`constrained_indices`): `_prepare_reduced` / `_iterate_reduced`, or
    the one refined KKT solve of a batch without a constrained
    coordinate. ``cached``: thread the `OperatorCache` (a replay)."""
    con_idx = tuple(int(i) for i in con_idx)
    none = OperatorCache()

    def prepare(qp, warm, cache, warm_start):
        if not con_idx:
            return _solve_reduced_k0(qp, shape, opts, static=True)
        cache = cache if cache is not None else none
        return _prepare_reduced(qp, warm, shape, opts, warm_start, con_idx,
                                kkt_seed=cache.kkt_seed, scales=cache.scales,
                                static=True)

    def iterate(qp, prep, warm, cache, warm_start):
        if not con_idx:
            return prep + (OperatorCache(),) if cached else prep
        cache = cache if cache is not None else none
        return _iterate_reduced(qp, prep, shape, opts, con_idx,
                                polish_seed=cache.polish_seed,
                                polish_cls=cache.polish_cls,
                                with_cache=cached, static=True)

    return Stages(("reduced", shape, opts, con_idx, cached),
                  lambda B, dev: zero_batch(shape, B, dev), prepare, iterate,
                  cached)


def full_stages(shape: ProblemShape, opts: FCCQPOptions) -> Stages:
    """The full-splitting engine's stage pair: `_prepare_full` /
    `_iterate_full`, static."""
    return Stages(
        ("full", shape, opts),
        lambda B, dev: zero_batch(shape, B, dev),
        lambda qp, warm, cache, warm_start: _prepare_full(
            qp, warm, shape, opts, warm_start, static=True),
        lambda qp, prep, warm, cache, warm_start: _iterate_full(
            qp, prep, shape, opts, static=True))


def pad_batch_last(tree, multiple: int):
    """Pad the TRAILING (batch) axis of every leaf of ``tree`` up to a
    multiple of ``multiple`` by repeating the last instance; returns
    ``(padded tree, original B)``. The batch-last form of
    `utils.tree.pad_batch`."""
    return pad_batch(tree, multiple, axis=-1)


def resolve_device(device=None) -> torch.device:
    """Entry points run on the card unless the caller asks for the CPU:
    ``None`` means CUDA, and CUDA without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def to_ds_batch(stacked: dict, device=None) -> QPBatchDS:
    """Host -> device: a stacked (B-leading) f64 dict with the reference
    npz schema becomes a batch-last f64 `QPBatchDS` on ``device``
    (default CUDA)."""
    dev = resolve_device(device)

    def conv(key):
        a = np.moveaxis(np.asarray(stacked[key], np.float64), 0, -1)
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return QPBatchDS(*(conv(k) for k in QP_KEYS))


def warm_start_from_numpy(x_hi, x_lo, mu_x_hi, mu_x_lo, mu_lc_hi, mu_lc_lo,
                          rho, device=None) -> WarmStartDS:
    """Convert the JAX package's `WarmStartDS` (its double-single words
    as batch-last numpy arrays) into this package's: each hi + lo pair
    is summed in f64; rho stays f32."""
    dev = resolve_device(device)

    def f64(hi, lo):
        a = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return WarmStartDS(
        x=f64(x_hi, x_lo),
        mu_x=f64(mu_x_hi, mu_x_lo),
        mu_lambda_c=f64(mu_lc_hi, mu_lc_lo),
        rho=torch.from_numpy(np.array(rho, np.float32)).to(dev),
    )


def warm_start_f64_from_numpy(x, mu_x, mu_lambda_c,
                              device=None) -> WarmStart:
    """Convert the JAX package's `WarmStart` of its f64 parity engine
    (``x``, ``mu_x``, ``mu_lambda_c`` as numpy arrays, any leading batch
    shape) into this package's `types.WarmStart` on ``device`` (default
    CUDA)."""
    dev = resolve_device(device)
    t = lambda a: torch.from_numpy(np.array(a, np.float64, order="C")).to(dev)
    return WarmStart(x=t(x), mu_x=t(mu_x), mu_lambda_c=t(mu_lambda_c))


def operator_cache_from_numpy(kkt_seed, polish_seed, polish_cls, d, e, c,
                              device=None) -> OperatorCache:
    """Convert the JAX package's `OperatorCache` (given as numpy arrays)
    into this package's: ``kkt_seed`` goes from batch-last (N, N, B) to
    batch-leading (B, N, N); ``polish_seed`` (B, N2, N2) and
    ``polish_cls`` are taken as they are; ``(d, e, c)`` become a
    `Scaling`. ``polish_seed`` / ``polish_cls`` may be None (a cache of a
    solve without polish)."""
    dev = resolve_device(device)

    def t(a, dtype):
        if a is None:
            return None
        return torch.from_numpy(np.array(a, dtype, order="C")).to(dev)

    return OperatorCache(
        kkt_seed=t(np.moveaxis(np.asarray(kkt_seed), -1, 0), np.float32),
        polish_seed=t(polish_seed, np.float32),
        polish_cls=t(polish_cls, np.bool_),
        scales=Scaling(d=t(d, np.float32), e=t(e, np.float32),
                       c=t(c, np.float32)),
    )


def _gather_qp(qp: QPBatchDS, idx) -> QPBatchDS:
    return QPBatchDS(*(a[..., idx] for a in qp))


def _put_last(full: torch.Tensor, idx, sub: torch.Tensor):
    """``full[..., idx] = sub`` along the batch axis, out of place."""
    out = full.clone()
    out[..., idx] = sub
    return out


def _scatter_last(full: torch.Tensor, idx, sub: torch.Tensor, sel):
    """``full[..., idx] = where(sel, sub, full[..., idx])``, out of place."""
    return _put_where(full.clone(), idx, sub, sel)


def _put_where(full: torch.Tensor, idx, sub: torch.Tensor, sel):
    """``full[..., idx] = where(sel, sub, full[..., idx])``, in place."""
    m = sel.reshape((1,) * (full.dim() - 1) + (-1,))
    full[..., idx] = torch.where(m, sub, full[..., idx])
    return full


# the constrained coordinates of the bounds last read, newest last:
# (id(lb), id(ub), shape) -> (weak references to lb and ub, their
# version counters at the read, the coordinates)
_BOUNDS_READ: "OrderedDict[tuple, tuple]" = OrderedDict()
MAX_BOUNDS_READ = 8


def constrained_indices(qp: QPBatchDS, shape: ProblemShape,
                        full: bool = False) -> tuple:
    """Coordinate ordering of the reduced splitting: coordinates with a
    finite bound in ANY instance first, the cone segment last (so the
    reduced cone segment is the contiguous tail). Free coordinates carry
    zero dual and identity projections, so leaving them out keeps the
    fixed point while shrinking the hot-loop operator to k x k.
    ``full=True`` keeps every coordinate (the reference's rho*I
    splitting, permuted so the cone segment is the tail).

    The bounds are read once per ``lb`` / ``ub`` pair (on the card, a copy
    that waits for the stream's queued work): a later call on the same
    two tensors, changed in place by no torch operation since (their
    version counters), reads nothing, so solves of one batch queue back
    to back (``timing=False``)."""
    nv, nc, ls = shape.num_vars, shape.nc, shape.lambda_c_start
    cone = tuple(range(ls, ls + nc))
    if full:
        return tuple(i for i in range(nv) if not ls <= i < ls + nc) + cone
    key = (id(qp.lb), id(qp.ub), shape)
    seen = _BOUNDS_READ.get(key)
    versions = (qp.lb._version, qp.ub._version)
    if (seen is not None and seen[0]() is qp.lb and seen[1]() is qp.ub
            and seen[2] == versions):
        _BOUNDS_READ.move_to_end(key)
        return seen[3]
    lb = qp.lb.cpu().numpy()
    ub = qp.ub.cpu().numpy()
    finite = np.isfinite(lb).any(axis=-1) | np.isfinite(ub).any(axis=-1)
    finite[ls:ls + nc] = False
    idx = tuple(int(i) for i in np.where(finite)[0]) + cone
    _BOUNDS_READ[key] = (weakref.ref(qp.lb), weakref.ref(qp.ub), versions,
                         idx)
    while len(_BOUNDS_READ) > MAX_BOUNDS_READ:
        _BOUNDS_READ.popitem(last=False)
    return idx


def _eq_residual_inf(qp: QPBatchDS, x: torch.Tensor) -> torch.Tensor:
    """``max_i |A_eq x - b_eq|`` per instance in unscaled units — the
    observable of a factorization failure."""
    if qp.A_eq.shape[0] == 0:
        return torch.zeros_like(qp.b[0])
    r = matvec_ds(transpose_ds(qp.A_eq), x) - qp.b_eq
    return r.abs().amax(dim=0)


def _status_checked(n_iter, max_iter: int, eq_viol, qp: QPBatchDS):
    """kMaxIterations at the iteration cap, else kSuccess; an
    equality-infeasible primal (relative inf-norm residual above 1e-3)
    reads kFactorizationFailed."""
    status = torch.where(
        n_iter == max_iter,
        int(FCCQPSolveStatus.kMaxIterations),
        int(FCCQPSolveStatus.kSuccess),
    ).to(torch.int32)
    if qp.A_eq.shape[0] == 0:
        return status
    thresh = 1e-3 * (1.0 + qp.b_eq.abs().amax(dim=0))
    return torch.where(
        eq_viol > thresh,
        torch.full_like(status, int(FCCQPSolveStatus.kFactorizationFailed)),
        status,
    )


def _reduced(opts: FCCQPOptions) -> bool:
    """Whether a solve takes the reduced path: Ruiz scaling, constrained
    splitting or polish; otherwise the full-splitting engine."""
    return opts.scaling or opts.splitting == "constrained" or opts.polish


def _alpha(opts: FCCQPOptions) -> float:
    """The over-relaxation as the JAX engine applies it: rounded to f32
    (exact in f64, and ``1 - alpha`` with it)."""
    return float(np.float32(opts.alpha))


def _rho_step(prim, dual, done, rho, opts: FCCQPOptions,
              dtype=torch.float32, static: bool = False):
    """The adaptive-rho rule, computed in ``dtype`` (rho's): f32 from the
    f32-rounded residual norms on both ds engines, as the JAX engine does;
    the data's dtype on the batch-level engine. Where an unfinished
    instance's primal and dual norms are out of balance by more than the
    tolerance, ``rho <- clip(rho * sqrt(prim / dual))``. Returns
    ``(new_rho, scale)`` with ``scale = rho_old / rho_new`` (1 where rho
    did not change; the scaled duals take it so that the unscaled ones
    stay), or None when no rho changed; ``static``: ``(new_rho, scale,
    changed)`` with ``changed`` the device flag that any rho changed."""
    tol = opts.adaptive_rho_tolerance
    prim, dual = prim.to(dtype), dual.to(dtype)
    safe = (prim > 1e-30) & (dual > 1e-30) & ~done
    ratio = sqrt_rn(prim / torch.clamp_min(dual, 1e-30))
    trigger = safe & ((ratio > tol) | (ratio < 1.0 / tol))
    new_rho = torch.where(
        trigger, torch.clamp(rho * ratio, opts.rho_min, opts.rho_max), rho)
    changed = new_rho != rho
    scale = torch.where(changed, rho / new_rho, torch.ones_like(rho))
    if static:
        return new_rho, scale, changed.any()
    if not bool(changed.any()):
        return None
    return new_rho, scale


class _PrepReduced(NamedTuple):
    """Factorization-phase outputs of the reduced engine."""

    qps: QPBatchDS       # scaled problem
    d: torch.Tensor      # (n, B) f32 variable scales
    e: torch.Tensor      # (m, B) f32 equality-row scales
    c: torch.Tensor      # (B,) f32 cost scale
    rho0: torch.Tensor   # (B,) f32
    mu0: torch.Tensor    # (k, B) initial scaled duals
    x_init: torch.Tensor  # (n, B) initial scaled primal
    Fcc: torch.Tensor    # (k, k, B) j-major hot-loop operator
    xc_const: torch.Tensor
    Fcolj: torch.Tensor  # (k, n, B) for the final full-x recovery
    x_const: torch.Tensor
    kkt_seed: torch.Tensor  # (B, N, N) f32 KKT inverse seed
    # (B,) the lazy f32-only operator did not contract (even after the
    # cold rescue): these instances get the exact build regardless
    seed_bad: Optional[torch.Tensor] = None
    # (B,) equality-constrained instances (no cones, every bound
    # infinite): their solution is the exact presolve
    eq_c: Optional[torch.Tensor] = None


def _scale_reduced(qp: QPBatchDS, shape: ProblemShape, opts: FCCQPOptions,
                   carried: Optional[Scaling] = None):
    """Ruiz-equilibrate the batch. Forced whenever splitting is
    'constrained' (removing rho from the free coordinates leaves the
    KKT (1,1) block near-singular on unequilibrated data). The factors
    come from the f32-rounded data, as the JAX engine computes them from
    its hi words. ``carried``: the factors of a previous replay step
    (`OperatorCache.scales`), reused instead of recomputed."""
    sc = carried if carried is not None else ruiz_scaling(
        qp.Q.float(), qp.A_eq.float(), qp.b.float(), shape,
        iters=opts.scaling_iters,
    )
    return apply_scaling(qp, sc, shape), sc


def _lazy_exact(opts: FCCQPOptions) -> bool:
    """Whether the exact operator build is deferred until after the
    polish: requires the hybrid factorization and an f32 approach phase
    ending in a polish — then only polish-rejected instances ever need
    the f64-refined operator."""
    coarse = max(opts.phase1_tol, opts.polish_tol if opts.polish else 0.0)
    return (
        opts.lazy_exact
        and opts.kkt_factor == "hybrid"
        and opts.polish
        and coarse > max(opts.eps_bound, opts.eps_fcone)
    )


def _rho_diag(rho: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return rho[None, :] * mask[:, None]


def _reduced_blocks(Fci: torch.Tensor, ci_t: torch.Tensor):
    """From batch-leading Fci (B, n, k) = F[:, ci]: Fcolj (k, n, B) with
    [j, i] = F[i, ci_j], and the j-major hot-loop operator Fcc (k, k, B)
    with [j, j'] = F[ci_j', ci_j]."""
    Fcolj = Fci.permute(2, 1, 0).contiguous()
    Fcc = Fci[:, ci_t, :].permute(2, 1, 0).contiguous()
    return Fcc, Fcolj


def _factor_reduced(qp: QPBatchDS, rho, ci, mask, refine_steps: int,
                    static: bool = False):
    """Partial-splitting operator from the f64 Schur-Cholesky route
    (`ops.ds_linalg.kkt_inverse_blocks_refined_ds`): the fallback for
    instances the hybrid seed cannot serve. Returns
    (Fcc, xc_const, Fcolj, x_const)."""
    ci_t = index_tensor(ci, qp.b.device)
    F, G = kkt_inverse_blocks_refined_ds(
        qp.Q, qp.A_eq, _rho_diag(rho, mask), refine_steps=refine_steps,
        static=static,
    )
    x_const = (
        matvec_ds(transpose_ds(G), qp.b_eq) - matvec_ds(transpose_ds(F), qp.b)
    )
    Fci = F[:, ci_t, :].permute(2, 0, 1)          # (B, n, k) = F[:, ci]
    Fcc, Fcolj = _reduced_blocks(Fci, ci_t)
    return Fcc, x_const[ci_t].contiguous(), Fcolj, x_const.contiguous()


def _factor_reduced_hybrid(qp: QPBatchDS, rho, ci, mask, passes: int,
                           kkt_seed: Optional[torch.Tensor] = None,
                           static: bool = False,
                           clock: Optional[StageClock] = None):
    """Hybrid operator: f32 Schur NS seed + f64 refinement of ONLY the
    needed inverse columns and the constant term. Instances whose seed
    did not contract, or whose refined constant-term solve misses 1e-5
    relative residual against the true KKT, are re-factored on the f64
    Schur-Cholesky route. ``kkt_seed``: a carried f32 inverse
    (`OperatorCache.kkt_seed`), refreshed instead of rebuilt.
    ``static``: the fallback is a branch on whether any instance needs it
    (`ops.device_branch.branch`), run on the whole batch and selected per
    instance, as the JAX engine's ``lax.cond(jnp.any(bad), ...)`` is (bit
    for bit the eager gather when one instance, or none, needs it).
    ``clock`` counts the instances the fallback serves (``n_fallback``)
    and the calls in which it runs (``n_fallback_calls``). Returns (Fcc,
    xc_const, Fcolj, x_const, X32)."""
    n = qp.Q.shape[0]
    dev = qp.b.device
    ci_t = index_tensor(ci, dev)
    rd = _rho_diag(rho, mask)
    M = assemble_kkt_ds(qp.Q, qp.A_eq, rd)
    if kkt_seed is None:
        X32, seed_res = kkt_inverse_f32_seed(qp.Q, qp.A_eq, rd)
    else:
        X32, seed_res = kkt_inverse_f32_refresh(kkt_seed, qp.Q, qp.A_eq, rd)
    C = refine_inverse_columns_ds(X32, M, ci, passes=passes)   # (B, N, k)
    Fcc, Fcolj = _reduced_blocks(C[:, :n, :], ci_t)
    r = torch.cat([-qp.b, qp.b_eq], dim=0)
    xfull = solve_from_seed_ds(X32, M, r, passes=passes)
    x_const = xfull[:n].contiguous()
    xc_const = x_const[ci_t].contiguous()

    rres = (M @ xfull.T[:, :, None])[:, :, 0].T - r
    rel = rres.abs().amax(dim=0) / (1.0 + r.abs().amax(dim=0))
    bad = (seed_res > 0.5) | (rel > 1e-5)
    if clock is not None:
        clock.count("n_fallback", bad)
        clock.count("n_fallback_calls", bad.any())
    if static:
        def fallback(*ops):
            ds_out = _factor_reduced(qp, rho, ci, mask, max(passes - 1, 1),
                                     static=True)
            return tuple(torch.where(bad, sub, full)
                         for full, sub in zip(ops, ds_out))

        Fcc, xc_const, Fcolj, x_const = branch(
            bad.any(), fallback, Fcc, xc_const, Fcolj, x_const)
    elif bool(bad.any()):
        idx = torch.nonzero(bad)[:, 0]
        sel = torch.ones_like(idx, dtype=torch.bool)
        ds_out = _factor_reduced(
            _gather_qp(qp, idx), rho[idx], ci, mask, max(passes - 1, 1)
        )
        Fcc, xc_const, Fcolj, x_const = (
            _scatter_last(full, idx, sub, sel)
            for full, sub in zip((Fcc, xc_const, Fcolj, x_const), ds_out)
        )
    return Fcc, xc_const, Fcolj, x_const, X32


def _factor_reduced_f32(qp: QPBatchDS, rho, ci, mask,
                        kkt_seed: Optional[torch.Tensor] = None,
                        clock: Optional[StageClock] = None,
                        static: bool = False):
    """f32-only reduced operator: the NS KKT inverse seed sliced to the
    hot-loop blocks, no refinement (accuracy ~1e-3 relative, enough for
    the coarse approach phase + polish). Returns
    (Fcc32, xc_const32, Fcolj32, x_const32, X32, bad) with ``bad`` the
    per-instance non-contraction flag of the seed.

    ``kkt_seed``: a carried f32 inverse (`OperatorCache.kkt_seed`),
    refreshed against this step's KKT. Instances whose refresh does not
    contract (the data jumped) get a cold seed build, GATHERED in passes
    of `ops.ds_linalg.gather_capacity` instances and looping until every
    one is rebuilt (``static``: the loop's bound of ``ceil(B / C)``
    passes, each a branch on whether any is left); those still flagged
    after that are ``bad``. ``clock`` counts the rescued instances
    (``n_kkt_rescue``)."""
    n = qp.Q.shape[0]
    ci_t = index_tensor(ci, qp.b.device)
    rd = _rho_diag(rho, mask)
    if kkt_seed is None:
        X32, seed_res = kkt_inverse_f32_seed(qp.Q, qp.A_eq, rd)
    else:
        X32, seed_res = kkt_inverse_f32_refresh(kkt_seed, qp.Q, qp.A_eq, rd)
        rem = seed_res > 0.5
        if clock is not None:
            clock.count("n_kkt_rescue", rem)
        B = qp.batch
        C = gather_capacity(B)

        def rescue(X32, seed_res, rem):
            # in place: a pass with nothing pending rewrites what it read
            idx = torch.argsort(-rem.float(), stable=True)[:C]
            sel = rem[idx]
            Xc, rc = kkt_inverse_f32_seed(qp.Q[..., idx], qp.A_eq[..., idx],
                                          rd[:, idx])
            X32[idx] = torch.where(sel[:, None, None], Xc, X32[idx])
            seed_res[idx] = torch.where(sel, rc, seed_res[idx])
            rem.index_fill_(0, idx, False)
            return X32, seed_res, rem

        X32, seed_res, rem = gathered_loop(
            static, pass_count(B, C), lambda *c: c[-1], rescue,
            X32, seed_res, rem)
    r = torch.cat([-qp.b.float(), qp.b_eq.float()], dim=0)
    xfull = (X32 @ r.T[:, :, None])[:, :, 0].T
    Fcc, Fcolj = _reduced_blocks(X32[:, :n, ci_t], ci_t)
    x_const = xfull[:n].contiguous()
    return (Fcc, x_const[ci_t].contiguous(), Fcolj, x_const, X32,
            seed_res > 0.5)


def _prepare_reduced(qp, warm, shape, opts, warm_start, con_idx,
                     clock: Optional[StageClock] = None,
                     kkt_seed: Optional[torch.Tensor] = None,
                     scales: Optional[Scaling] = None,
                     static: bool = False):
    """Stage 1 (the "factorization" phase): equilibration, initial state
    (warm: unscaled full-space state -> scaled reduced coordinates;
    cold: the exact or the operator presolve), and the reduced KKT
    operator (hybrid, or the f64 Schur route with ``kkt_factor='ds'``).
    Requires ``len(con_idx) > 0`` (`_solve_reduced_k0` takes k = 0).
    ``kkt_seed`` / ``scales``: carried from a previous replay step
    (`OperatorCache`). ``static``: read-free (the module docstring)."""
    nv, nc, ls = shape.num_vars, shape.nc, shape.lambda_c_start
    B = qp.batch
    dev = qp.b.device
    ci = np.asarray(con_idx, dtype=np.int64)
    ci_t = index_tensor(ci, dev)
    k = len(con_idx)
    kb = k - nc

    clock = clock or StageClock()
    qps, sc = _scale_reduced(qp, shape, opts, carried=scales)
    clock.mark("scaling")
    d = sc.d
    inv_d = (1.0 / d).double()
    mask = torch.zeros((nv,), dtype=torch.float32, device=dev)
    mask.index_fill_(0, ci_t, 1.0)

    x_init = None
    if warm_start:
        if warm is None:
            raise ValueError("warm_start=True needs a warm state")
        rho0 = warm.rho.float()
        x_init = warm.x * inv_d
        mu_box = warm.mu_x[ci_t[:kb]] * inv_d[ci_t[:kb]]
        mu_cone = warm.mu_lambda_c * inv_d[ls:ls + nc]
        mu0 = torch.cat([mu_box, mu_cone], dim=0)
    else:
        rho0 = torch.full((B,), opts.rho, dtype=torch.float32, device=dev)
        mu0 = torch.zeros((k, B), dtype=torch.float64, device=dev)
        if opts.presolve == "exact":
            x_init = kkt_solve_refined_ds(qps.Q, qps.A_eq, -qps.b, qps.b_eq,
                                          static=static)

    seed_bad, X32 = None, None
    if _lazy_exact(opts):
        # f32-only operator: the approach phase and the self-solving
        # polish never need more; the exact build is deferred to just
        # before the endgame (`_iterate_reduced`)
        Fcc, xc_const, Fcolj, x_const, X32, seed_bad = _factor_reduced_f32(
            qps, rho0, ci, mask, kkt_seed=kkt_seed, clock=clock,
            static=static,
        )
        Fcc, xc_const = Fcc.double(), xc_const.double()
        Fcolj, x_const = Fcolj.double(), x_const.double()
    elif opts.kkt_factor == "hybrid":
        Fcc, xc_const, Fcolj, x_const, X32 = _factor_reduced_hybrid(
            qps, rho0, ci, mask, opts.kkt_refine_steps + 1, kkt_seed=kkt_seed,
            static=static, clock=clock,
        )
    else:
        Fcc, xc_const, Fcolj, x_const = _factor_reduced(
            qps, rho0, ci, mask, opts.kkt_refine_steps, static=static
        )
    if x_init is None:
        x_init = x_const
    clock.mark("operator")
    return _PrepReduced(
        qps=qps, d=d, e=sc.e, c=sc.c, rho0=rho0, mu0=mu0,
        x_init=x_init, Fcc=Fcc, xc_const=xc_const, Fcolj=Fcolj,
        x_const=x_const, kkt_seed=X32, seed_bad=seed_bad,
        eq_c=_equality_only(qp, nc),
    )


def _equality_only(qp: QPBatchDS, nc: int) -> torch.Tensor:
    """(B,) instances without cones whose bounds are all infinite: the
    equality-constrained QP, solved by the presolve alone."""
    if nc:
        return torch.zeros((qp.batch,), dtype=torch.bool, device=qp.b.device)
    return torch.isinf(qp.lb).all(dim=0) & torch.isinf(qp.ub).all(dim=0)


def _solve_reduced_k0(qp: QPBatchDS, shape: ProblemShape,
                      opts: FCCQPOptions, static: bool = False):
    """Pure-equality batch (no constrained coordinate at all): one refined
    KKT solve on the equilibrated data is the whole solve."""
    nv = shape.num_vars
    B = qp.batch
    dev = qp.b.device
    qps, sc = _scale_reduced(qp, shape, opts)
    x = kkt_solve_refined_ds(qps.Q, qps.A_eq, -qps.b, qps.b_eq,
                             static=static) * sc.d.double()
    eq_viol = _eq_residual_inf(qp, x)
    zi = torch.zeros((B,), dtype=torch.int32, device=dev)
    zb = torch.zeros((B,), dtype=torch.float64, device=dev)
    details = FCCQPDetails(
        n_iter=zi, admm_residual_bounds=zb, admm_residual_friction_cone=zb,
        solve_time=zb, factorization_time=zb, bounds_viol=zb,
        friction_cone_viol=zb,
        solve_status=_status_checked(zi, opts.max_iter, eq_viol, qp),
        equality_viol=eq_viol, n_iter_f32=zi, n_iter_ds=zi,
        polish_attempts=zi, polish_accepted=zi,
    )
    new_warm = WarmStartDS(
        x=x, mu_x=torch.zeros((nv, B), dtype=torch.float64, device=dev),
        mu_lambda_c=torch.zeros((0, B), dtype=torch.float64, device=dev),
        rho=torch.full((B,), opts.rho, dtype=torch.float32, device=dev),
    )
    return FCCQPSolution(details=details, z=x.T.contiguous()), new_warm


@dataclasses.dataclass
class _RState:
    # the three counters are 0-d int32 device tensors on a static solve
    it: int                  # global iteration counter (chunks * K)
    next_adapt: int          # the next `it` at which rho may adapt
    n_refactor: int          # operator rebuilds after a rho change
    xc: torch.Tensor         # (k, B) primal, constrained coords
    s: torch.Tensor          # (k, B) slack (box part + cone tail)
    mu: torch.Tensor         # (k, B) scaled duals
    v: torch.Tensor          # (k, B) the s - mu that produced xc
    rho: torch.Tensor        # (B,) f32
    Fcc: torch.Tensor
    xc_const: torch.Tensor
    Fcolj: torch.Tensor
    x_const: torch.Tensor
    x_res_norm: torch.Tensor  # (B,) f64
    lam_res_norm: torch.Tensor
    prim_norm: torch.Tensor
    dual_norm: torch.Tensor
    n_iter: torch.Tensor      # (B,) int32
    itv: torch.Tensor         # (B,) int32 per-instance iteration counter
    done: torch.Tensor        # (B,) bool


class _Polish(NamedTuple):
    x: torch.Tensor
    accept: torch.Tensor
    seed: torch.Tensor
    cls: torch.Tensor


def _iterate_reduced(qp, prep: _PrepReduced, shape, opts, con_idx,
                     clock: Optional[StageClock] = None,
                     polish_seed: Optional[torch.Tensor] = None,
                     polish_cls: Optional[torch.Tensor] = None,
                     with_cache: bool = False, static: bool = False):
    """Stage 2: approach phase, polish, deferred exact operator, f64
    endgame and the final primal / details / warm state.

    ``polish_seed`` / ``polish_cls``: carried from a previous replay
    step (`OperatorCache`); the polish then makes its first attempt on
    the full batch straight from the warm state, and only the instances
    it rejects run the approach phase and the gathered retries. With
    ``with_cache`` returns ``(sol, warm, OperatorCache)``, else
    ``(sol, warm)``. ``static``: read-free (the module docstring)."""
    nv, nc, ls = shape.num_vars, shape.nc, shape.lambda_c_start
    B = qp.batch
    dev = qp.b.device
    f64 = torch.float64
    clock = clock or StageClock()
    ci = np.asarray(con_idx, dtype=np.int64)
    ci_t = index_tensor(ci, dev)
    k = len(con_idx)
    kb = k - nc
    mask = torch.zeros((nv,), dtype=torch.float32, device=dev)
    mask.index_fill_(0, ci_t, 1.0)
    # the JAX engine compares its residuals against f32 tolerances
    eps_b = float(np.float32(opts.eps_bound))
    eps_f = float(np.float32(opts.eps_fcone))
    max_iter = opts.max_iter
    inc_gate = opts.presolve == "operator"
    alpha = _alpha(opts)

    qps = prep.qps
    d = prep.d
    wk = d[ci_t].contiguous()            # (k, B) f32 residual weights
    wk64 = wk.double()
    lbc = qps.lb[ci_t[:kb]].contiguous()
    ubc = qps.ub[ci_t[:kb]].contiguous()
    mu_eff = qps.friction_coeffs.contiguous()
    lbc32, ubc32, mu_eff32 = lbc.float(), ubc.float(), mu_eff.float()

    # chunks of the adaptation interval when rho adapts (it adapts between
    # chunks), else of 64 iterations
    K = opts.adaptive_rho_interval if opts.adaptive_rho else min(max_iter, 64)
    n_chunks = -(-max_iter // K)

    xc0 = prep.x_init[ci_t].contiguous()
    zeros_b = torch.zeros((B,), dtype=f64, device=dev)
    count = ((lambda v: torch.full((), v, dtype=torch.int32, device=dev))
             if static else (lambda v: v))
    st = _RState(
        it=count(0), next_adapt=count(K), n_refactor=count(0), xc=xc0,
        s=xc0, mu=prep.mu0.contiguous(), v=xc0 - prep.mu0,
        rho=prep.rho0, Fcc=prep.Fcc, xc_const=prep.xc_const,
        Fcolj=prep.Fcolj, x_const=prep.x_const,
        x_res_norm=zeros_b, lam_res_norm=zeros_b, prim_norm=zeros_b,
        dual_norm=zeros_b,
        n_iter=torch.full((B,), max_iter, dtype=torch.int32, device=dev),
        itv=torch.zeros((B,), dtype=torch.int32, device=dev),
        done=torch.zeros((B,), dtype=torch.bool, device=dev),
    )

    def settled(st):
        return bool((st.done | (st.itv >= max_iter)).all())

    def guarded(go, step, st, *carry):
        """``step(st, *carry)``, which updates ``st`` and returns the new
        ``carry``, where the batch-wide flag ``go`` holds: read on the
        host, or (static) a `branch` on the device flag, the step run on
        a copy of ``st``. Returns ``(st, *carry)``."""
        def body(st, *carry):
            new = dataclasses.replace(st)
            return (new, *step(new, *carry))

        return branch(go if static else bool(go), body, st, *carry)

    def assign(st, new):
        """Take ``new``'s fields into ``st`` (a step that updates ``st``
        in place around a guarded sub-step)."""
        vars(st).update(vars(new))

    def run_loop(st, n, budget, body):
        """``body(st)`` while ``st.it < budget`` and an instance is
        unsettled; static: ``n`` guarded passes, ``n`` being the loop's
        bound (every active instance gains K iterations a pass)."""
        if not static:
            while st.it < budget and not settled(st):
                body(st)
            return st
        for _ in range(n):
            go = (st.it < budget) & ~(st.done | (st.itv >= max_iter)).all()
            st = guarded(go, lambda s: body(s) or (), st)[0]
        return st

    def lift32(st):
        # instances entering the f32 phase drop to f32 values; frozen
        # (already done) instances keep their f64 state
        frozen = st.done[None, :]
        z32 = lambda a: torch.where(frozen, a, a.float().double())
        st.xc, st.s, st.mu, st.v = z32(st.xc), z32(st.s), z32(st.mu), z32(st.v)

    op32 = {}

    def chunk32(st, Kc, tau):
        """One approach-phase chunk (`admm_chunk_f32`); frozen instances
        keep their f64 state, iterated ones come back as f32 values. The
        f32 operator is cached per operator on the eager path; a static
        solve converts it in every chunk (a chunk may run in a branch's
        body, and what a skipped body made holds nothing)."""
        if static or op32.get("src") is not st.Fcc:
            op32.update(src=st.Fcc, Fcc=st.Fcc.float().contiguous(),
                        xc=st.xc_const.float().contiguous())
        (x, s, mu, v, done, _n_iter, itv, xrn, lrn, prim, dual) = admm_chunk_f32(
            op32["Fcc"], op32["xc"], lbc32, ubc32, mu_eff32, st.rho,
            tau, tau,
            st.xc.float(), st.s.float(), st.mu.float(), st.v.float(),
            st.done, st.n_iter, st.itv,
            st.x_res_norm.float(), st.lam_res_norm.float(),
            st.prim_norm.float(), st.dual_norm.float(),
            kb=kb, K=Kc, max_iter=max_iter, weights=wk, alpha=alpha,
        )
        frozen = st.done[None, :]
        keep = lambda new, old: torch.where(frozen, old, new.double())
        st.xc, st.s = keep(x, st.xc), keep(s, st.s)
        st.mu, st.v = keep(mu, st.mu), keep(v, st.v)
        st.x_res_norm, st.lam_res_norm = xrn.double(), lrn.double()
        st.prim_norm, st.dual_norm = prim.double(), dual.double()
        st.itv, st.done = itv, done
        st.it = st.it + Kc

    def chunk64(st):
        """One endgame chunk (`admm_chunk_f64`)."""
        (st.xc, st.s, st.mu, st.v, st.done, st.n_iter, st.itv,
         st.x_res_norm, st.lam_res_norm, st.prim_norm,
         st.dual_norm) = admm_chunk_f64(
            st.Fcc, st.xc_const, lbc, ubc, mu_eff, st.rho.double(),
            eps_b, eps_f,
            st.xc, st.s, st.mu, st.v, st.done, st.n_iter, st.itv,
            st.x_res_norm, st.lam_res_norm, st.prim_norm, st.dual_norm,
            kb=kb, K=K, max_iter=max_iter, weights=wk64, inc_gate=inc_gate,
            alpha=alpha,
        )
        st.it = st.it + K

    def rebuild(rho):
        if opts.kkt_factor == "hybrid":
            return _factor_reduced_hybrid(qps, rho, ci, mask,
                                          opts.kkt_refine_steps + 1,
                                          static=static)[:4]
        return _factor_reduced(qps, rho, ci, mask, opts.kkt_refine_steps,
                               static=static)

    def adapt(st):
        """Adaptive rho after a chunk (the JAX engine's `adapt`): due at
        ``next_adapt`` (then doubled) while fewer than
        ``adaptive_rho_max_adaptations`` rebuilds ran; the operator is
        rebuilt on the whole batch when some rho changed, with the exact
        factor (hybrid, or the f64 Schur route), as the JAX engine's
        `_reduced_factor_fn` does. Static: a branch on whether the check
        is due, holding a branch on whether some rho changed."""
        if not opts.adaptive_rho:
            return
        if static:
            def check(st):
                st.next_adapt = st.next_adapt * 2
                rho, scale, changed = _rho_step(st.prim_norm, st.dual_norm,
                                                st.done, st.rho, opts,
                                                static=True)

                def change(st):
                    st.rho = rho
                    st.mu = st.mu * scale.double()[None, :]
                    st.Fcc, st.xc_const, st.Fcolj, st.x_const = rebuild(rho)
                    st.n_refactor = st.n_refactor + 1
                    return ()

                assign(st, guarded(changed, change, st)[0])
                return ()

            due = (st.it >= st.next_adapt) & (
                st.n_refactor < opts.adaptive_rho_max_adaptations)
            assign(st, guarded(due, check, st)[0])
            return
        if not (st.it >= st.next_adapt
                and st.n_refactor < opts.adaptive_rho_max_adaptations):
            return
        st.next_adapt = st.next_adapt * 2
        step = _rho_step(st.prim_norm, st.dual_norm, st.done, st.rho, opts)
        if step is None:
            return
        st.rho, scale = step
        st.mu = st.mu * scale.double()[None, :]
        st.Fcc, st.xc_const, st.Fcolj, st.x_const = rebuild(st.rho)
        st.n_refactor = st.n_refactor + 1
        clock.count("n_refactor", 1)

    coarse_tol = max(opts.phase1_tol, opts.polish_tol if opts.polish else 0.0)
    two_phase = coarse_tol > max(opts.eps_bound, opts.eps_fcone)
    do_polish = opts.polish and two_phase
    pol = None
    n_attempts = torch.zeros((B,), dtype=torch.int32, device=dev)

    def polish_args(st, idx=None):
        g = (lambda a: a) if idx is None else (lambda a: a[..., idx])
        sub = qps if idx is None else _gather_qp(qps, idx)
        return dict(
            qps=sub, shape=shape, ci=ci, kb=kb, s=g(st.s), mu_dual=g(st.mu),
            rho=g(st.rho), wk=g(wk), lbc=g(lbc), ubc=g(ubc),
            e_scale=g(prep.e), eps_bound=opts.eps_bound,
            eps_fcone=opts.eps_fcone, act_tol=opts.polish_act_tol,
            newton_steps=opts.polish_newton_steps, clock=clock,
            static=static,
        )

    def adopt(st, acc, p_s, p_mu, p_xres, p_lres, idx=None):
        """Accepted instances take the polished slack / duals / residuals
        and are frozen with n_iter = their iteration count."""
        if idx is None:
            a2 = acc[None, :]
            st.s = torch.where(a2, p_s, st.s)
            st.mu = torch.where(a2, p_mu, st.mu)
            st.x_res_norm = torch.where(acc, p_xres, st.x_res_norm)
            st.lam_res_norm = torch.where(acc, p_lres, st.lam_res_norm)
            st.n_iter = torch.where(acc, st.itv, st.n_iter)
            st.done = st.done | acc
            return
        st.s = _scatter_last(st.s, idx, p_s, acc)
        st.mu = _scatter_last(st.mu, idx, p_mu, acc)
        st.x_res_norm = _scatter_last(st.x_res_norm, idx, p_xres, acc)
        st.lam_res_norm = _scatter_last(st.lam_res_norm, idx, p_lres, acc)
        st.n_iter = _scatter_last(st.n_iter, idx, st.itv[idx], acc)
        st.done = _put_last(st.done, idx, st.done[idx] | acc)

    def attempt_full(st, **kw):
        """A polish attempt on the full batch; newly accepted instances
        are adopted and frozen."""
        p = polish_reduced(**polish_args(st), **kw)
        acc = p.accept & ~st.done
        adopt(st, acc, p.s, p.mu, p.x_res, p.lam_res)
        return _Polish(x=p.x, accept=acc, seed=p.seed, cls=p.cls)

    C_r = gather_capacity(B)

    def attempt_gathered(st, pol, n_attempts):
        """A retry polish on a capacity-gathered sub-batch of the
        instances not yet accepted, from their refreshed seeds; every
        retried instance takes the attempt's seed and classification."""
        rem = ~pol.accept & ~st.done & (st.itv < max_iter)
        idx = torch.argsort(-rem.float(), stable=True)[:C_r]
        sel = rem[idx]
        p = polish_reduced(**polish_args(st, idx), seed=pol.seed[idx])
        acc_s = p.accept & sel
        adopt(st, acc_s, p.s, p.mu, p.x_res, p.lam_res, idx=idx)
        seed = pol.seed.clone()
        seed[idx] = torch.where(sel[:, None, None], p.seed, seed[idx])
        pol = _Polish(
            x=_scatter_last(pol.x, idx, p.x, acc_s),
            accept=_put_last(pol.accept, idx, pol.accept[idx] | acc_s),
            seed=seed,
            cls=_scatter_last(pol.cls, idx, p.cls, sel),
        )
        n_attempts = _put_last(n_attempts, idx, n_attempts[idx] + sel.int())
        return pol, n_attempts

    warm_polish = do_polish and polish_seed is not None
    if two_phase:
        if warm_polish:
            # warm attempt 0, full batch, straight from the warm state
            # with the carried seed and classification: a replay step
            # moves the data ~0.1%, so the previous active set is almost
            # always still exact and one PDAS solve is the new solution.
            # Accepted instances finish with n_iter 0 and stay frozen.
            pol = attempt_full(st, seed=polish_seed, init_class=polish_cls)
            n_attempts = torch.ones((B,), dtype=torch.int32, device=dev)
            clock.mark("polish")
        # phase 1: plain-f32 approach to the coarse tolerance
        lift32(st)

        def approach(st):
            chunk32(st, K, coarse_tol)
            adapt(st)

        st = run_loop(st, n_chunks, n_chunks * K, approach)
        clock.mark("approach")

        def pending(st, pol):
            return ~(pol.accept | (st.itv >= max_iter)).all()

        def retry(st, pol, n_attempts):
            st.done = pol.accept.clone()
            pol, n_attempts = attempt_gathered(st, pol, n_attempts)
            clock.mark("polish")
            return pol, n_attempts

        if warm_polish:
            # coarse-point retry of the warm-rejected instances only,
            # gathered, and skipped when attempt 0 accepted everyone
            st, pol, n_attempts = guarded(pending(st, pol), retry, st, pol,
                                          n_attempts)
        else:
            # "crossed tau" is not converged
            st.done = torch.zeros_like(st.done)
            if do_polish:
                # attempt 1 at the coarse point, full batch
                pol = attempt_full(st)
                n_attempts = torch.ones((B,), dtype=torch.int32, device=dev)
                clock.mark("polish")
        if do_polish:
            # re-polish rounds: rejected instances run a short f32 chunk
            # at a tighter tolerance, then retry on a capacity-gathered
            # sub-batch from the refreshed seed; a round is skipped once
            # every instance is accepted or out of iterations
            def polish_round(st, pol, n_attempts, tau):
                chunk32(st, opts.polish_interval, tau)
                clock.mark("approach")
                return retry(st, pol, n_attempts)

            round_tau = coarse_tol
            for _ in range(opts.polish_rounds - 1):
                round_tau = max(
                    round_tau * 0.125,
                    4.0 * max(opts.eps_bound, opts.eps_fcone),
                    1e-4,
                )
                st, pol, n_attempts = guarded(
                    pending(st, pol),
                    lambda s, p, n, tau=round_tau: polish_round(s, p, n, tau),
                    st, pol, n_attempts)
    itv_f32 = st.itv.clone()

    if _lazy_exact(opts):
        # the deferred exact operator, for instances polish did not
        # accept (and whose f32 seed never contracted), built on
        # capacity-gathered sub-batches LOOPING until every one is
        # covered (static: the ``ceil(B / C3)`` passes that cover the
        # batch, each a branch on whether any is left): an overflow
        # instance left on the f32 operator would converge to a perturbed
        # fixed point and read kSuccess
        maxed = st.itv >= max_iter
        rem = ~(st.done | maxed)
        if prep.seed_bad is not None:
            rem = rem | (prep.seed_bad & ~maxed)
        C3 = exact_capacity(B)

        def exact_pass(Fcc, xc_const, Fcolj, x_const, rem):
            # in place (no chunk32 runs after this build, so the f32
            # operator cached from the old Fcc is never read again)
            idx = torch.argsort(-rem.float(), stable=True)[:C3]
            sel = rem[idx]
            out = _factor_reduced_hybrid(
                _gather_qp(qps, idx), st.rho[idx], ci, mask,
                opts.kkt_refine_steps + 1, static=static, clock=clock,
            )[:4]
            ops = (Fcc, xc_const, Fcolj, x_const)
            for full, sub in zip(ops, out):
                _put_where(full, idx, sub, sel)
            rem.index_fill_(0, idx, False)
            return (*ops, rem)

        st.Fcc, st.xc_const, st.Fcolj, st.x_const, _ = gathered_loop(
            static, pass_count(B, C3), lambda *c: c[-1], exact_pass,
            st.Fcc, st.xc_const, st.Fcolj, st.x_const, rem)
        clock.mark("exact_build")

    it_budget = 2 * n_chunks * K + (opts.polish_rounds - 1) * opts.polish_interval

    def endgame(st):
        chunk64(st)
        adapt(st)

    # n_chunks passes settle every instance: none enters the endgame with
    # more than max_iter iterations to go, and the budget leaves room for
    # n_chunks passes after the approach phase and the polish rounds
    st = run_loop(st, n_chunks, it_budget, endgame)
    clock.mark("endgame")

    # final full-space primal at the v that PRODUCED the accepted xc
    x_s = st.x_const + st.rho.double()[None, :] * matvec_ds(st.Fcolj, st.v)
    if pol is not None:
        x_s = torch.where(pol.accept[None, :], pol.x, x_s)
    x = x_s * d.double()
    # equality-constrained instances take the exact presolve
    eq_c = prep.eq_c
    if nc == 0 and eq_c is not None:
        def presolve(x):
            x_eq = kkt_solve_refined_ds(qps.Q, qps.A_eq, -qps.b, qps.b_eq,
                                        static=static)
            return (torch.where(eq_c[None, :], x_eq * d.double(), x),)

        (x,) = branch(eq_c.any() if static else bool(eq_c.any()),
                      presolve, x)
    else:
        eq_c = torch.zeros((B,), dtype=torch.bool, device=dev)
    n_iter = torch.where(eq_c, 0, st.n_iter).to(torch.int32)
    nz = lambda a: torch.where(eq_c, torch.zeros_like(a), a)

    # violations in unscaled units against the original data
    bdiff = x - torch.clamp(x, qp.lb, qp.ub)
    bounds_viol = torch.sqrt((bdiff * bdiff).sum(dim=0))
    f3 = x[ls:ls + nc].reshape(nc // 3, 3, B)
    nxy = torch.sqrt(f3[:, 0] ** 2 + f3[:, 1] ** 2)
    fcone_viol = torch.clamp_min(
        nxy - qp.friction_coeffs * f3[:, 2], 0.0
    ).sum(dim=0)

    eq_viol = _eq_residual_inf(qp, x)
    zeros_i = torch.zeros((B,), dtype=torch.int32, device=dev)
    status = _status_checked(n_iter, max_iter, eq_viol, qp)
    if pol is not None:
        # a polish-accepted instance carries a self-validated solution
        status = torch.where(
            pol.accept & (status == int(FCCQPSolveStatus.kMaxIterations)),
            torch.full_like(status, int(FCCQPSolveStatus.kSuccess)),
            status,
        )
    details = FCCQPDetails(
        n_iter=n_iter,
        admm_residual_bounds=nz(st.x_res_norm),
        admm_residual_friction_cone=nz(st.lam_res_norm),
        solve_time=zeros_b,
        factorization_time=zeros_b,
        bounds_viol=bounds_viol,
        friction_cone_viol=fcone_viol,
        solve_status=status,
        equality_viol=eq_viol,
        n_iter_f32=nz(itv_f32),
        n_iter_ds=nz(st.itv - itv_f32),
        polish_attempts=nz(n_attempts),
        polish_accepted=nz(pol.accept.int() if pol is not None else zeros_i),
    )

    # warm state: full-space, UNSCALED
    mu_u = st.mu * wk64
    mu_x = torch.zeros((nv, B), dtype=f64, device=dev)
    mu_x[ci_t[:kb]] = mu_u[:kb]
    new_warm = WarmStartDS(
        x=x, mu_x=mu_x, mu_lambda_c=mu_u[kb:], rho=st.rho,
    )
    sol = FCCQPSolution(details=details, z=x.T.contiguous())
    clock.mark("finalize")
    if with_cache:
        cache = OperatorCache(
            kkt_seed=prep.kkt_seed,
            polish_seed=pol.seed if pol is not None else None,
            polish_cls=pol.cls if pol is not None else None,
            scales=Scaling(d=prep.d, e=prep.e, c=prep.c),
        )
        return sol, new_warm, cache
    return sol, new_warm


# --------------------------------------------------------------------------
# the full-splitting engine (the package defaults: the reference's rho*I
# splitting over all n variables, no scaling, no polish)
# --------------------------------------------------------------------------


def _factor(qp: QPBatchDS, rho: torch.Tensor, refine_steps: int,
            static: bool = False):
    """The full-splitting operator ``(Fj, x_const)``: Fj (n, n, B) j-major
    so that the primal update is ``x = x_const + rho F v``, from the f64
    Schur-Cholesky route with refinement against the true KKT
    (`ops.ds_linalg.kkt_inverse_blocks_refined_ds`). The computed F is not
    exactly symmetric, so it is transposed to j-major explicitly.
    ``static``: read-free (its shift levels and extra refinement are
    branches)."""
    F, G = kkt_inverse_blocks_refined_ds(qp.Q, qp.A_eq, rho,
                                         refine_steps=refine_steps,
                                         static=static)
    Fj = transpose_ds(F).contiguous()
    x_const = matvec_ds(transpose_ds(G), qp.b_eq) - matvec_ds(Fj, qp.b)
    return Fj, x_const.contiguous()


class _PrepFull(NamedTuple):
    """Factorization-phase outputs of the full-splitting engine."""

    mu_x0: torch.Tensor    # (n, B)
    mu_lam0: torch.Tensor  # (nc, B)
    rho0: torch.Tensor     # (B,) f32
    x_init: torch.Tensor   # (n, B)
    eq_c: torch.Tensor     # (B,) equality-constrained instances
    Fj: torch.Tensor       # (n, n, B)
    x_const: torch.Tensor  # (n, B)


def _prepare_full(qp: QPBatchDS, warm: Optional[WarmStartDS], shape,
                  opts: FCCQPOptions, warm_start: bool,
                  static: bool = False) -> _PrepFull:
    """Stage 1 of the full engine (the "factorization" phase): the
    warm-state setup, the exact presolve (or, with ``presolve='operator'``,
    the operator's own constant term as the initial primal) and the KKT
    operator. ``static``: read-free (the presolve of a warm solve's
    equality-constrained instances is a branch on whether there is one)."""
    nv, nc = shape.num_vars, shape.nc
    B = qp.batch
    dev = qp.b.device
    f64 = torch.float64
    if warm_start:
        if warm is None:
            raise ValueError("warm_start=True needs a warm state")
        mu_x0, mu_lam0 = warm.mu_x, warm.mu_lambda_c
        rho0 = warm.rho.float()
        x_init = warm.x
    else:
        mu_x0 = torch.zeros((nv, B), dtype=f64, device=dev)
        mu_lam0 = torch.zeros((nc, B), dtype=f64, device=dev)
        rho0 = torch.full((B,), opts.rho, dtype=torch.float32, device=dev)
        x_init = None
        if opts.presolve == "exact":
            x_init = kkt_solve_refined_ds(qp.Q, qp.A_eq, -qp.b, qp.b_eq,
                                          static=static)
    eq_c = _equality_only(qp, nc)
    if warm_start and nc == 0:
        # (with cones no instance is equality-constrained)
        def presolve(x_init):
            x_pre = kkt_solve_refined_ds(qp.Q, qp.A_eq, -qp.b, qp.b_eq,
                                         static=static)
            return (torch.where(eq_c[None, :], x_pre, x_init),)

        (x_init,) = branch(eq_c.any() if static else bool(eq_c.any()),
                           presolve, x_init)
    Fj, x_const = _factor(qp, rho0, opts.kkt_refine_steps, static=static)
    if x_init is None:
        # operator presolve: the rho-regularized equality-QP solution
        # (the v = 0 primal update)
        x_init = x_const
    return _PrepFull(mu_x0=mu_x0.contiguous(), mu_lam0=mu_lam0.contiguous(),
                     rho0=rho0, x_init=x_init.contiguous(), eq_c=eq_c,
                     Fj=Fj, x_const=x_const)


def _iterate_full(qp: QPBatchDS, prep: _PrepFull, shape,
                  opts: FCCQPOptions, clock: Optional[StageClock] = None,
                  static: bool = False):
    """Stage 2 of the full engine: the ADMM loop in chunks of
    `admm_chunk_full_f64` (of ``adaptive_rho_interval`` iterations when
    adapting, else ``min(max_iter, 64)``) with adaptive rho between
    chunks (`chunk_loop`: eager, one host read per chunk and one per
    adaptation; ``static``, read-free), then the violations, status and
    warm state."""
    nc, ls = shape.nc, shape.lambda_c_start
    B = qp.batch
    dev = qp.b.device
    clock = clock or StageClock()
    max_iter = opts.max_iter
    # the JAX engine compares its residuals against f32 tolerances
    eps_b = float(np.float32(opts.eps_bound))
    eps_f = float(np.float32(opts.eps_fcone))
    gate = GATE_SPLIT if opts.presolve == "operator" else GATE_OFF
    alpha = _alpha(opts)
    K = opts.adaptive_rho_interval if opts.adaptive_rho else min(max_iter, 64)
    n_chunks = -(-max_iter // K)

    x0 = prep.x_init
    zb = torch.zeros((B,), dtype=torch.float64, device=dev)
    # the chunk kernel's state, in its argument order
    keys = ("x", "x_bar", "lam_bar", "mu_x", "mu_lam", "v", "done",
            "n_iter", "itv", "xrn", "lrn", "prim", "dual")
    st = (x0, x0, x0[ls:ls + nc].contiguous(), prep.mu_x0, prep.mu_lam0,
          x0 - prep.mu_x0, torch.zeros((B,), dtype=torch.bool, device=dev),
          torch.full((B,), max_iter, dtype=torch.int32, device=dev),
          torch.zeros((B,), dtype=torch.int32, device=dev), zb, zb, zb, zb)
    lb, ub = qp.lb.contiguous(), qp.ub.contiguous()
    mu_f = qp.friction_coeffs.contiguous()

    def chunk(st, rho, op):
        return admm_chunk_full_f64(
            *op, lb, ub, mu_f, rho.double(), eps_b, eps_f, *st, ls=ls, K=K,
            max_iter=max_iter, gate=gate, alpha=alpha)

    st, rho, _, n_refactor = chunk_loop(
        st, keys, prep.rho0, (prep.Fj, prep.x_const), chunk,
        lambda rho: _factor(qp, rho, opts.kkt_refine_steps, static=static),
        opts, n_chunks, K, static)
    clock.mark("iterate")
    clock.count("n_refactor", n_refactor)
    st = dict(zip(keys, st))

    eq_c = prep.eq_c
    x = torch.where(eq_c[None, :], prep.x_init, st["x"])
    n_iter = torch.where(eq_c, 0, st["n_iter"]).to(torch.int32)
    nz = lambda a: torch.where(eq_c, torch.zeros_like(a), a)
    bdiff = x - torch.clamp(x, qp.lb, qp.ub)
    bounds_viol = torch.sqrt((bdiff * bdiff).sum(dim=0))
    f3 = x[ls:ls + nc].reshape(nc // 3, 3, B)
    nxy = torch.sqrt(f3[:, 0] ** 2 + f3[:, 1] ** 2)
    fcone_viol = torch.clamp_min(
        nxy - qp.friction_coeffs * f3[:, 2], 0.0).sum(dim=0)
    eq_viol = _eq_residual_inf(qp, x)
    zi = torch.zeros((B,), dtype=torch.int32, device=dev)
    details = FCCQPDetails(
        n_iter=n_iter, admm_residual_bounds=nz(st["xrn"]),
        admm_residual_friction_cone=nz(st["lrn"]), solve_time=zb,
        factorization_time=zb, bounds_viol=bounds_viol,
        friction_cone_viol=fcone_viol,
        solve_status=_status_checked(n_iter, max_iter, eq_viol, qp),
        equality_viol=eq_viol, n_iter_f32=zi,
        # the full engine iterates in f64 only
        n_iter_ds=n_iter, polish_attempts=zi, polish_accepted=zi,
    )
    new_warm = WarmStartDS(
        x=x, mu_x=torch.where(eq_c[None, :], prep.mu_x0, st["mu_x"]),
        mu_lambda_c=st["mu_lam"], rho=rho,
    )
    clock.mark("finalize")
    return FCCQPSolution(details=details, z=x.T.contiguous()), new_warm


def _rescale_duals(st: tuple, keys: tuple, scale: torch.Tensor) -> tuple:
    """The chunk state ``st`` (in ``keys`` order) with the scaled duals
    times ``scale`` (rho_old / rho_new), so that the unscaled duals stay."""
    st = list(st)
    for k in ("mu_x", "mu_lam"):
        mu = st[keys.index(k)]
        st[keys.index(k)] = mu * scale.to(mu.dtype)[None, :]
    return tuple(st)


def chunk_loop(st: tuple, keys: tuple, rho: torch.Tensor, op: tuple, chunk,
               rebuild, opts: FCCQPOptions, n_chunks: int, K: int,
               static: bool = False):
    """The chunk loop of the full-layout engines (the full-splitting
    engine here, `core.batched.solve_batched_fast`), the port of their
    JAX ``while_loop`` with the adaptation between chunks:
    ``chunk(st, rho, op)`` runs one chunk and returns the new state (in
    ``keys`` order: ``done``, ``itv``, ``prim`` and ``dual`` among them;
    ``itv``, each running instance's iteration count, is set to the
    global count before every chunk: a frozen instance is done on these
    single-phase engines); ``rebuild(rho)`` returns the operator ``op``
    (a tuple of tensors) of a new rho. While an instance runs and fewer
    than ``n_chunks`` chunks ran: a chunk, then, when adapting, a check
    that falls due at ``next_adapt`` (then doubled) while fewer than
    ``adaptive_rho_max_adaptations`` rebuilds ran: `_rho_step` in rho's
    dtype, and where some rho changed, the scaled duals rescaled and the
    whole batch's operator rebuilt.

    Eager: the loop reads ``done`` and the rho change on the host.
    ``static``: read-free: ``n_chunks`` chunks, each a `branch` on
    whether an instance still runs, with the counters on the device and
    the rebuild a branch on whether the check is due and some rho
    changed (the JAX engines' ``lax.cond``). Returns ``(st, rho, op,
    n_refactor)`` (a 0-d device counter when static)."""
    i = keys.index
    max_adapt = opts.adaptive_rho_max_adaptations

    def chunk_from(st, rho, op, it):
        st = list(st)
        st[i("itv")] = torch.full_like(st[i("itv")], it)
        return tuple(chunk(st, rho, op))

    if not static:
        it, next_adapt, n_refactor = 0, K, 0
        while it < n_chunks * K and not bool(st[i("done")].all()):
            st = chunk_from(st, rho, op, it)
            it += K
            if not (opts.adaptive_rho and it >= next_adapt
                    and n_refactor < max_adapt):
                continue
            next_adapt *= 2
            step = _rho_step(st[i("prim")], st[i("dual")], st[i("done")],
                             rho, opts, dtype=rho.dtype)
            if step is None:
                continue
            rho, scale = step
            st, op = _rescale_duals(st, keys, scale), rebuild(rho)
            n_refactor += 1
        return st, rho, op, n_refactor

    dev = rho.device
    count = lambda v: torch.full((), v, dtype=torch.int32, device=dev)
    next_adapt, n_refactor = count(K), count(0)
    for c in range(n_chunks):
        # a check falls due only where the iteration count reaches
        # next_adapt, which starts at K and doubles at every due check:
        # after the chunks c with c + 1 a power of two
        check = opts.adaptive_rho and (c + 1) & c == 0

        def step(st, rho, op, next_adapt, n_refactor, c=c, check=check):
            st = chunk_from(st, rho, op, c * K)
            if not check:
                return st, rho, op, next_adapt, n_refactor
            due = (next_adapt <= (c + 1) * K) & (n_refactor < max_adapt)
            next_adapt = torch.where(due, next_adapt * 2, next_adapt)
            new_rho, scale, changed = _rho_step(
                st[i("prim")], st[i("dual")], st[i("done")], rho, opts,
                dtype=rho.dtype, static=True)

            def adapt(st, rho, op, n_refactor):
                return (_rescale_duals(st, keys, scale), new_rho,
                        rebuild(new_rho), n_refactor + 1)

            st, rho, op, n_refactor = branch(due & changed, adapt, st, rho,
                                             op, n_refactor)
            return st, rho, op, next_adapt, n_refactor

        st, rho, op, next_adapt, n_refactor = branch(
            ~st[i("done")].all(), step, st, rho, op, next_adapt, n_refactor)
    return st, rho, op, n_refactor


def solve_batched_ds(
    qp: QPBatchDS,
    shape: ProblemShape,
    opts: FCCQPOptions = FCCQPOptions(),
    warm: Optional[WarmStartDS] = None,
    warm_start: bool = False,
    device=None,
    stage_times: Optional[dict] = None,
    con_idx: Optional[tuple] = None,
    graphs: Optional[bool] = None,
    timing: bool = True,
):
    """Batched cold (or warm-started) solve.

    With Ruiz scaling, constrained splitting, polish or an explicit
    ``con_idx`` the solve takes the reduced path (equilibrated, the
    splitting over the constrained coordinates, or over all of them with
    ``splitting='full'``; a batch without any constrained coordinate is
    one refined KKT solve); otherwise it takes the full-splitting engine
    with the reference's semantics (the package defaults). Both take
    over-relaxation (``alpha``) and adaptive rho.

    Runs on ``device`` (default CUDA; raises when there is no card),
    moving ``qp`` / ``warm`` there if they live elsewhere. On the card
    both engines run captured: the first call of each ``(engine, shape,
    opts, batch size, con_idx, warm_start)`` captures its read-free solve
    (`reduced_stages`, `full_stages`) as CUDA graphs
    (`core.graphs.solve_captured`; the counterpart of the JAX package's
    compile per shape), and every call copies the batch into the graphs'
    buffers and replays them, with no host read until the result is
    copied out. ``graphs=False`` runs it uncaptured (the eager path,
    which reads the device between chunks).

    ``details.solve_time`` / ``factorization_time``: both stages' span
    and the operator stage's, from CUDA events around the replays
    (captured), else wall-clock spans each ending in a device
    synchronize. ``timing=False`` leaves both zero and adds no barrier: a
    captured call then returns once its replay and copy-out are queued
    (`core.graphs.solve_captured`, which says why calls so queued must
    share one stream), after the reduced path's first call on a batch
    has read its bounds; an eager one still reads the device between
    chunks. ``stage_times``: a dict that receives the synchronized
    wall seconds of each stage (reduced: scaling, operator, approach,
    polish, exact_build, endgame, finalize; full: operator, iterate,
    finalize), the adaptive-rho refactor count ``n_refactor`` and the
    instance counts of the rescues (``n_kkt_rescue``, ``n_polish_rebuild``,
    ``n_fallback``, ``n_fallback_calls``); it adds a device synchronize at
    every stage boundary, so such a call runs uncaptured. ``con_idx``:
    the constrained coordinates (`constrained_indices`), computed from
    ``qp`` when None (bounds on the card are read at the first call on
    them only); the replays pass those of their whole log.

    Returns ``(FCCQPSolution, WarmStartDS)``.
    """
    dev = resolve_device(device)
    reduced = _reduced(opts) or con_idx is not None
    if reduced and con_idx is None:
        con_idx = constrained_indices(qp, shape,
                                      full=opts.splitting == "full")
    qp = QPBatchDS(*(a.to(dev) for a in qp))
    if warm is not None:
        warm = WarmStartDS(*(a.to(dev) for a in warm))
    if graphs and dev.type != "cuda":
        raise ValueError("CUDA graphs need a CUDA device")
    if dev.type == "cuda" and stage_times is None and graphs is not False:
        from fcc_qp_tpu_torch.core.graphs import solve_captured

        stages = (reduced_stages(shape, opts, con_idx) if reduced
                  else full_stages(shape, opts))
        return solve_captured(stages, qp, warm, warm_start, dev, timing)
    t0 = time.perf_counter()
    clock = StageClock(stage_times, dev)
    if reduced and len(con_idx) == 0:
        # pure equality: the whole solve is one refined KKT solve
        sol, ws = _solve_reduced_k0(qp, shape, opts)
        if not timing:
            return sol, ws
        sync(dev)
        t = time.perf_counter() - t0
        return stamp_solution_times(sol, t, t), ws
    if reduced:
        prep = _prepare_reduced(
            qp, warm, shape, opts, warm_start, con_idx, clock=clock
        )
    else:
        prep = _prepare_full(qp, warm, shape, opts, warm_start)
        clock.mark("operator")
    if timing:
        sync(dev)
    t1 = time.perf_counter()
    if reduced:
        sol, ws = _iterate_reduced(qp, prep, shape, opts, con_idx,
                                   clock=clock)
    else:
        sol, ws = _iterate_full(qp, prep, shape, opts, clock=clock)
    if not timing:
        return sol, ws
    sync(dev)
    t2 = time.perf_counter()
    return stamp_solution_times(sol, t2 - t0, t1 - t0), ws


def _solve_ds_reduced(qp, warm, shape, opts, warm_start, con_idx,
                      cache: Optional[OperatorCache] = None,
                      with_cache: bool = False,
                      clock: Optional[StageClock] = None,
                      static: bool = False):
    """The composed reduced solve of one replay step (the port of
    `fcc_qp_tpu.core.ds_engine._solve_ds_reduced_jit`): both stages with
    no phase timing. ``cache``: carried operator seeds, scales and
    polish classification; ``with_cache`` returns
    ``(sol, warm, OperatorCache)``. ``static``: read-free, at most 128
    instances (the module docstring)."""
    cache = cache if cache is not None else OperatorCache()
    if len(con_idx) == 0:
        out = _solve_reduced_k0(qp, shape, opts, static=static)
        return out + (OperatorCache(),) if with_cache else out
    prep = _prepare_reduced(
        qp, warm, shape, opts, warm_start, con_idx, clock=clock,
        kkt_seed=cache.kkt_seed, scales=cache.scales, static=static,
    )
    return _iterate_reduced(
        qp, prep, shape, opts, con_idx, clock=clock,
        polish_seed=cache.polish_seed, polish_cls=cache.polish_cls,
        with_cache=with_cache, static=static,
    )


def _to_global(sols, S: int):
    """Per-step solutions, each over the same ``S`` streams, stacked in
    global time order: row ``s * steps + t`` is stream s's step t."""

    def g(*per_step):
        a = torch.stack(per_step, dim=1)          # (S, steps, ...)
        return a.reshape(S * len(per_step), *a.shape[2:])

    det = FCCQPDetails(**{
        f.name: g(*(getattr(sol.details, f.name) for sol in sols))
        for f in dataclasses.fields(FCCQPDetails)
    })
    return FCCQPSolution(details=det, z=g(*(sol.z for sol in sols)))


def replay_ds_streams(
    qps: QPBatchDS,
    shape: ProblemShape,
    opts: FCCQPOptions = FCCQPOptions(),
    n_streams: int = 1024,
    device=None,
    stage_times: Optional[dict] = None,
    graphs: Optional[bool] = None,
):
    """Warm-started multi-stream replay: the port of
    `fcc_qp_tpu.core.ds_engine.replay_ds_streams`.

    The length-T log ``qps`` (batch-last, time on the last axis) is
    split into ``n_streams`` parallel streams of ``T / S`` consecutive
    steps (stream s owns global steps ``[s*T/S, (s+1)*T/S)``). Step 0 of
    every stream is one cold batched solve; each later step is a warm
    solve of all S streams at once that threads the `WarmStartDS` and
    the `OperatorCache` of the step before (a Python loop on the device
    in place of the JAX package's `lax.scan`). Each stream is the
    reference's serial warm-started loop; the streams fill the card.

    Runs on ``device`` (default CUDA; raises when there is no card). On
    the card the full engine's steps replay `solve_batched_ds`'s capture,
    and the reduced path runs captured (`core.graphs.replay_captured`):
    step 0 replays the cold graphs of the S-stream batch and every later
    step the warm graphs, which carry the warm state and the operator
    cache in static buffers, with no host read between steps (the JAX
    package's ``lax.scan``); the first replay of a configuration
    captures. ``graphs=False`` runs the steps uncaptured (the eager
    path, which reads the device between chunks).
    ``stage_times``: a dict that receives, under
    ``"step0"`` and ``"warm"``, the synchronized stage seconds of the
    cold step and their sums over the warm steps, with the instance
    counts ``n_kkt_rescue`` (cold KKT-seed rebuilds of non-contracting
    refreshes), ``n_polish_rebuild`` (cold polish-seed rebuilds),
    ``n_fallback`` and ``n_fallback_calls`` (the hybrid operator's f64
    fallback); it adds a device synchronize at every stage boundary, so
    such a replay runs uncaptured.

    Returns ``(solutions, final_warm)``: the solutions stacked in GLOBAL
    time order (row t is step t of the log), with ``details.solve_time``
    the replay wall over the number of steps and
    ``details.factorization_time`` the step-0 operator graph's span
    (captured), or a cached probe of one cold factorization stage on the
    step-0 batch, measured after the replay (uncaptured).
    """
    dev = resolve_device(device)
    T = qps.batch
    S = n_streams
    if T % S != 0:
        raise ValueError(f"T={T} must be a multiple of n_streams={S}")
    steps = T // S
    reduced = _reduced(opts)
    con_idx = (constrained_indices(qps, shape, full=opts.splitting == "full")
               if reduced else None)

    # step-major copy of the log: element [t, ..., s] is global step
    # s*steps + t, and each step is one contiguous (..., S) view
    def step_major(a):
        a = a.to(dev).reshape(*a.shape[:-1], S, steps)
        return a.movedim(-1, 0).contiguous()

    log = QPBatchDS(*(step_major(a) for a in qps))
    if graphs and dev.type != "cuda":
        raise ValueError("CUDA graphs need a CUDA device")
    if (reduced and dev.type == "cuda" and stage_times is None
            and graphs is not False):
        from fcc_qp_tpu_torch.core.graphs import replay_captured

        sols, ws, wall, factor_t = replay_captured(
            reduced_stages(shape, opts, con_idx, cached=True), log, dev)
        return stamp_solution_times(_to_global(sols, S), wall / steps,
                                    factor_t), ws

    def step(t):
        return QPBatchDS(*(a[t] for a in log))

    def stage(key):
        if stage_times is None:
            return None
        return StageClock(stage_times.setdefault(key, {}), dev)

    def solve_step(t, ws, cache, clock):
        if reduced:
            return _solve_ds_reduced(
                step(t), ws, shape, opts, t > 0, con_idx, cache=cache,
                with_cache=True, clock=clock,
            )
        # the full engine carries no operator cache
        sol, ws = solve_batched_ds(step(t), shape, opts, warm=ws,
                                   warm_start=t > 0, device=dev)
        return sol, ws, None

    # each step is a named span (`utils.timing.span`), a range of its
    # name for `torch.profiler` while one records
    sync(dev)
    t0 = time.perf_counter()
    with span("replay", "step0"):
        sol, ws, cache = solve_step(0, None, None, stage("step0"))
    sols = [sol]
    for t in range(1, steps):
        with span("replay", "warm_step"):
            sol, ws, cache = solve_step(t, ws, cache, stage("warm"))
        sols.append(sol)
    sync(dev)
    t_total = time.perf_counter() - t0
    out = _to_global(sols, S)
    factor_t = _factor_probe(step(0), shape, opts, con_idx)
    return stamp_solution_times(out, t_total / steps, factor_t), ws


_FACTOR_PROBE_CACHE: dict = {}


def _factor_probe(qp0: QPBatchDS, shape, opts, con_idx) -> float:
    """Measured wall seconds of one cold factorization stage on the
    step-0 batch (cached per configuration, batch size and device; a
    first, untimed run warms up)."""
    dev = qp0.b.device
    key = (shape, opts, con_idx, qp0.batch, str(dev))
    if key not in _FACTOR_PROBE_CACHE:
        if con_idx:
            run = lambda: _prepare_reduced(qp0, None, shape, opts, False,
                                           con_idx)
        else:
            run = lambda: _prepare_full(qp0, None, shape, opts, False)
        run()
        sync(dev)
        t0 = time.perf_counter()
        run()
        sync(dev)
        _FACTOR_PROBE_CACHE[key] = time.perf_counter() - t0
    return _FACTOR_PROBE_CACHE[key]


def replay_ds(
    qps: QPBatchDS,
    shape: ProblemShape,
    opts: FCCQPOptions = FCCQPOptions(),
    device=None,
):
    """Serial warm-started replay (the port of
    `fcc_qp_tpu.core.ds_engine.replay_ds`): step 0 is a cold solve of
    one instance, and each later step a `solve_batched_ds` of one
    instance warm-started from the step before, without the operator
    cache (as in the JAX package). The log's time axis is the last.

    Returns ``(solutions, final_warm)`` with the solutions in time order
    over a batch of T (the JAX package returns them as (T, 1, ...)).
    """
    dev = resolve_device(device)
    con_idx = (constrained_indices(qps, shape, full=opts.splitting == "full")
               if _reduced(opts) else None)
    sols, ws = [], None
    for t in range(qps.batch):
        qp_t = QPBatchDS(*(a[..., t:t + 1].contiguous() for a in qps))
        sol, ws = solve_batched_ds(
            qp_t, shape, opts, warm=ws, warm_start=t > 0, device=dev,
            con_idx=con_idx,
        )
        sols.append(sol)
    return _to_global(sols, 1), ws
