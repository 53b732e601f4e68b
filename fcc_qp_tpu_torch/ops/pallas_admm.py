"""Fused ADMM iteration chunks: CUDA kernels and their plain versions.

Port of `fcc_qp_tpu/ops/pallas_admm.py` (the module name is kept so the
counterpart is easy to find; nothing here is Pallas):

* `admm_chunk_f64` replaces `admm_chunk_pallas` (double-single on the
  TPU, native f64 here), the endgame chunk, with the optional
  primal-increment gate ``inc_gate``;
* `admm_chunk_f32` replaces `admm_chunk_pallas32`, the plain-f32
  approach-phase chunk;
* `admm_chunk_full_f64` is `admm_chunk_pallas` in the general layout the
  full-splitting engine, the f64 parity engine and the batch-level engine
  (`core.batched.solve_batched_fast`) call it in: all n variables, the
  cone segment at ``[ls, ls + nc)`` wherever it sits, the box duals (n
  rows) and cone duals (nc rows) kept apart, unit weights;
  `admm_chunk_full_f32` is the same kernel in f32, the parity engine's on
  f32 data.

Every kernel takes the over-relaxation ``alpha`` (the JAX package runs
``alpha != 1`` on its XLA chunk bodies, its Pallas kernels take none):
``x_hat = alpha x + (1 - alpha) s_prev`` feeds the projections and the
dual update, the residuals stay on the true x; at ``alpha == 1`` nothing
of it runs.

All four are hand-written CUDA C++ for sm_90a in `csrc/admm_chunk.cu`,
built with nvcc into a shared library with a plain C interface at first
use (`build_kernels`) and called through ctypes on PyTorch's current
stream. Beside each is its plain PyTorch version (``*_plain``): the same
iteration in tensor ops, with the
mat-vec accumulated in the same j order and no fused multiply-add. A
wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.

Differences from the Pallas kernels, by design:

* `admm_chunk_f64` / `admm_chunk_f32` take the reduced engine's own
  state ``(xc, s, mu, v)`` — the Pallas wrappers take the box and cone
  duals split and lb/ub padded with -+inf on the cone rows, which
  computes the same function (only there: with finite bounds on a cone
  row the two duals differ, which is why the full layout has its own
  kernel and does not permute its cone rows to the tail);
* the residual norms of an instance that does no iteration in the chunk
  are carried through from the inputs (the XLA chunk bodies' semantics;
  the Pallas kernels restart them from zero in every chunk);
* any batch size works: no padding to a 128-instance tile;
* at most `MAX_ROWS` = 96 rows (k, or n on the full layout): three row
  slots of a warp's 32 lanes, which covers every model of `models/osc.py`
  (the humanoid's n = 76 is the largest). The Pallas kernels unroll over
  any row count; a CUDA launch above the limit raises (`check_rows`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import subprocess
import time

import torch

from fcc_qp_tpu_torch.ops.projections import project_cone_ds, sqrt_rn

_CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
_BUILD = pathlib.Path(__file__).resolve().parent.parent / "_build"
_SOURCE = _CSRC / "admm_chunk.cu"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib = None
build_info: dict = {}

# rows a chunk kernel takes on the card: three slots of 32 lanes
MAX_ROWS = 96


def check_rows(rows: int, what: str) -> None:
    """Raise `ValueError` unless ``rows`` (k constrained rows, or n on
    the full layout) fits the CUDA kernels' row slots."""
    if not 1 <= rows <= MAX_ROWS:
        raise ValueError(
            f"{what}={rows}: the CUDA chunk kernels take 1 to {MAX_ROWS} "
            f"rows ({MAX_ROWS // 32} slots of 32 lanes)")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(cuda_home) / "bin" / "nvcc"
    return str(path) if path.exists() else "nvcc"


def build_library(source: pathlib.Path, flags=NVCC_FLAGS):
    """Compile the CUDA source ``source`` with ``flags`` into a shared
    library in ``_build/``, once per source content and flags (a later
    call finds it there). Returns ``(path, compiler log, seconds)``; the
    log is kept beside the library, so a cached build reports it too."""
    src = source.read_bytes()
    tag = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:12]
    so = _BUILD / f"lib{source.stem}_{tag}.so"
    log = so.with_suffix(".log")
    t0 = time.perf_counter()
    if not (so.exists() and log.exists()):
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *flags, "-o", str(tmp), str(source)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stderr}"
            )
        tmp_log = so.with_suffix(f".{os.getpid()}.log.tmp")
        tmp_log.write_text(proc.stderr)
        os.replace(tmp_log, log)
        os.replace(tmp, so)
    return so, log.read_text(), time.perf_counter() - t0


def build_kernels() -> ctypes.CDLL:
    """Compile `csrc/admm_chunk.cu` (`build_library`) and load it.
    Records the compile seconds, the compiler's log and its
    register/spill report per instantiation in `build_info`."""
    global _lib
    if _lib is not None:
        return _lib
    so, log, seconds = build_library(_SOURCE)
    build_info["seconds"] = seconds
    build_info["library"] = str(so)
    build_info["log"] = log
    build_info["ptxas"] = ptxas_report(log)
    lib = ctypes.CDLL(str(so))
    common = [ctypes.c_void_p]
    i = ctypes.c_int
    for name, real, n_int in (
            ("admm_chunk_f64", ctypes.c_double, 6),
            ("admm_chunk_f32", ctypes.c_float, 5),
            ("admm_chunk_full_f64", ctypes.c_double, 7),
            ("admm_chunk_full_f32", ctypes.c_float, 7)):
        fn = getattr(lib, name)
        # ptrs, eps_b, eps_f, alpha, the integer arguments, stream
        fn.argtypes = common + [real] * 3 + [i] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.admm_chunk_blocks_per_sm.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.admm_chunk_blocks_per_sm.restype = ctypes.c_int
    _lib = lib
    return lib


def ptxas_report(log: str) -> dict:
    """``{kernel instantiation: (registers, stack frame bytes, spill
    store bytes, spill load bytes)}`` from an ``nvcc -Xptxas -v`` log,
    named as in the source (``admm_chunk_warp<double, 3, false>``,
    ``admm_chunk_full_warp<float, 2>``)."""
    out, name = {}, None
    word = {"i": lambda v: v, "b": lambda v: "true" if v == "1" else "false"}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(
                r"(admm_chunk_(?:full_)?warp)I([df]?)((?:L[ib]\d+E)+)",
                m.group(1))
            name = m.group(1) if k is None else (
                f"{k.group(1)}<"
                + {"d": "double, ", "f": "float, ", "": ""}[k.group(2)]
                + ", ".join(word[t](v) for t, v in
                            re.findall(r"L([ib])(\d+)E", k.group(3)))
                + ">")
            out[name] = [0, 0, 0, 0]
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            out[name][1:] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def blocks_per_sm(kernel: str, rows: int) -> int:
    """Resident blocks per SM of ``kernel`` (a name in `KERNELS`) at
    ``rows`` rows, from the CUDA occupancy calculator. A block holds four
    instances; one (reduced kernels) above 64 rows, two (full layout)
    where four operators do not fit in shared memory (f64 above 80
    rows)."""
    names = [fn.__name__ for fn in KERNELS]
    out = ctypes.c_int(0)
    err = build_kernels().admm_chunk_blocks_per_sm(
        names.index(kernel), rows, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA error {err} in the occupancy query")
    return out.value


# --------------------------------------------------------------------------
# plain PyTorch versions
# --------------------------------------------------------------------------


def _relax(alpha, dt):
    """``(alpha, 1 - alpha)`` as 0-d tensors of ``dt``, the second
    computed in ``dt`` as the kernels compute it; None at alpha == 1."""
    if alpha == 1.0:
        return None
    al = torch.tensor(alpha, dtype=dt)
    return al, 1 - al


def _chunk_plain(
    Fj, x_const, lb, ub, mu_f, rho, eps_bound, eps_fcone,
    x, s, mu, v, done, n_iter, itv, xrn, lrn, prim, dual,
    kb, K, max_iter, weights, inc_gate, alpha,
):
    """Up to K masked ADMM iterations in the dtype of the state."""
    k = x.shape[0]
    nc = k - kb
    dt = x.dtype
    eps_b = torch.tensor(eps_bound, dtype=dt)
    eps_f = torch.tensor(eps_fcone, dtype=dt)
    relax = _relax(alpha, dt)
    wk = weights
    zeros_b = torch.zeros_like(rho)
    done = done.clone()
    for _ in range(K):
        active = ~done & (itv < max_iter)
        if not bool(active.any()):
            break
        s_prev = s
        v_new = s_prev - mu
        y = Fj[0] * v_new[0]
        for j in range(1, k):
            y = y + Fj[j] * v_new[j]
        xn = x_const + rho * y
        xh = xn if relax is None else relax[0] * xn + relax[1] * s_prev
        t = xh + mu
        parts = []
        if kb:
            parts.append(torch.clamp(t[:kb], lb, ub))
        if nc:
            parts.append(project_cone_ds(t[kb:], mu_f))
        s_new = parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
        res = xn - s_new
        mu_new = mu + (xh - s_new)
        wres = res.abs() * wk
        n_xrn = wres[:kb].amax(dim=0) if kb else zeros_b
        n_lrn = wres[kb:].amax(dim=0) if nc else zeros_b
        dprim = res * wk
        dchange = (s_new - s_prev) * wk
        n_prim = sqrt_rn((dprim * dprim).sum(dim=0))
        n_dual = rho * sqrt_rn((dchange * dchange).sum(dim=0))
        conv = (n_lrn < eps_f) & (n_xrn < eps_b)
        if inc_gate:
            winc = (xn - x).abs() * wk
            if kb:
                conv = conv & (winc[:kb].amax(dim=0) < eps_b)
            if nc:
                conv = conv & (winc[kb:].amax(dim=0) < eps_f)
        a2 = active[None, :]
        x = torch.where(a2, xn, x)
        s = torch.where(a2, s_new, s)
        mu = torch.where(a2, mu_new, mu)
        v = torch.where(a2, v_new, v)
        xrn = torch.where(active, n_xrn, xrn)
        lrn = torch.where(active, n_lrn, lrn)
        prim = torch.where(active, n_prim, prim)
        dual = torch.where(active, n_dual, dual)
        n_iter = torch.where(conv & active, itv, n_iter)
        itv = torch.where(active, itv + 1, itv)
        done = done | (conv & active)
    return x, s, mu, v, done, n_iter, itv, xrn, lrn, prim, dual


def admm_chunk_f64_plain(
    Fj, x_const, lb, ub, mu_f, rho, eps_bound, eps_fcone,
    x, s, mu, v, done, n_iter, itv, xrn, lrn, prim, dual,
    *, kb, K, max_iter, weights, inc_gate=False, alpha=1.0,
):
    """Plain PyTorch version of `admm_chunk_f64` (same arguments and
    results)."""
    return _chunk_plain(
        Fj, x_const, lb, ub, mu_f, rho, eps_bound, eps_fcone,
        x, s, mu, v, done, n_iter, itv, xrn, lrn, prim, dual,
        kb, K, max_iter, weights, inc_gate, alpha,
    )


def admm_chunk_f32_plain(
    Fj, x_const, lb, ub, mu_f, rho, eps_bound, eps_fcone,
    x, s, mu, v, done, n_iter, itv, xrn, lrn, prim, dual,
    *, kb, K, max_iter, weights, alpha=1.0,
):
    """Plain PyTorch version of `admm_chunk_f32` (same arguments and
    results)."""
    return _chunk_plain(
        Fj, x_const, lb, ub, mu_f, rho, eps_bound, eps_fcone,
        x, s, mu, v, done, n_iter, itv, xrn, lrn, prim, dual,
        kb, K, max_iter, weights, False, alpha,
    )


# the primal-increment gate of `admm_chunk_full_f64`: off (exact presolve),
# the ds engine's (non-cone rows against eps_bound, the cone segment
# against eps_fcone) or the f64 parity engine's (all rows against
# eps_bound, the segment against eps_fcone)
GATE_OFF, GATE_SPLIT, GATE_ALL = 0, 1, 2


def admm_chunk_full_f64_plain(
    Fj, x_const, lb, ub, mu_f, rho, eps_bound, eps_fcone,
    x, x_bar, lam_bar, mu_x, mu_lam, v, done, n_iter, itv,
    xrn, lrn, prim, dual, *, ls, K, max_iter, gate=GATE_OFF, alpha=1.0,
):
    """Plain PyTorch version of `admm_chunk_full_f64` and, on f32
    tensors, of `admm_chunk_full_f32` (same arguments and results)."""
    n, nc = x.shape[0], lam_bar.shape[0]
    dt = x.dtype
    relax = _relax(alpha, dt)
    seg = slice(ls, ls + nc)
    other = torch.tensor([r for r in range(n) if not ls <= r < ls + nc],
                         dtype=torch.long, device=x.device)
    eps_b = torch.tensor(eps_bound, dtype=dt)
    eps_f = torch.tensor(eps_fcone, dtype=dt)
    zeros_b = torch.zeros_like(rho)
    done = done.clone()

    def with_seg(a, s):
        return torch.cat([a[:ls], s, a[ls + nc:]], dim=0) if nc else a

    for _ in range(K):
        active = ~done & (itv < max_iter)
        if not bool(active.any()):
            break
        s_prev = with_seg(x_bar, lam_bar)
        v_new = s_prev - with_seg(mu_x, mu_lam)
        y = Fj[0] * v_new[0]
        for j in range(1, n):
            y = y + Fj[j] * v_new[j]
        xn = x_const + rho * y
        xh = xn if relax is None else relax[0] * xn + relax[1] * s_prev
        xb_new = torch.clamp(xh + mu_x, lb, ub)
        r_x = xn - xb_new
        n_xrn = r_x.abs().amax(dim=0)
        if nc:
            lam_new = project_cone_ds(xh[seg] + mu_lam, mu_f)
            r_l = xn[seg] - lam_new
            n_lrn = r_l.abs().amax(dim=0)
            mul_new = mu_lam + (xh[seg] - lam_new)
        else:
            lam_new, mul_new, n_lrn = lam_bar, mu_lam, zeros_b
        s_now = with_seg(xb_new, lam_new)
        dprim = xn - s_now
        dchange = s_now - s_prev
        n_prim = sqrt_rn((dprim * dprim).sum(dim=0))
        n_dual = rho * sqrt_rn((dchange * dchange).sum(dim=0))
        conv = (n_lrn < eps_f) & (n_xrn < eps_b)
        if gate != GATE_OFF:
            dx = (xn - x).abs()
            if gate == GATE_ALL:
                conv = conv & (dx.amax(dim=0) < eps_b)
            elif len(other):
                conv = conv & (dx[other].amax(dim=0) < eps_b)
            if nc:
                conv = conv & (dx[seg].amax(dim=0) < eps_f)
        a2 = active[None, :]
        x = torch.where(a2, xn, x)
        x_bar = torch.where(a2, xb_new, x_bar)
        lam_bar = torch.where(a2, lam_new, lam_bar)
        mu_x = torch.where(a2, mu_x + (xh - xb_new), mu_x)
        mu_lam = torch.where(a2, mul_new, mu_lam)
        v = torch.where(a2, v_new, v)
        xrn = torch.where(active, n_xrn, xrn)
        lrn = torch.where(active, n_lrn, lrn)
        prim = torch.where(active, n_prim, prim)
        dual = torch.where(active, n_dual, dual)
        n_iter = torch.where(conv & active, itv, n_iter)
        itv = torch.where(active, itv + 1, itv)
        done = done | (conv & active)
    return (x, x_bar, lam_bar, mu_x, mu_lam, v, done, n_iter, itv,
            xrn, lrn, prim, dual)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------


def _check(name, t, shape, dtype, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _launch(fn_name, dtype, args, kb, K, max_iter, inc_gate, alpha):
    (Fj, x_const, lb, ub, mu_f, rho, eps_bound, eps_fcone,
     x, s, mu, v, done, n_iter, itv, xrn, lrn, prim, dual, weights) = args
    k, B = x.shape
    nc = k - kb
    check_rows(k, "k")
    if not (0 <= kb <= k and nc % 3 == 0):
        raise ValueError(f"unsupported split k={k}, kb={kb}")
    dev = x.device
    i32 = torch.int32
    done_i = done.to(i32).contiguous()
    # kernels index the cone and box arrays from their own base pointers;
    # give empty segments a valid one-element buffer
    lb_ = lb if kb else torch.zeros((1, B), dtype=dtype, device=dev)
    ub_ = ub if kb else torch.zeros((1, B), dtype=dtype, device=dev)
    mf_ = mu_f if nc else torch.zeros((1, B), dtype=dtype, device=dev)
    specs = [
        ("Fj", Fj, (k, k, B), dtype), ("x_const", x_const, (k, B), dtype),
        ("lb", lb_, (max(kb, 1), B), dtype),
        ("ub", ub_, (max(kb, 1), B), dtype),
        ("mu_f", mf_, (max(nc // 3, 1), B), dtype),
        ("weights", weights, (k, B), dtype), ("rho", rho, (B,), dtype),
        ("x", x, (k, B), dtype), ("s", s, (k, B), dtype),
        ("mu", mu, (k, B), dtype), ("v", v, (k, B), dtype),
        ("done", done_i, (B,), i32), ("n_iter", n_iter, (B,), i32),
        ("itv", itv, (B,), i32), ("xrn", xrn, (B,), dtype),
        ("lrn", lrn, (B,), dtype), ("prim", prim, (B,), dtype),
        ("dual", dual, (B,), dtype),
    ]
    for name, t, shp, dt in specs:
        _check(name, t, shp, dt, dev)
    outs = [
        torch.empty((k, B), dtype=dtype, device=dev) for _ in range(4)
    ] + [
        torch.empty((B,), dtype=i32, device=dev) for _ in range(3)
    ] + [
        torch.empty((B,), dtype=dtype, device=dev) for _ in range(4)
    ]
    ptrs = (ctypes.c_void_p * 29)(
        *[t.data_ptr() for _, t, _, _ in specs],
        *[t.data_ptr() for t in outs],
    )
    lib = build_kernels()
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    if fn_name == "admm_chunk_f64":
        err = lib.admm_chunk_f64(
            ptrs, float(eps_bound), float(eps_fcone), float(alpha), B, k,
            kb, K, max_iter, int(bool(inc_gate)), stream,
        )
    else:
        err = lib.admm_chunk_f32(
            ptrs, float(eps_bound), float(eps_fcone), float(alpha), B, k,
            kb, K, max_iter, stream,
        )
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err} at launch")
    xo, so_, muo, vo, doneo, nio, itvo, xrno, lrno, primo, dualo = outs
    return xo, so_, muo, vo, doneo != 0, nio, itvo, xrno, lrno, primo, dualo


def admm_chunk_f64(
    Fj, x_const, lb, ub, mu_f, rho, eps_bound, eps_fcone,
    x, s, mu, v, done, n_iter, itv, xrn, lrn, prim, dual,
    *, kb, K, max_iter, weights, inc_gate=False, alpha=1.0,
):
    """Run up to K fused f64 ADMM iterations per instance (the endgame
    chunk, replacing `fcc_qp_tpu.ops.pallas_admm.admm_chunk_pallas`).

    All arrays batch-last: Fj (k, k, B) j-major operator, x_const / x /
    s / mu / v / weights (k, B), lb / ub (kb, B) box bounds, mu_f
    (nc/3, B), rho (B,), all f64; done (B,) bool; n_iter / itv (B,)
    int32; xrn / lrn / prim / dual (B,) f64 residuals carried for idle
    instances. ``itv`` counts iterations per instance across chunks and
    phases; n_iter records it at the converging iteration. ``alpha``: the
    over-relaxation (1: none).

    Returns ``(x, s, mu, v, done, n_iter, itv, xrn, lrn, prim, dual)``.
    CPU tensors take `admm_chunk_f64_plain`; CUDA tensors launch the
    kernel (counted in ``admm_chunk_f64.launches``) or raise.
    """
    if x.device.type == "cpu":
        return admm_chunk_f64_plain(
            Fj, x_const, lb, ub, mu_f, rho, eps_bound, eps_fcone,
            x, s, mu, v, done, n_iter, itv, xrn, lrn, prim, dual,
            kb=kb, K=K, max_iter=max_iter, weights=weights,
            inc_gate=inc_gate, alpha=alpha,
        )
    out = _launch(
        "admm_chunk_f64", torch.float64,
        (Fj, x_const, lb, ub, mu_f, rho, eps_bound, eps_fcone,
         x, s, mu, v, done, n_iter, itv, xrn, lrn, prim, dual, weights),
        kb, K, max_iter, inc_gate, alpha,
    )
    admm_chunk_f64.launches += 1
    return out


def admm_chunk_f32(
    Fj, x_const, lb, ub, mu_f, rho, eps_bound, eps_fcone,
    x, s, mu, v, done, n_iter, itv, xrn, lrn, prim, dual,
    *, kb, K, max_iter, weights, alpha=1.0,
):
    """Run up to K fused plain-f32 ADMM iterations per instance (the
    approach-phase chunk, replacing
    `fcc_qp_tpu.ops.pallas_admm.admm_chunk_pallas32`). Same arguments
    and results as `admm_chunk_f64` with f32 in place of f64 and no
    increment gate; the convergence test reads ``eps_bound`` /
    ``eps_fcone`` (the engine passes its coarse switch tolerance).
    Launches are counted in ``admm_chunk_f32.launches``."""
    if x.device.type == "cpu":
        return admm_chunk_f32_plain(
            Fj, x_const, lb, ub, mu_f, rho, eps_bound, eps_fcone,
            x, s, mu, v, done, n_iter, itv, xrn, lrn, prim, dual,
            kb=kb, K=K, max_iter=max_iter, weights=weights, alpha=alpha,
        )
    out = _launch(
        "admm_chunk_f32", torch.float32,
        (Fj, x_const, lb, ub, mu_f, rho, eps_bound, eps_fcone,
         x, s, mu, v, done, n_iter, itv, xrn, lrn, prim, dual, weights),
        kb, K, max_iter, False, alpha,
    )
    admm_chunk_f32.launches += 1
    return out


def _launch_full(fn_name, dtype, args, ls, K, max_iter, gate, alpha):
    (Fj, x_const, lb, ub, mu_f, rho, eps_bound, eps_fcone,
     x, x_bar, lam_bar, mu_x, mu_lam, v, done, n_iter, itv,
     xrn, lrn, prim, dual) = args
    n, B = x.shape
    nc = lam_bar.shape[0]
    check_rows(n, "n")
    if not (nc % 3 == 0 and 0 <= ls and ls + nc <= n
            and gate in (GATE_OFF, GATE_SPLIT, GATE_ALL)):
        raise ValueError(
            f"unsupported layout n={n}, nc={nc}, ls={ls}, gate={gate}")
    dev = x.device
    i32 = torch.int32
    done_i = done.to(i32).contiguous()
    # the kernel indexes the cone arrays from their own base pointers;
    # give an empty segment a valid one-row buffer
    pad = lambda a: a if nc else torch.zeros((1, B), dtype=dtype, device=dev)
    ncr = max(nc, 1)
    specs = [
        ("Fj", Fj, (n, n, B), dtype), ("x_const", x_const, (n, B), dtype),
        ("lb", lb, (n, B), dtype), ("ub", ub, (n, B), dtype),
        ("mu_f", pad(mu_f), (max(nc // 3, 1), B), dtype),
        ("rho", rho, (B,), dtype),
        ("x", x, (n, B), dtype), ("x_bar", x_bar, (n, B), dtype),
        ("lam_bar", pad(lam_bar), (ncr, B), dtype),
        ("mu_x", mu_x, (n, B), dtype),
        ("mu_lam", pad(mu_lam), (ncr, B), dtype),
        ("v", v, (n, B), dtype),
        ("done", done_i, (B,), i32), ("n_iter", n_iter, (B,), i32),
        ("itv", itv, (B,), i32), ("xrn", xrn, (B,), dtype),
        ("lrn", lrn, (B,), dtype), ("prim", prim, (B,), dtype),
        ("dual", dual, (B,), dtype),
    ]
    for name, t, shp, dt in specs:
        _check(name, t, shp, dt, dev)
    rows = (n, n, ncr, n, ncr, n)
    outs = ([torch.empty((r, B), dtype=dtype, device=dev) for r in rows]
            + [torch.empty((B,), dtype=i32, device=dev) for _ in range(3)]
            + [torch.empty((B,), dtype=dtype, device=dev) for _ in range(4)])
    ptrs = (ctypes.c_void_p * 32)(
        *[t.data_ptr() for _, t, _, _ in specs],
        *[t.data_ptr() for t in outs],
    )
    lib = build_kernels()
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    err = getattr(lib, fn_name)(
        ptrs, float(eps_bound), float(eps_fcone), float(alpha), B, n, nc, ls,
        K, max_iter, int(gate), stream,
    )
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err} at launch")
    xo, xbo, lamo, muxo, mulo, vo, doneo, nio, itvo, *res = outs
    return (xo, xbo, lamo[:nc], muxo, mulo[:nc], vo, doneo != 0, nio, itvo,
            *res)


def admm_chunk_full_f64(
    Fj, x_const, lb, ub, mu_f, rho, eps_bound, eps_fcone,
    x, x_bar, lam_bar, mu_x, mu_lam, v, done, n_iter, itv,
    xrn, lrn, prim, dual, *, ls, K, max_iter, gate=GATE_OFF, alpha=1.0,
):
    """Run up to K fused f64 ADMM iterations per instance in the full
    layout (`fcc_qp_tpu.ops.pallas_admm.admm_chunk_pallas` as the
    full-splitting engine calls it, unit weights).

    All arrays batch-last, f64 unless noted: Fj (n, n, B) j-major
    operator; x_const, lb, ub (n, B), lb / ub possibly infinite; mu_f
    (nc/3, B); rho (B,); the state x, x_bar, mu_x, v (n, B) and lam_bar,
    mu_lam (nc, B), the cone segment at rows ``[ls, ls + nc)``; done (B,)
    bool; n_iter / itv (B,) int32; xrn / lrn / prim / dual (B,) carried
    for idle instances. ``gate``: `GATE_OFF`, `GATE_SPLIT` or `GATE_ALL`.
    ``alpha``: the over-relaxation (1: none). n <= `MAX_ROWS`; nc = 0 is
    allowed.

    Returns ``(x, x_bar, lam_bar, mu_x, mu_lam, v, done, n_iter, itv,
    xrn, lrn, prim, dual)``. CPU tensors take
    `admm_chunk_full_f64_plain`; CUDA tensors launch the kernel (counted
    in ``admm_chunk_full_f64.launches``) or raise.
    """
    args = (Fj, x_const, lb, ub, mu_f, rho, eps_bound, eps_fcone,
            x, x_bar, lam_bar, mu_x, mu_lam, v, done, n_iter, itv,
            xrn, lrn, prim, dual)
    if x.device.type == "cpu":
        return admm_chunk_full_f64_plain(*args, ls=ls, K=K, max_iter=max_iter,
                                         gate=gate, alpha=alpha)
    out = _launch_full("admm_chunk_full_f64", torch.float64, args, ls, K,
                       max_iter, gate, alpha)
    admm_chunk_full_f64.launches += 1
    return out


# the plain version of `admm_chunk_full_f32`: the same iteration, in the
# dtype of its (f32) inputs
admm_chunk_full_f32_plain = admm_chunk_full_f64_plain


def admm_chunk_full_f32(
    Fj, x_const, lb, ub, mu_f, rho, eps_bound, eps_fcone,
    x, x_bar, lam_bar, mu_x, mu_lam, v, done, n_iter, itv,
    xrn, lrn, prim, dual, *, ls, K, max_iter, gate=GATE_OFF, alpha=1.0,
):
    """`admm_chunk_full_f64` in f32: every floating-point argument and
    result f32 (the f64 parity engine on f32 data, as the JAX package's
    solver computes in the data's dtype). CPU tensors take
    `admm_chunk_full_f32_plain`; CUDA tensors launch the kernel (counted
    in ``admm_chunk_full_f32.launches``) or raise."""
    args = (Fj, x_const, lb, ub, mu_f, rho, eps_bound, eps_fcone,
            x, x_bar, lam_bar, mu_x, mu_lam, v, done, n_iter, itv,
            xrn, lrn, prim, dual)
    if x.device.type == "cpu":
        return admm_chunk_full_f32_plain(*args, ls=ls, K=K, max_iter=max_iter,
                                         gate=gate, alpha=alpha)
    out = _launch_full("admm_chunk_full_f32", torch.float32, args, ls, K,
                       max_iter, gate, alpha)
    admm_chunk_full_f32.launches += 1
    return out


admm_chunk_f64.launches = 0
admm_chunk_f32.launches = 0
admm_chunk_full_f64.launches = 0
admm_chunk_full_f32.launches = 0

# in the order of the library's kernel numbers (admm_chunk_blocks_per_sm)
KERNELS = (admm_chunk_f64, admm_chunk_f32, admm_chunk_full_f64,
           admm_chunk_full_f32)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
