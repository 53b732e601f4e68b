// Fused ADMM iteration chunks of the reduced FCCQP engine, for Hopper
// (sm_90a). Two precisions share one template, each in two row layouts
// (NR = 1 for k <= 32 constrained rows, NR = 2 for 32 < k <= 64):
//
//   admm_chunk_f64  replaces fcc_qp_tpu/ops/pallas_admm.py::admm_chunk_pallas
//                   (Pallas body `_kernel`), which runs the endgame in
//                   double-single because the TPU has no f64 ALU; here it
//                   is native f64, with the primal-increment gate.
//   admm_chunk_f32  replaces fcc_qp_tpu/ops/pallas_admm.py::admm_chunk_pallas32
//                   (Pallas body `_kernel32`), the plain-f32 approach phase
//                   and the polish rounds' short chunks.
//
// A third kernel, admm_chunk_full_f64 (below the first two), is
// admm_chunk_pallas in the general layout of the full-splitting engine
// and the f64 parity engine: all n variables, the cone segment wherever
// it sits, box and cone duals apart.
//
// One iteration, per instance b (k constrained coordinates: kb box rows,
// then nc = 3 * ncones cone rows; every array is batch-last, [row][b]):
//   v      = s - mu
//   x      = x_const + rho * (F^T v)       F j-major: y[i] = sum_j F[j][i] v[j]
//   s_new  = [clip(x + mu)_box ; Pi_cone(x + mu)_cone]
//   r      = x - s_new ;  mu += r
//   xrn / lrn = max |r| * w over box / cone rows (unscaled units)
//   prim   = ||r * w||_2 ; dual = rho * ||(s_new - s) * w||_2
//   conv   = lrn < eps_fcone && xrn < eps_bound
//            (f64 with gate: && max |x - x_prev| * w below eps per segment)
// An instance runs until it converges, reaches max_iter, or the chunk's K
// iterations are spent. Residual norms of an instance that does no
// iteration in this chunk are carried through unchanged (the XLA chunk
// bodies' semantics; the Pallas kernels zero them per chunk).
//
// Bound, per launch (what these inputs need: each input read once, each
// output written once; (2k^2 + 16k + 12 ncones) flops per
// instance-iteration actually run):
//   * all instances active (the first approach chunk, B = 8192, K = 64,
//     Cassie k = 22): about 0.021 ms f64 / 0.010 ms f32, bound by
//     operations against the FP64 / FP32 FMA peaks (34 / 67 TFLOP/s);
//   * straggler chunks (most launches of a solve: a few dozen to a few
//     hundred active instances, up to K = 64 iterations each): bound by
//     bytes, mostly the state in and out of every instance (~2 * (4k + 7)
//     * B words), 0.0037 ms f64 / 0.0020 ms f32 on the bench path's last
//     chunks. The work itself is a chain of up to K dependent iterations
//     per instance, so a straggler chunk is set by per-iteration latency
//     (and the launch's fixed cost), not by any rate.
// The times measured beside these bounds are in PERF.md.
// With contraction off (--fmad=false, below) every multiply-add issues as
// two instructions, so the attainable f32 / f64 rate is half the FMA peak
// the bound divides by; the bound's definition is kept as it is.
//
// Design: one warp per instance, lane i owns constrained row i (and row
// i + 32 when NR = 2). This turns the k x k mat-vec of one thread into k
// dot products of length k run side by side; an iteration's latency is
// about k dependent adds, a few shuffles and one cone projection.
//   * The operator is read once per chunk, not once per iteration. NR = 1:
//     lane i holds column F[:, i] (k values) in registers, loaded with
//     compile-time indices (loops unrolled to 32, predicated on j < k);
//     the mat-vec runs in groups of 8 columns, so a group's shuffles
//     issue together, and pads the last group with exact no-op adds.
//     NR = 2: the warp's k x k operator sits in dynamic shared memory.
//     Loads are strided (one instance's F[j][i] are B elements apart), so
//     each value moves as one 32-byte sector: 4x the operator's bytes in
//     f64 and 8x in f32 from L2, once per chunk and only for instances
//     that iterate (neighbouring warps hit the same sectors in L2).
//   * State in registers: x, s, mu, v and the per-row constants of a
//     lane's rows are scalars (arrays only over the compile-time NR).
//   * Same arithmetic in the same order as the plain version, so the
//     kernel rounds exactly like it: v[j] is broadcast with __shfl_sync
//     and y[i] accumulated over j ascending; a cone's three lanes fetch
//     (fx, fy, fz) by shuffle and each computes the same projection.
//   * The convergence test is a warp vote (__all_sync) on each row's
//     |r| * w < eps: with w >= 0 it equals max(...) < eps exactly. The
//     reported xrn / lrn (warp max reductions) and the 2-norms prim / dual
//     (summed in row order, broadcast by shuffle) are formed only at the
//     instance's last iteration in the chunk; nothing else reads them.
//   * The exit is warp-uniform: the warp leaves its loop together.
//   * The whole card at full batch: B warps in blocks of kWarps, so
//     B = 8192 fills every SM. The warp of an instance that does not
//     iterate copies its state through to the separate outputs.
// No contraction of mul+add into FMA (the library is built with
// --fmad=false): the kernel then rounds exactly like the plain PyTorch
// version in fcc_qp_tpu_torch/ops/pallas_admm.py, which is what the
// on-card check holds it to.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int KMAX = 64;
constexpr int kWarps = 4;  // instances (warps) per block
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct ChunkArgs {
  const T* F;        // (k, k, B) j-major operator
  const T* xc;       // (k, B) constant term
  const T* lb;       // (kb, B) box bounds
  const T* ub;       // (kb, B)
  const T* muf;      // (nc/3, B) effective friction coefficients
  const T* w;        // (k, B) residual weights
  const T* rho;      // (B,)
  const T* x_in;     // (k, B) state in
  const T* s_in;
  const T* mu_in;
  const T* v_in;
  const int* done_in;   // (B,)
  const int* niter_in;
  const int* itv_in;
  const T* xrn_in;      // (B,) residuals in (kept for idle instances)
  const T* lrn_in;
  const T* prim_in;
  const T* dual_in;
  T* x_out;
  T* s_out;
  T* mu_out;
  T* v_out;
  int* done_out;
  int* niter_out;
  int* itv_out;
  T* xrn_out;
  T* lrn_out;
  T* prim_out;
  T* dual_out;
  T eps_b;
  T eps_f;
  int B;
  int k;
  int kb;
  int K;
  int max_iter;
  int inc_gate;
};

template <typename T>
__device__ __forceinline__ T tmax(T a, T b) { return a > b ? a : b; }
template <typename T>
__device__ __forceinline__ T tabs(T a) { return a < T(0) ? -a : a; }
// jnp.clip / torch.clamp order: min(max(t, lo), hi)
template <typename T>
__device__ __forceinline__ T tclip(T t, T lo, T hi) {
  const T u = t < lo ? lo : t;
  return u > hi ? hi : u;
}

template <typename T>
__device__ __forceinline__ T tsqrt(T a);
template <>
__device__ __forceinline__ float tsqrt<float>(float a) { return sqrtf(a); }
template <>
__device__ __forceinline__ double tsqrt<double>(double a) { return sqrt(a); }

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = tmax(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// The value a[.] that the warp holds for constrained row `row` (row r
// lives in slot r / 32 of lane r % 32). Every lane must call it.
template <int NR, typename T>
__device__ __forceinline__ T from_row(const T (&a)[NR], int row) {
  T v = __shfl_sync(kFull, a[0], row & 31);
  if constexpr (NR == 2) {
    const T v1 = __shfl_sync(kFull, a[1], row & 31);
    if (row >= 32) v = v1;
  }
  return v;
}

template <typename T, int NR>
__global__ void __launch_bounds__(kWarps * 32)
    admm_chunk_warp(ChunkArgs<T> a) {
  // NR == 2: each warp's k x k operator, [j][i]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= a.B) return;  // warp-uniform
  const int B = a.B, k = a.k, kb = a.kb;
  const int done_in = a.done_in[b];
  const int itv_in = a.itv_in[b];

  // the state: iterated below, or copied through by an idle warp
  int row[NR];
  bool valid[NR];
  T x[NR], s[NR], mu[NR], v[NR];
#pragma unroll
  for (int q = 0; q < NR; ++q) {
    row[q] = lane + 32 * q;
    valid[q] = row[q] < k;
    const size_t o = (size_t)row[q] * B + b;
    x[q] = valid[q] ? a.x_in[o] : T(0);
    s[q] = valid[q] ? a.s_in[o] : T(0);
    mu[q] = valid[q] ? a.mu_in[o] : T(0);
    v[q] = valid[q] ? a.v_in[o] : T(0);
  }

  if (done_in != 0 || itv_in >= a.max_iter || a.K < 1) {
    // no iteration in this chunk: the state goes through unchanged
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      if (valid[q]) {
        const size_t o = (size_t)row[q] * B + b;
        a.x_out[o] = x[q];
        a.s_out[o] = s[q];
        a.mu_out[o] = mu[q];
        a.v_out[o] = v[q];
      }
    }
    if (lane == 0) {
      a.done_out[b] = done_in;
      a.niter_out[b] = a.niter_in[b];
      a.itv_out[b] = itv_in;
      a.xrn_out[b] = a.xrn_in[b];
      a.lrn_out[b] = a.lrn_in[b];
      a.prim_out[b] = a.prim_in[b];
      a.dual_out[b] = a.dual_in[b];
    }
    return;
  }

  const T rho = a.rho[b];
  // per-row constants; a cone row c0 + pos (pos = 0, 1, 2 for fx, fy,
  // fz) keeps its cone's first row c0 and friction coefficient in lo
  bool box[NR];
  int c0[NR], pos[NR];
  T xc[NR], w[NR], lo[NR], hi[NR];
#pragma unroll
  for (int q = 0; q < NR; ++q) {
    const int r = row[q];
    const size_t o = (size_t)r * B + b;
    box[q] = r < kb;
    xc[q] = valid[q] ? a.xc[o] : T(0);
    w[q] = valid[q] ? a.w[o] : T(0);
    lo[q] = T(0);
    hi[q] = T(0);
    c0[q] = r;
    pos[q] = 0;
    if (box[q]) {
      lo[q] = a.lb[o];
      hi[q] = a.ub[o];
    } else if (valid[q]) {
      const int c = (r - kb) / 3;
      c0[q] = kb + 3 * c;
      pos[q] = r - c0[q];
      lo[q] = a.muf[(size_t)c * B + b];
    }
  }

  // the operator, read once for the chunk
  T col[NR == 1 ? 32 : 1];
  T* Fs = reinterpret_cast<T*>(smem_raw) + (size_t)warp * k * k;
  if constexpr (NR == 1) {
#pragma unroll
    for (int j = 0; j < 32; ++j)
      col[j] = (j < k && lane < k) ? a.F[((size_t)j * k + lane) * B + b]
                                   : T(0);
  } else {
    for (int e = lane; e < k * k; e += 32) Fs[e] = a.F[(size_t)e * B + b];
    __syncwarp();
  }
  // NR == 2: shared-memory column offsets, clamped for rows >= k
  int fo[NR];
#pragma unroll
  for (int q = 0; q < NR; ++q) fo[q] = valid[q] ? row[q] : 0;

  int niter = a.niter_in[b];
  int itv = itv_in;
  int done = 0;
  for (int it = 0; it < a.K; ++it) {
    T vn[NR], y[NR];
#pragma unroll
    for (int q = 0; q < NR; ++q) vn[q] = s[q] - mu[q];

    // y = F^T v, accumulated over j in ascending order
    if constexpr (NR == 1) {
      // in groups of 8 so that a group's shuffles issue together; a step
      // j >= k adds -0, which leaves every y (+0 and -0 included) as it is
      y[0] = col[0] * __shfl_sync(kFull, vn[0], 0);
#pragma unroll
      for (int j0 = 0; j0 < 32; j0 += 8) {
        if (j0 < k) {
#pragma unroll
          for (int j = (j0 == 0 ? 1 : j0); j < j0 + 8; ++j) {
            const T p = col[j] * __shfl_sync(kFull, vn[0], j);
            y[0] = y[0] + (j < k ? p : T(-0.0));
          }
        }
      }
    } else {
      const T v0 = __shfl_sync(kFull, vn[0], 0);
#pragma unroll
      for (int q = 0; q < NR; ++q) y[q] = Fs[fo[q]] * v0;
      const int k1 = k < 32 ? k : 32;
      for (int j = 1; j < k1; ++j) {
        const T vj = __shfl_sync(kFull, vn[0], j);
#pragma unroll
        for (int q = 0; q < NR; ++q) y[q] = y[q] + Fs[j * k + fo[q]] * vj;
      }
      for (int j = 32; j < k; ++j) {
        const T vj = __shfl_sync(kFull, vn[NR - 1], j - 32);
#pragma unroll
        for (int q = 0; q < NR; ++q) y[q] = y[q] + Fs[j * k + fo[q]] * vj;
      }
    }

    T xn[NR], t[NR];
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      xn[q] = xc[q] + rho * y[q];
      t[q] = xn[q] + mu[q];
    }

    // projections: box rows clip; the three lanes of a cone fetch
    // (fx, fy, fz) and each computes the cone's projection
    T sn[NR];
    bool ok = true;
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      const T fx = from_row<NR>(t, c0[q]);
      const T fy = from_row<NR>(t, c0[q] + 1);
      const T fz = from_row<NR>(t, c0[q] + 2);
      if (box[q]) {
        sn[q] = tclip(t[q], lo[q], hi[q]);
      } else {
        const T m = lo[q];
        const T norm = tsqrt<T>(fx * fx + fy * fy);
        const bool inside = m * fz - norm >= T(0);
        const bool polar = fz + m * norm < T(0);
        const T tt = (m * norm + fz) / (m * m + T(1));
        const T safe = norm > T(0) ? norm : T(1);
        const T sc = tt * m / safe;
        const T surf = pos[q] == 2 ? tt : sc * t[q];
        sn[q] = inside ? t[q] : (polar ? T(0) : surf);
      }
      if (valid[q]) {
        const T eps = box[q] ? a.eps_b : a.eps_f;
        ok = ok && tabs(xn[q] - sn[q]) * w[q] < eps;
        if (a.inc_gate) ok = ok && tabs(xn[q] - x[q]) * w[q] < eps;
      }
    }
    // max over a segment < eps  <=>  every row < eps (and eps > 0, for
    // an empty segment, whose max is 0)
    const bool conv =
        __all_sync(kFull, ok) && T(0) < a.eps_b && T(0) < a.eps_f;

    if (conv || it + 1 == a.K || itv + 1 >= a.max_iter) {
      // the instance's last iteration in this chunk: its residual norms
      T bx = T(0), cx = T(0), pq[NR], dq[NR];
#pragma unroll
      for (int q = 0; q < NR; ++q) {
        const T r = xn[q] - sn[q];
        const T wr = tabs(r) * w[q];
        if (valid[q]) {
          if (box[q])
            bx = tmax(bx, wr);
          else
            cx = tmax(cx, wr);
        }
        const T dp = r * w[q];
        const T dc = (sn[q] - s[q]) * w[q];
        pq[q] = valid[q] ? dp * dp : T(0);
        dq[q] = valid[q] ? dc * dc : T(0);
      }
      bx = warp_max(bx);
      cx = warp_max(cx);
      T pp = T(0), dd = T(0);
      for (int rr = 0; rr < k; ++rr) {
        pp = pp + from_row<NR>(pq, rr);
        dd = dd + from_row<NR>(dq, rr);
      }
      if (lane == 0) {
        a.xrn_out[b] = bx;
        a.lrn_out[b] = cx;
        a.prim_out[b] = tsqrt<T>(pp);
        a.dual_out[b] = rho * tsqrt<T>(dd);
      }
    }

#pragma unroll
    for (int q = 0; q < NR; ++q) {
      mu[q] = mu[q] + (xn[q] - sn[q]);
      x[q] = xn[q];
      s[q] = sn[q];
      v[q] = vn[q];
    }
    if (conv) {
      niter = itv;
      done = 1;
    }
    itv = itv + 1;
    if (done != 0 || itv >= a.max_iter) break;
  }

#pragma unroll
  for (int q = 0; q < NR; ++q) {
    if (valid[q]) {
      const size_t o = (size_t)row[q] * B + b;
      a.x_out[o] = x[q];
      a.s_out[o] = s[q];
      a.mu_out[o] = mu[q];
      a.v_out[o] = v[q];
    }
  }
  if (lane == 0) {
    a.done_out[b] = done;
    a.niter_out[b] = niter;
    a.itv_out[b] = itv;
  }
}

template <typename T, int NR>
int launch_rows(const ChunkArgs<T>& a, cudaStream_t stream) {
  const size_t smem = NR == 2 ? (size_t)kWarps * a.k * a.k * sizeof(T) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        admm_chunk_warp<T, NR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (a.B + kWarps - 1) / kWarps;
  admm_chunk_warp<T, NR><<<blocks, kWarps * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(void* const* p, T eps_b, T eps_f, int B, int k, int kb, int K,
           int max_iter, int inc_gate, void* stream) {
  if (k < 1 || k > KMAX || kb < 0 || kb > k || (k - kb) % 3 != 0 || B < 1)
    return (int)cudaErrorInvalidValue;
  ChunkArgs<T> a;
  a.F = (const T*)p[0];
  a.xc = (const T*)p[1];
  a.lb = (const T*)p[2];
  a.ub = (const T*)p[3];
  a.muf = (const T*)p[4];
  a.w = (const T*)p[5];
  a.rho = (const T*)p[6];
  a.x_in = (const T*)p[7];
  a.s_in = (const T*)p[8];
  a.mu_in = (const T*)p[9];
  a.v_in = (const T*)p[10];
  a.done_in = (const int*)p[11];
  a.niter_in = (const int*)p[12];
  a.itv_in = (const int*)p[13];
  a.xrn_in = (const T*)p[14];
  a.lrn_in = (const T*)p[15];
  a.prim_in = (const T*)p[16];
  a.dual_in = (const T*)p[17];
  a.x_out = (T*)p[18];
  a.s_out = (T*)p[19];
  a.mu_out = (T*)p[20];
  a.v_out = (T*)p[21];
  a.done_out = (int*)p[22];
  a.niter_out = (int*)p[23];
  a.itv_out = (int*)p[24];
  a.xrn_out = (T*)p[25];
  a.lrn_out = (T*)p[26];
  a.prim_out = (T*)p[27];
  a.dual_out = (T*)p[28];
  a.eps_b = eps_b;
  a.eps_f = eps_f;
  a.B = B;
  a.k = k;
  a.kb = kb;
  a.K = K;
  a.max_iter = max_iter;
  a.inc_gate = inc_gate;
  const cudaStream_t s = (cudaStream_t)stream;
  return k <= 32 ? launch_rows<T, 1>(a, s) : launch_rows<T, 2>(a, s);
}

// --------------------------------------------------------------------------
// admm_chunk_full_f64: the general (full-splitting) layout of
// fcc_qp_tpu/ops/pallas_admm.py::admm_chunk_pallas (Pallas body `_kernel`),
// the layout the full-splitting engine and the f64 parity engine call it in.
//
// One iteration, per instance b (n variables; the cone segment is rows
// [ls, ls + nc) wherever it sits; every array batch-last, [row][b]):
//   s_prev = x_bar with the segment replaced by lam_bar
//   v      = s_prev - (mu_x with the segment replaced by mu_lam)
//   x      = x_const + rho * (F^T v)
//   x_bar  = clip(x + mu_x, lb, ub)            on ALL n rows, cone rows too
//   lam_bar= Pi_cone(seg(x) + mu_lam)          the segment's own slack
//   r_x = x - x_bar (n rows), r_l = seg(x) - lam_bar (nc rows)
//   mu_x += r_x ; mu_lam += r_l                 the box and cone duals apart
//   xrn = max |r_x|, lrn = max |r_l| (unit weights: unscaled problems)
//   prim = ||x - s_now||_2, dual = rho ||s_now - s_prev||_2 (s_now likewise)
//   conv = lrn < eps_f && xrn < eps_b, and with the increment gate
//     gate 1 (ds engine):  max |dx| over the non-cone rows < eps_b and
//                          max |dx| over the segment < eps_f
//     gate 2 (f64 engine): max |dx| over all rows < eps_b and over the
//                          segment < eps_f
// Bound: as for admm_chunk_f64, with n in place of k; the operator is the
// full n x n (28.8 KB at Cassie's n = 60 in f64), so even an all-active
// chunk of 25 iterations is bound by bytes (the operators), a straggler
// chunk by the state's bytes. The times beside the bounds are in PERF.md.
//
// Design: that of the two kernels above, one warp per instance, lane i
// owns rows i and i + 32, the warp's operator in shared memory (read once
// per chunk), the state and the per-row constants in registers,
// convergence as a warp vote. One warp per block: at 28.8 KB of shared
// memory a block, seven blocks share an SM. A cone row keeps both slacks
// and both duals in the registers of the lane that owns the row; a cone
// triple may straddle the two slots (ls % 32 in {30, 31}), so each lane
// gathers its triple's three rows with from_row(), which reads any row
// from either slot.
// --------------------------------------------------------------------------

struct FullArgs {
  const double* F;      // (n, n, B) j-major operator
  const double* xc;     // (n, B)
  const double* lb;     // (n, B)
  const double* ub;
  const double* muf;    // (max(nc/3, 1), B)
  const double* rho;    // (B,)
  const double* x_in;   // (n, B)
  const double* xb_in;  // (n, B)
  const double* lam_in; // (max(nc, 1), B)
  const double* mux_in; // (n, B)
  const double* mul_in; // (max(nc, 1), B)
  const double* v_in;   // (n, B)
  const int* done_in;   // (B,)
  const int* niter_in;
  const int* itv_in;
  const double* xrn_in;
  const double* lrn_in;
  const double* prim_in;
  const double* dual_in;
  double* x_out;
  double* xb_out;
  double* lam_out;
  double* mux_out;
  double* mul_out;
  double* v_out;
  int* done_out;
  int* niter_out;
  int* itv_out;
  double* xrn_out;
  double* lrn_out;
  double* prim_out;
  double* dual_out;
  double eps_b;
  double eps_f;
  int B;
  int n;
  int nc;
  int ls;
  int K;
  int max_iter;
  int gate;
};

template <int NR>
__global__ void __launch_bounds__(32) admm_chunk_full_warp(FullArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* Fs = reinterpret_cast<double*>(smem_raw);  // [j][i]
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const int B = a.B, n = a.n, nc = a.nc, ls = a.ls;
  const int done_in = a.done_in[b];
  const int itv_in = a.itv_in[b];

  // rows and the state: iterated below, or copied through by an idle warp
  int row[NR], cr[NR];
  bool valid[NR], cone[NR];
  double x[NR], xb[NR], mux[NR], v[NR], lam[NR], mul[NR];
#pragma unroll
  for (int q = 0; q < NR; ++q) {
    row[q] = lane + 32 * q;
    valid[q] = row[q] < n;
    cr[q] = row[q] - ls;
    cone[q] = valid[q] && cr[q] >= 0 && cr[q] < nc;
    const size_t o = (size_t)row[q] * B + b;
    const size_t oc = (size_t)(cone[q] ? cr[q] : 0) * B + b;
    x[q] = valid[q] ? a.x_in[o] : 0.0;
    xb[q] = valid[q] ? a.xb_in[o] : 0.0;
    mux[q] = valid[q] ? a.mux_in[o] : 0.0;
    v[q] = valid[q] ? a.v_in[o] : 0.0;
    lam[q] = cone[q] ? a.lam_in[oc] : 0.0;
    mul[q] = cone[q] ? a.mul_in[oc] : 0.0;
  }

  if (done_in != 0 || itv_in >= a.max_iter || a.K < 1) {
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      if (valid[q]) {
        const size_t o = (size_t)row[q] * B + b;
        a.x_out[o] = x[q];
        a.xb_out[o] = xb[q];
        a.mux_out[o] = mux[q];
        a.v_out[o] = v[q];
      }
      if (cone[q]) {
        const size_t oc = (size_t)cr[q] * B + b;
        a.lam_out[oc] = lam[q];
        a.mul_out[oc] = mul[q];
      }
    }
    if (lane == 0) {
      a.done_out[b] = done_in;
      a.niter_out[b] = a.niter_in[b];
      a.itv_out[b] = itv_in;
      a.xrn_out[b] = a.xrn_in[b];
      a.lrn_out[b] = a.lrn_in[b];
      a.prim_out[b] = a.prim_in[b];
      a.dual_out[b] = a.dual_in[b];
    }
    return;
  }

  const double rho = a.rho[b];
  // per-row constants; a cone row keeps its triple's first row c0, its
  // place in the triple and the cone's friction coefficient
  int c0[NR], pos[NR], fo[NR];
  double xc[NR], lo[NR], hi[NR], mf[NR];
#pragma unroll
  for (int q = 0; q < NR; ++q) {
    const size_t o = (size_t)row[q] * B + b;
    xc[q] = valid[q] ? a.xc[o] : 0.0;
    lo[q] = valid[q] ? a.lb[o] : 0.0;
    hi[q] = valid[q] ? a.ub[o] : 0.0;
    c0[q] = row[q];
    pos[q] = 0;
    mf[q] = 0.0;
    if (cone[q]) {
      const int c = cr[q] / 3;
      c0[q] = ls + 3 * c;
      pos[q] = row[q] - c0[q];
      mf[q] = a.muf[(size_t)c * B + b];
    }
    fo[q] = valid[q] ? row[q] : 0;
  }

  // the operator, read once for the chunk
  for (int e = lane; e < n * n; e += 32) Fs[e] = a.F[(size_t)e * B + b];
  __syncwarp();

  int niter = a.niter_in[b];
  int itv = itv_in;
  int done = 0;
  for (int it = 0; it < a.K; ++it) {
    double sp[NR], vn[NR], y[NR];
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      sp[q] = cone[q] ? lam[q] : xb[q];
      vn[q] = sp[q] - (cone[q] ? mul[q] : mux[q]);
    }

    // y = F^T v, accumulated over j in ascending order
    const double v0 = __shfl_sync(kFull, vn[0], 0);
#pragma unroll
    for (int q = 0; q < NR; ++q) y[q] = Fs[fo[q]] * v0;
    const int n1 = n < 32 ? n : 32;
    for (int j = 1; j < n1; ++j) {
      const double vj = __shfl_sync(kFull, vn[0], j);
#pragma unroll
      for (int q = 0; q < NR; ++q) y[q] = y[q] + Fs[j * n + fo[q]] * vj;
    }
    for (int j = 32; j < n; ++j) {
      const double vj = __shfl_sync(kFull, vn[NR - 1], j - 32);
#pragma unroll
      for (int q = 0; q < NR; ++q) y[q] = y[q] + Fs[j * n + fo[q]] * vj;
    }

    double xn[NR], tc[NR];
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      xn[q] = xc[q] + rho * y[q];
      tc[q] = xn[q] + mul[q];
    }

    double xbn[NR], lamn[NR];
    bool ok = true;
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      // the cone triple of this row, gathered from whichever slots hold it
      const double fx = from_row<NR>(tc, c0[q]);
      const double fy = from_row<NR>(tc, c0[q] + 1);
      const double fz = from_row<NR>(tc, c0[q] + 2);
      xbn[q] = tclip(xn[q] + mux[q], lo[q], hi[q]);
      lamn[q] = 0.0;
      if (cone[q]) {
        const double m = mf[q];
        const double norm = sqrt(fx * fx + fy * fy);
        const bool inside = m * fz - norm >= 0.0;
        const bool polar = fz + m * norm < 0.0;
        const double tt = (m * norm + fz) / (m * m + 1.0);
        const double safe = norm > 0.0 ? norm : 1.0;
        const double sc = tt * m / safe;
        const double surf = pos[q] == 2 ? tt : sc * tc[q];
        lamn[q] = inside ? tc[q] : (polar ? 0.0 : surf);
      }
      if (valid[q]) {
        const double dx = tabs(xn[q] - x[q]);
        ok = ok && tabs(xn[q] - xbn[q]) < a.eps_b;
        if (cone[q]) {
          ok = ok && tabs(xn[q] - lamn[q]) < a.eps_f;
          if (a.gate != 0) ok = ok && dx < a.eps_f;
          if (a.gate == 2) ok = ok && dx < a.eps_b;
        } else if (a.gate != 0) {
          ok = ok && dx < a.eps_b;
        }
      }
    }
    // max over a row set < eps  <=>  every row < eps (and eps > 0, for
    // an empty set, whose max is 0)
    const bool conv = __all_sync(kFull, ok) && 0.0 < a.eps_b && 0.0 < a.eps_f;

    if (conv || it + 1 == a.K || itv + 1 >= a.max_iter) {
      // the instance's last iteration in this chunk: its residual norms
      double bx = 0.0, cx = 0.0, pq[NR], dq[NR];
#pragma unroll
      for (int q = 0; q < NR; ++q) {
        const double sn = cone[q] ? lamn[q] : xbn[q];
        if (valid[q]) bx = tmax(bx, tabs(xn[q] - xbn[q]));
        if (cone[q]) cx = tmax(cx, tabs(xn[q] - lamn[q]));
        const double dp = xn[q] - sn;
        const double dc = sn - sp[q];
        pq[q] = valid[q] ? dp * dp : 0.0;
        dq[q] = valid[q] ? dc * dc : 0.0;
      }
      bx = warp_max(bx);
      cx = warp_max(cx);
      double pp = 0.0, dd = 0.0;
      for (int rr = 0; rr < n; ++rr) {
        pp = pp + from_row<NR>(pq, rr);
        dd = dd + from_row<NR>(dq, rr);
      }
      if (lane == 0) {
        a.xrn_out[b] = bx;
        a.lrn_out[b] = cx;
        a.prim_out[b] = sqrt(pp);
        a.dual_out[b] = rho * sqrt(dd);
      }
    }

#pragma unroll
    for (int q = 0; q < NR; ++q) {
      mux[q] = mux[q] + (xn[q] - xbn[q]);
      if (cone[q]) {
        mul[q] = mul[q] + (xn[q] - lamn[q]);
        lam[q] = lamn[q];
      }
      x[q] = xn[q];
      xb[q] = xbn[q];
      v[q] = vn[q];
    }
    if (conv) {
      niter = itv;
      done = 1;
    }
    itv = itv + 1;
    if (done != 0 || itv >= a.max_iter) break;
  }

#pragma unroll
  for (int q = 0; q < NR; ++q) {
    if (valid[q]) {
      const size_t o = (size_t)row[q] * B + b;
      a.x_out[o] = x[q];
      a.xb_out[o] = xb[q];
      a.mux_out[o] = mux[q];
      a.v_out[o] = v[q];
    }
    if (cone[q]) {
      const size_t oc = (size_t)cr[q] * B + b;
      a.lam_out[oc] = lam[q];
      a.mul_out[oc] = mul[q];
    }
  }
  if (lane == 0) {
    a.done_out[b] = done;
    a.niter_out[b] = niter;
    a.itv_out[b] = itv;
  }
}

int launch_full(void* const* p, double eps_b, double eps_f, int B, int n,
                int nc, int ls, int K, int max_iter, int gate, void* stream) {
  if (n < 1 || n > KMAX || nc < 0 || nc % 3 != 0 || ls < 0 || ls + nc > n ||
      B < 1 || gate < 0 || gate > 2)
    return (int)cudaErrorInvalidValue;
  FullArgs a;
  a.F = (const double*)p[0];
  a.xc = (const double*)p[1];
  a.lb = (const double*)p[2];
  a.ub = (const double*)p[3];
  a.muf = (const double*)p[4];
  a.rho = (const double*)p[5];
  a.x_in = (const double*)p[6];
  a.xb_in = (const double*)p[7];
  a.lam_in = (const double*)p[8];
  a.mux_in = (const double*)p[9];
  a.mul_in = (const double*)p[10];
  a.v_in = (const double*)p[11];
  a.done_in = (const int*)p[12];
  a.niter_in = (const int*)p[13];
  a.itv_in = (const int*)p[14];
  a.xrn_in = (const double*)p[15];
  a.lrn_in = (const double*)p[16];
  a.prim_in = (const double*)p[17];
  a.dual_in = (const double*)p[18];
  a.x_out = (double*)p[19];
  a.xb_out = (double*)p[20];
  a.lam_out = (double*)p[21];
  a.mux_out = (double*)p[22];
  a.mul_out = (double*)p[23];
  a.v_out = (double*)p[24];
  a.done_out = (int*)p[25];
  a.niter_out = (int*)p[26];
  a.itv_out = (int*)p[27];
  a.xrn_out = (double*)p[28];
  a.lrn_out = (double*)p[29];
  a.prim_out = (double*)p[30];
  a.dual_out = (double*)p[31];
  a.eps_b = eps_b;
  a.eps_f = eps_f;
  a.B = B;
  a.n = n;
  a.nc = nc;
  a.ls = ls;
  a.K = K;
  a.max_iter = max_iter;
  a.gate = gate;
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)n * n * sizeof(double);  // <= 32 KB
  if (n <= 32)
    admm_chunk_full_warp<1><<<B, 32, smem, s>>>(a);
  else
    admm_chunk_full_warp<2><<<B, 32, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). `ptrs` holds the 29 device
// pointers in ChunkArgs order; returns the cudaError_t of the launch.
extern "C" int admm_chunk_f64(void* const* ptrs, double eps_b, double eps_f,
                              int B, int k, int kb, int K, int max_iter,
                              int inc_gate, void* stream) {
  return launch<double>(ptrs, eps_b, eps_f, B, k, kb, K, max_iter, inc_gate,
                        stream);
}

extern "C" int admm_chunk_f32(void* const* ptrs, float eps_b, float eps_f,
                              int B, int k, int kb, int K, int max_iter,
                              void* stream) {
  return launch<float>(ptrs, eps_b, eps_f, B, k, kb, K, max_iter, 0, stream);
}

// `ptrs` holds the 32 device pointers in FullArgs order; gate 0 (off),
// 1 (ds engine: non-cone rows / segment) or 2 (f64 engine: all rows /
// segment). Returns the cudaError_t of the launch.
extern "C" int admm_chunk_full_f64(void* const* ptrs, double eps_b,
                                   double eps_f, int B, int n, int nc, int ls,
                                   int K, int max_iter, int gate,
                                   void* stream) {
  return launch_full(ptrs, eps_b, eps_f, B, n, nc, ls, K, max_iter, gate,
                     stream);
}
