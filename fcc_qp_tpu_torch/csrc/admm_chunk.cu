// Fused ADMM iteration chunks of the reduced FCCQP engine, for Hopper
// (sm_90a). Two precisions share one template, each in three row layouts
// (NR = 1 for k <= 32 constrained rows, NR = 2 for 32 < k <= 64, NR = 3
// for 64 < k <= 96: every model in models/osc.py, the humanoid's 76 rows
// with splitting="full" included):
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
// it sits, box and cone duals apart; admm_chunk_full_f32 is the same in
// f32 (the parity engine on f32 data).
//
// Every kernel takes the over-relaxation alpha at run time (the JAX
// package runs alpha != 1 on its XLA chunk bodies only). The reduced
// kernels have an instantiation without it (RELAX = false), chosen at
// launch when alpha == 1, so the unrelaxed iteration keeps its registers;
// the full layout chooses between two copies of its loop once per chunk.
//
// One iteration, per instance b (k constrained coordinates: kb box rows,
// then nc = 3 * ncones cone rows; every array is batch-last, [row][b]):
//   v      = s - mu
//   x      = x_const + rho * (F^T v)       F j-major: y[i] = sum_j F[j][i] v[j]
//   x_hat  = alpha * x + (1 - alpha) * s   over-relaxation; x_hat = x when
//                                          alpha == 1 (a branch the same
//                                          for every lane)
//   s_new  = [clip(x_hat + mu)_box ; Pi_cone(x_hat + mu)_cone]
//   r      = x - s_new ;  mu += x_hat - s_new
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
// Design: one warp per instance, lane i owns constrained row i (and rows
// i + 32, i + 64 when NR = 2, 3). This turns the k x k mat-vec of one thread into k
// dot products of length k run side by side; an iteration's latency is
// about k dependent adds, a few shuffles and one cone projection.
//   * The operator is read once per chunk, not once per iteration. NR = 1:
//     lane i holds column F[:, i] (k values) in registers, loaded with
//     compile-time indices (loops unrolled to 32, predicated on j < k);
//     the mat-vec runs in groups of 8 columns, so a group's shuffles
//     issue together, and pads the last group with exact no-op adds.
//     NR = 2, 3: the warp's k x k operator sits in dynamic shared memory
//     (NR = 3: one warp a block, 46 KB at k = 76 in f64; a block of four
//     would hold one block an SM and no more instances). Loads are strided (one instance's F[j][i] are B elements apart), so
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

#include <type_traits>

namespace {

constexpr int KMAX = 96;   // three row slots of 32 lanes
constexpr int kWarps = 4;  // instances (warps) per block, NR = 1, 2
constexpr unsigned kFull = 0xffffffffu;

// warps (instances) per block of admm_chunk_warp<T, NR>
template <int NR>
__host__ __device__ constexpr int warps_per_block() {
  return NR == 3 ? 1 : kWarps;
}

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
  T alpha;    // over-relaxation
  int relax;  // alpha != 1
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
  if constexpr (NR >= 2) {
    const T v1 = __shfl_sync(kFull, a[1], row & 31);
    if (row >= 32) v = v1;
  }
  if constexpr (NR == 3) {
    const T v2 = __shfl_sync(kFull, a[2], row & 31);
    if (row >= 64) v = v2;
  }
  return v;
}

// RELAX: alpha != 1 (over-relaxation); the instantiation without it is
// the unrelaxed iteration, and takes no register for it
template <typename T, int NR, bool RELAX>
__global__ void __launch_bounds__(warps_per_block<NR>() * 32)
    admm_chunk_warp(ChunkArgs<T> a) {
  // NR >= 2: each warp's k x k operator, [j][i]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * warps_per_block<NR>() + warp;
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
  const T alpha = a.alpha, oma = T(1) - a.alpha;
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
  // NR >= 2: shared-memory column offsets, clamped for rows >= k
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
      const int k2 = (NR == 3 && k > 64) ? 64 : k;
      for (int j = 32; j < k2; ++j) {
        const T vj = __shfl_sync(kFull, vn[1], j - 32);
#pragma unroll
        for (int q = 0; q < NR; ++q) y[q] = y[q] + Fs[j * k + fo[q]] * vj;
      }
      if constexpr (NR == 3) {
        for (int j = 64; j < k; ++j) {
          const T vj = __shfl_sync(kFull, vn[2], j - 64);
#pragma unroll
          for (int q = 0; q < NR; ++q) y[q] = y[q] + Fs[j * k + fo[q]] * vj;
        }
      }
    }

    T xn[NR], xh[NR], t[NR];
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      xn[q] = xc[q] + rho * y[q];
      if constexpr (RELAX) {
        xh[q] = alpha * xn[q] + oma * s[q];
      } else {
        xh[q] = xn[q];
      }
      t[q] = xh[q] + mu[q];
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
      mu[q] = mu[q] + (xh[q] - sn[q]);
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

// the block's shared memory for k rows, above the default 48 KB limit
// only after the attribute is raised
template <typename T, int NR, bool RELAX>
int rows_prepare(int k, size_t* smem) {
  *smem = NR >= 2 ? (size_t)warps_per_block<NR>() * k * k * sizeof(T) : 0;
  if (*smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        admm_chunk_warp<T, NR, RELAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

template <typename T, int NR, bool RELAX>
int launch_rows_relax(const ChunkArgs<T>& a, cudaStream_t stream) {
  constexpr int W = warps_per_block<NR>();
  size_t smem;
  const int e = rows_prepare<T, NR, RELAX>(a.k, &smem);
  if (e != 0) return e;
  const int blocks = (a.B + W - 1) / W;
  admm_chunk_warp<T, NR, RELAX><<<blocks, W * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int NR>
int launch_rows(const ChunkArgs<T>& a, cudaStream_t stream) {
  return a.relax ? launch_rows_relax<T, NR, true>(a, stream)
                 : launch_rows_relax<T, NR, false>(a, stream);
}

// resident blocks per SM of the unrelaxed instantiation (the relaxed one's
// may differ by its registers)
template <typename T, int NR>
int rows_occupancy_nr(int k, int* blocks) {
  size_t smem;
  const int e = rows_prepare<T, NR, false>(k, &smem);
  if (e != 0) return e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, admm_chunk_warp<T, NR, false>, warps_per_block<NR>() * 32,
      smem);
}

template <typename T>
int rows_occupancy(int k, int* blocks) {
  if (k <= 32) return rows_occupancy_nr<T, 1>(k, blocks);
  if (k <= 64) return rows_occupancy_nr<T, 2>(k, blocks);
  return rows_occupancy_nr<T, 3>(k, blocks);
}

template <typename T>
int launch(void* const* p, T eps_b, T eps_f, T alpha, int B, int k, int kb,
           int K, int max_iter, int inc_gate, void* stream) {
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
  a.alpha = alpha;
  a.relax = alpha != T(1);
  a.B = B;
  a.k = k;
  a.kb = kb;
  a.K = K;
  a.max_iter = max_iter;
  a.inc_gate = inc_gate;
  const cudaStream_t s = (cudaStream_t)stream;
  if (k <= 32) return launch_rows<T, 1>(a, s);
  if (k <= 64) return launch_rows<T, 2>(a, s);
  return launch_rows<T, 3>(a, s);
}

// --------------------------------------------------------------------------
// admm_chunk_full_f64 / admm_chunk_full_f32: the general (full-splitting)
// layout of fcc_qp_tpu/ops/pallas_admm.py::admm_chunk_pallas (Pallas body
// `_kernel`), the layout the full-splitting engine, the f64 parity engine
// and the batch-level engine (solve_batched_fast) call it in; f32 for the
// parity engine on f32 data.
//
// One iteration, per instance b (n variables; the cone segment is rows
// [ls, ls + nc) wherever it sits; every array batch-last, [row][b]):
//   s_prev = x_bar with the segment replaced by lam_bar
//   v      = s_prev - (mu_x with the segment replaced by mu_lam)
//   x      = x_const + rho * (F^T v)
//   x_hat  = alpha * x + (1 - alpha) * s_prev  (x_hat = x when alpha == 1,
//                                              a branch the same for
//                                              every lane)
//   x_bar  = clip(x_hat + mu_x, lb, ub)        on ALL n rows, cone rows too
//   lam_bar= Pi_cone(seg(x_hat) + mu_lam)      the segment's own slack
//   r_x = x - x_bar (n rows), r_l = seg(x) - lam_bar (nc rows)
//   mu_x += x_hat - x_bar ; mu_lam += seg(x_hat) - lam_bar
//                                              the box and cone duals apart
//   xrn = max |r_x|, lrn = max |r_l| (unit weights: unscaled problems)
//   prim = ||x - s_now||_2, dual = rho ||s_now - s_prev||_2 (s_now likewise)
//   conv = lrn < eps_f && xrn < eps_b, and with the increment gate
//     gate 1 (ds engine):  max |dx| over the non-cone rows < eps_b and
//                          max |dx| over the segment < eps_f
//     gate 2 (f64 engine): max |dx| over all rows < eps_b and over the
//                          segment < eps_f
// Bound: as for admm_chunk_f64, with n in place of k; the operator is the
// full n x n (28.8 KB at Cassie's n = 60 in f64), so an all-active chunk
// of 25 iterations is bound by bytes (the operators, 0.085 ms at B =
// 8192), a straggler chunk by the state's bytes. Without contraction an
// iteration issues 2 n^2 f64 operations (mul, add) per instance, which at
// 64 FP64 lanes an SM take about as long as those bytes (0.088 ms): the
// chunk comes near its bound only where the loads overlap the arithmetic.
// The times beside the bounds are in PERF.md.
//
// Design: one warp per instance, lane i owns rows i, i + 32 and i + 64
// (NR = 1, 2, 3 slots for n <= 32, 64, 96); one instantiation per slot
// count, n read at run time.
//   * Operator: lane i holds F[j][row] for the first JR columns j of each
//     row it owns in registers (compile-time indices); the other columns
//     sit in the warp's shared memory, [j - JR][row] at a row stride of
//     32 * NR, so every offset the unrolled mat-vec reads is a constant
//     whatever n is. JR per NR (full_jr) is the largest that ptxas
//     compiles without spills; the registers and the shared columns
//     together set the instances an SM holds (admm_chunk_blocks_per_sm).
//   * Operator load: a block holds W neighbouring instances (4, or 2
//     where four operators would not fit in shared memory: n > 80) and
//     copies their operators together with 8-byte cp.async, thread t for
//     instance t % W, so the W words of one element come from one 32-byte
//     sector: each sector crosses from L2 once per block, not W times.
//     Every copy of a thread is issued before its one wait; the state
//     loads while the shared columns are in flight. A block none of whose
//     instances iterates loads nothing.
//   * Mat-vec without shuffles: each iteration writes v to the warp's
//     vector in shared memory (one __syncwarp) and every lane reads v[j]
//     as a broadcast, two at a time. The j loop is unrolled in groups of
//     8 whose loads issue ahead of their adds; only the ascending add
//     chain stays serial. It has one branch, so the compiler schedules
//     the loads across groups: the first 32 (NR - 1) + 16 columns run
//     always, the last 16 only when n reaches them. Columns from n to the
//     next multiple of 16 are padding (F = +0, v = -0): each adds -0,
//     which is exact.
//   * Projection: the cone triples (fx, fy, fz) go through a shared
//     vector; a lane owns at most one cone row when nc <= 32 (every
//     model) and projects once.
//   * The last iteration's 2-norm terms go through shared vectors, summed
//     in row order from 0 by lane 0; the max-norms by warp reduction.
//   * State and per-row constants in registers; v lives in the shared
//     vector and is written out from there. A cone row keeps both slacks
//     and both duals. The convergence test is a warp vote (__all_sync) of
//     every row's test; with eps > 0, max < eps <=> every row < eps.
//   * Same arithmetic in the same order as the plain version, no FMA:
//     bit-equal state, counters and max-norms.
//   * One template over the scalar type: the f32 instantiation keeps the
//     f64 one's layout (the same register and shared columns, in 4-byte
//     words, copied with 4-byte cp.async).
// --------------------------------------------------------------------------

template <typename T>
struct FullArgs {
  const T* F;      // (n, n, B) j-major operator
  const T* xc;     // (n, B)
  const T* lb;     // (n, B)
  const T* ub;
  const T* muf;    // (max(nc/3, 1), B)
  const T* rho;    // (B,)
  const T* x_in;   // (n, B)
  const T* xb_in;  // (n, B)
  const T* lam_in; // (max(nc, 1), B)
  const T* mux_in; // (n, B)
  const T* mul_in; // (max(nc, 1), B)
  const T* v_in;   // (n, B)
  const int* done_in;   // (B,)
  const int* niter_in;
  const int* itv_in;
  const T* xrn_in;
  const T* lrn_in;
  const T* prim_in;
  const T* dual_in;
  T* x_out;
  T* xb_out;
  T* lam_out;
  T* mux_out;
  T* mul_out;
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
  T alpha;    // over-relaxation
  int relax;  // alpha != 1
  int B;
  int n;
  int nc;
  int ls;
  int K;
  int max_iter;
  int gate;
};

// Register columns of the full-layout operator per row-slot count (the
// rest is in shared memory); multiples of 8, the mat-vec's group. Chosen
// from the ptxas report: the largest with no spills and no stack frame
// (40 at two slots and 24 at three spill).
template <int NR>
__host__ __device__ constexpr int full_jr() {
  return NR == 3 ? 16 : 32;
}

// the columns the mat-vec runs at every n of the slot count; the last 16
// run only when n reaches them
template <int NR>
__host__ __device__ constexpr int full_always() {
  return 32 * NR - 16;
}

// the columns the mat-vec reads at n rows: n and its padding
template <int NR>
__host__ __device__ inline int full_cols(int n) {
  const int c = (n + 15) / 16 * 16;
  return c > full_always<NR>() ? c : full_always<NR>();
}

// words of one warp's operator region at the row stride 32 * NR: the
// shared columns JR <= j < full_cols(n), or the register columns while
// they are staged there, whichever is more
template <int NR>
__host__ __device__ inline int full_fsz(int n) {
  constexpr int JR = full_jr<NR>();
  const int shared = full_cols<NR>(n) - JR;
  const int staged = JR < n ? JR : n;
  return (shared > staged ? shared : staged) * 32 * NR;
}

// one warp's dynamic shared memory: four vectors of 32 * NR rows, then
// the operator region
template <typename T, int NR>
size_t full_warp_bytes(int n) {
  return (size_t)(4 * 32 * NR + full_fsz<NR>(n)) * sizeof(T);
}

// the dynamic shared memory a block may request on sm_90
constexpr size_t kSmemOptin = 227 * 1024;

// instances (warps) per block of the full-layout kernel: four, so that a
// 32-byte sector of the operator serves one block, where their four
// operators fit in a block's shared memory (every n <= 80); two above
template <typename T, int NR>
int full_warps(int n) {
  return 4 * full_warp_bytes<T, NR>(n) <= kSmemOptin ? 4 : 2;
}

// one word, global to shared, asynchronously
__device__ __forceinline__ void cp_async(double* dst, const double* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// two neighbouring words of a shared vector in one load
template <typename T>
struct Pair;
template <>
struct Pair<double> {
  using type = double2;
};
template <>
struct Pair<float> {
  using type = float2;
};

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the projection of a cone row's value t onto its cone, given the
// cone's (fx, fy, fz), friction coefficient m, den = m * m + 1 and the
// row's place in the triple: the plain version's operations in order
template <typename T>
__device__ __forceinline__ T cone_row(T t, T fx, T fy, T fz, T m, T den,
                                      int pos) {
  const T norm = tsqrt<T>(fx * fx + fy * fy);
  const bool inside = m * fz - norm >= T(0);
  const bool polar = fz + m * norm < T(0);
  const T tt = (m * norm + fz) / den;
  const T safe = norm > T(0) ? norm : T(1);
  const T sc = tt * m / safe;
  const T surf = pos == 2 ? tt : sc * t;
  return inside ? t : (polar ? T(0) : surf);
}

// y[q] (+)= sum over the columns j in [J0, J1) of F[j][row q] * v[j], in
// ascending j and groups of 8 whose loads issue ahead of their adds; the
// first JR columns come from registers, the rest from the warp's shared
// columns (Fl: this lane's row in column JR, row stride 32 * NR)
template <typename T, int NR, int JR, int J0, int J1>
__device__ __forceinline__ void full_matvec(T (&y)[NR],
                                            const T (&fr)[NR][JR],
                                            const T* Fl, const T* vs) {
  constexpr int G = 8;
  static_assert(J0 % G == 0 && J1 % G == 0, "groups of 8 columns");
#pragma unroll
  for (int j0 = J0; j0 < J1; j0 += G) {
    T vj[G], f[G][NR];
#pragma unroll
    for (int u = 0; u < G; u += 2) {
      const typename Pair<T>::type p =
          *reinterpret_cast<const typename Pair<T>::type*>(vs + j0 + u);
      vj[u] = p.x;
      vj[u + 1] = p.y;
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int j = j0 + u;
#pragma unroll
      for (int q = 0; q < NR; ++q)
        f[u][q] = j < JR ? fr[q][j < JR ? j : 0]
                         : Fl[(j - JR) * 32 * NR + 32 * q];
    }
#pragma unroll
    for (int u = 0; u < G; ++u)
#pragma unroll
      for (int q = 0; q < NR; ++q) {
        const T p = f[u][q] * vj[u];
        y[q] = j0 + u == 0 ? p : y[q] + p;
      }
  }
}

// blockDim.x = 32 W, W = full_warps<T, NR>(n) instances a block (2 or 4)
template <typename T, int NR>
__global__ void __launch_bounds__(128) admm_chunk_full_warp(FullArgs<T> a) {
  constexpr int JR = full_jr<NR>();
  constexpr int ROWS = 32 * NR;
  const int W = blockDim.x >> 5;
  // the mat-vec runs the first H columns always, the rest when n > H
  constexpr int H = full_always<NR>();
  static_assert(JR % 8 == 0 && JR >= 8 && JR <= ROWS, "register columns");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b0 = blockIdx.x * W;
  const int b = b0 + warp;
  const int B = a.B, n = a.n, nc = a.nc, ls = a.ls;
  const int wsz = 4 * ROWS + full_fsz<NR>(n);
  T* vs = reinterpret_cast<T*>(smem_raw) + warp * wsz;  // v
  T* ts = vs + ROWS;  // seg(x) + mu_lam
  T* ps = ts + ROWS;  // 2-norm terms
  T* qs = ps + ROWS;
  T* Fs = qs + ROWS;  // the operator region, [j][row], stride ROWS
  const bool idle = b >= B || a.done_in[b] != 0 ||
                    a.itv_in[b] >= a.max_iter || a.K < 1;

  // The operator, read once for the chunk by the whole block: thread t
  // copies rows t / W + 32 q of instance b0 + t % W, so W neighbouring
  // threads read the W instances' words of one element from one 32-byte
  // sector, and a warp's copy touches 32 / W sectors, not 32. The
  // register columns are staged in each warp's operator region first,
  // then the shared columns land there; every copy of a thread is issued
  // before its wait.
  const int d = tid & (W - 1);
  const int pr = tid >> (W == 4 ? 2 : 1);
  const int bd = b0 + d;
  const bool load_d = bd < B && a.done_in[bd] == 0 &&
                      a.itv_in[bd] < a.max_iter && a.K >= 1;
  const bool any = __syncthreads_or(load_d) != 0;
  T fr[NR][JR];
  if (any) {
    T* Fd = reinterpret_cast<T*>(smem_raw) + d * wsz + 4 * ROWS;
    const size_t step = (size_t)n * B;               // one column
    const T* col = a.F + bd + (size_t)pr * B;  // row pr, column 0
    const int j1 = JR < n ? JR : n;
    if (load_d)
      for (int j = 0; j < j1; ++j, col += step)
#pragma unroll
        for (int q = 0; q < NR; ++q)
          if (pr + 32 * q < n)
            cp_async(Fd + j * ROWS + pr + 32 * q, col + (size_t)32 * q * B);
    cp_async_wait_all();
    __syncthreads();
    if (!idle) {
#pragma unroll
      for (int q = 0; q < NR; ++q)
#pragma unroll
        for (int j = 0; j < JR; ++j) {
          const int r = lane + 32 * q;
          fr[q][j] = (j < n && r < n) ? Fs[j * ROWS + r] : T(0);
        }
    }
    __syncthreads();
    if (load_d)
      for (int j = JR; j < n; ++j, col += step)
#pragma unroll
        for (int q = 0; q < NR; ++q)
          if (pr + 32 * q < n)
            cp_async(Fd + (j - JR) * ROWS + pr + 32 * q,
                      col + (size_t)32 * q * B);
    // the mat-vec's padding: the shared columns from n to full_cols(n)
    // hold +0 (the register columns past n already do)
    if (!idle)
      for (int j = n > JR ? n : JR; j < full_cols<NR>(n); ++j)
#pragma unroll
        for (int q = 0; q < NR; ++q) Fs[(j - JR) * ROWS + 32 * q + lane] = T(0);
  }

  // rows and the state: iterated below, or copied through by an idle
  // warp. Every slot but the last is full (n > 32 (NR - 1)), which the
  // compiler sees through `valid`.
  int row[NR], cr[NR];
  bool valid[NR], cone[NR];
  T x[NR], xb[NR], mux[NR], lam[NR], mul[NR];
  const bool live = b < B;
#pragma unroll
  for (int q = 0; q < NR; ++q) {
    row[q] = lane + 32 * q;
    valid[q] = q < NR - 1 || row[q] < n;
    cr[q] = row[q] - ls;
    cone[q] = valid[q] && cr[q] >= 0 && cr[q] < nc;
    const size_t o = (size_t)row[q] * B + b;
    const size_t oc = (size_t)(cone[q] ? cr[q] : 0) * B + b;
    x[q] = live && valid[q] ? a.x_in[o] : T(0);
    xb[q] = live && valid[q] ? a.xb_in[o] : T(0);
    mux[q] = live && valid[q] ? a.mux_in[o] : T(0);
    lam[q] = live && cone[q] ? a.lam_in[oc] : T(0);
    mul[q] = live && cone[q] ? a.mul_in[oc] : T(0);
  }
  if (any) {
    cp_async_wait_all();
    __syncthreads();
  }
  if (!live) return;  // warp-uniform, after the block's last barrier

  if (idle) {
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      if (valid[q]) {
        const size_t o = (size_t)row[q] * B + b;
        a.x_out[o] = x[q];
        a.xb_out[o] = xb[q];
        a.mux_out[o] = mux[q];
        a.v_out[o] = a.v_in[o];
      }
      if (cone[q]) {
        const size_t oc = (size_t)cr[q] * B + b;
        a.lam_out[oc] = lam[q];
        a.mul_out[oc] = mul[q];
      }
    }
    if (lane == 0) {
      a.done_out[b] = a.done_in[b];
      a.niter_out[b] = a.niter_in[b];
      a.itv_out[b] = a.itv_in[b];
      a.xrn_out[b] = a.xrn_in[b];
      a.lrn_out[b] = a.lrn_in[b];
      a.prim_out[b] = a.prim_in[b];
      a.dual_out[b] = a.dual_in[b];
    }
    return;
  }

  const T rho = a.rho[b];
  const T alpha = a.alpha, oma = T(1) - a.alpha;
  // per-row constants; a cone row keeps its triple's first row c0, its
  // place in the triple, the cone's friction coefficient m and m * m + 1
  int c0[NR], pos[NR];
  T xc[NR], lo[NR], hi[NR], mf[NR], den[NR];
#pragma unroll
  for (int q = 0; q < NR; ++q) {
    const size_t o = (size_t)row[q] * B + b;
    xc[q] = valid[q] ? a.xc[o] : T(0);
    lo[q] = valid[q] ? a.lb[o] : T(0);
    hi[q] = valid[q] ? a.ub[o] : T(0);
    c0[q] = row[q];
    pos[q] = 0;
    mf[q] = T(0);
    if (cone[q]) {
      const int c = cr[q] / 3;
      c0[q] = ls + 3 * c;
      pos[q] = row[q] - c0[q];
      mf[q] = a.muf[(size_t)c * B + b];
    }
    den[q] = mf[q] * mf[q] + T(1);
  }
  // with nc <= 32 (every model) a lane owns at most one cone row, in
  // slot cq, and projects once an iteration
  int cq = -1, ncq = 0;
#pragma unroll
  for (int q = 0; q < NR; ++q) {
    if (cone[q]) {
      if (cq < 0) cq = q;
      ++ncq;
    }
  }

  int niter = a.niter_in[b];
  int itv = a.itv_in[b];
  int done = 0;
  // The iterations, in two copies chosen once for the chunk: with
  // over-relaxation (alpha != 1) and without, so that alpha == 1 runs no
  // instruction of it. x_hat of row q comes from its x and its s_prev
  // (lam on a cone row, x_bar elsewhere), recomputed where it is read
  // (the same operations each time) so that it holds no registers.
  auto iterate = [&](auto relax_tag) {
    constexpr bool kRelax = decltype(relax_tag)::value;
    auto relaxed = [&](T xq, T sp) -> T {
      if constexpr (kRelax) {
        return alpha * xq + oma * sp;
      } else {
        return xq;
      }
    };
    for (int it = 0; it < a.K; ++it) {
      // v into the shared vector; rows >= n hold -0 (the mat-vec's padding)
#pragma unroll
      for (int q = 0; q < NR; ++q)
        vs[row[q]] = valid[q] ? (cone[q] ? lam[q] : xb[q]) -
                                    (cone[q] ? mul[q] : mux[q])
                              : T(-0.0);
      __syncwarp();

      // y = F^T v, over j ascending from F[0][i] v[0]: the first
      // 32 (NR - 1) + 16 columns always, the last 16 only when n reaches
      // them. A column j >= n in that range adds F = +0 times v = -0, that
      // is -0, which leaves every y (+0 and -0 included) as it is.
      T y[NR];
      full_matvec<T, NR, JR, 0, H>(y, fr, Fs + lane, vs);
      if (n > H) full_matvec<T, NR, JR, H, ROWS>(y, fr, Fs + lane, vs);

      T xn[NR];
#pragma unroll
      for (int q = 0; q < NR; ++q) {
        xn[q] = xc[q] + rho * y[q];
        if (cone[q]) ts[row[q]] = relaxed(xn[q], lam[q]) + mul[q];
      }
      __syncwarp();

      // projections: every row clips x_hat + mu_x; a cone row projects its
      // triple, gathered from the shared vector
      T xbn[NR], lamn[NR];
#pragma unroll
      for (int q = 0; q < NR; ++q) {
        xbn[q] = tclip(relaxed(xn[q], cone[q] ? lam[q] : xb[q]) + mux[q],
                       lo[q], hi[q]);
        lamn[q] = T(0);
      }
      if (ncq == 1) {
        T t = T(0), m = T(0), dn = T(1);
        int cc = 0, pp = 0;
#pragma unroll
        for (int q = 0; q < NR; ++q) {
          if (q == cq) {
            t = relaxed(xn[q], lam[q]) + mul[q];
            m = mf[q];
            dn = den[q];
            cc = c0[q];
            pp = pos[q];
          }
        }
        const T l = cone_row(t, ts[cc], ts[cc + 1], ts[cc + 2], m, dn, pp);
#pragma unroll
        for (int q = 0; q < NR; ++q)
          if (q == cq) lamn[q] = l;
      } else if (ncq > 1) {
#pragma unroll
        for (int q = 0; q < NR; ++q)
          if (cone[q])
            lamn[q] = cone_row(relaxed(xn[q], lam[q]) + mul[q], ts[c0[q]],
                               ts[c0[q] + 1],
                               ts[c0[q] + 2], mf[q], den[q], pos[q]);
      }
      bool ok = true;
#pragma unroll
      for (int q = 0; q < NR; ++q) {
        if (valid[q]) {
          const T dx = tabs(xn[q] - x[q]);
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
      const bool conv = __all_sync(kFull, ok) && T(0) < a.eps_b && T(0) < a.eps_f;

      if (conv || it + 1 == a.K || itv + 1 >= a.max_iter) {
        // the instance's last iteration in this chunk: its residual norms
        T bx = T(0), cx = T(0);
#pragma unroll
        for (int q = 0; q < NR; ++q) {
          const T sn = cone[q] ? lamn[q] : xbn[q];
          const T sp = cone[q] ? lam[q] : xb[q];
          if (valid[q]) bx = tmax(bx, tabs(xn[q] - xbn[q]));
          if (cone[q]) cx = tmax(cx, tabs(xn[q] - lamn[q]));
          const T dp = xn[q] - sn;
          const T dc = sn - sp;
          ps[row[q]] = valid[q] ? dp * dp : T(0);
          qs[row[q]] = valid[q] ? dc * dc : T(0);
        }
        bx = warp_max(bx);
        cx = warp_max(cx);
        __syncwarp();
        if (lane == 0) {
          // rows >= n hold +0, which leaves a sum of squares as it is
          T pp = T(0), dd = T(0);
#pragma unroll
          for (int rr = 0; rr < ROWS; ++rr) {
            pp = pp + ps[rr];
            dd = dd + qs[rr];
          }
          a.xrn_out[b] = bx;
          a.lrn_out[b] = cx;
          a.prim_out[b] = tsqrt<T>(pp);
          a.dual_out[b] = rho * tsqrt<T>(dd);
        }
      }

#pragma unroll
      for (int q = 0; q < NR; ++q) {
        mux[q] = mux[q] + (relaxed(xn[q], cone[q] ? lam[q] : xb[q]) - xbn[q]);
        if (cone[q]) {
          mul[q] = mul[q] + (relaxed(xn[q], lam[q]) - lamn[q]);
          lam[q] = lamn[q];
        }
        x[q] = xn[q];
        xb[q] = xbn[q];
      }
      if (conv) {
        niter = itv;
        done = 1;
      }
      itv = itv + 1;
      if (done != 0 || itv >= a.max_iter) break;
    }
  };
  if (a.relax != 0)
    iterate(std::true_type{});
  else
    iterate(std::false_type{});

  // v is the last iteration's, still in the shared vector (each lane
  // reads the rows it wrote)
#pragma unroll
  for (int q = 0; q < NR; ++q) {
    if (valid[q]) {
      const size_t o = (size_t)row[q] * B + b;
      a.x_out[o] = x[q];
      a.xb_out[o] = xb[q];
      a.mux_out[o] = mux[q];
      a.v_out[o] = vs[row[q]];
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

// the block's shared memory for n rows, above the default 48 KB limit
// only after the attribute is raised
template <typename T, int NR>
int full_prepare(int n, size_t* smem) {
  *smem = full_warps<T, NR>(n) * full_warp_bytes<T, NR>(n);
  if (*smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        admm_chunk_full_warp<T, NR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

template <typename T, int NR>
int launch_full_rows(const FullArgs<T>& a, cudaStream_t s) {
  size_t smem;
  const int e = full_prepare<T, NR>(a.n, &smem);
  if (e != 0) return e;
  const int W = full_warps<T, NR>(a.n);
  const int blocks = (a.B + W - 1) / W;
  admm_chunk_full_warp<T, NR><<<blocks, W * 32, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int NR>
int full_occupancy_nr(int n, int* blocks) {
  size_t smem;
  const int e = full_prepare<T, NR>(n, &smem);
  if (e != 0) return e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, admm_chunk_full_warp<T, NR>, full_warps<T, NR>(n) * 32, smem);
}

template <typename T>
int full_occupancy(int n, int* blocks) {
  if (n <= 32) return full_occupancy_nr<T, 1>(n, blocks);
  if (n <= 64) return full_occupancy_nr<T, 2>(n, blocks);
  return full_occupancy_nr<T, 3>(n, blocks);
}

template <typename T>
int launch_full(void* const* p, T eps_b, T eps_f, T alpha, int B, int n,
                int nc, int ls, int K, int max_iter, int gate, void* stream) {
  if (n < 1 || n > KMAX || nc < 0 || nc % 3 != 0 || ls < 0 || ls + nc > n ||
      B < 1 || gate < 0 || gate > 2)
    return (int)cudaErrorInvalidValue;
  FullArgs<T> a;
  a.F = (const T*)p[0];
  a.xc = (const T*)p[1];
  a.lb = (const T*)p[2];
  a.ub = (const T*)p[3];
  a.muf = (const T*)p[4];
  a.rho = (const T*)p[5];
  a.x_in = (const T*)p[6];
  a.xb_in = (const T*)p[7];
  a.lam_in = (const T*)p[8];
  a.mux_in = (const T*)p[9];
  a.mul_in = (const T*)p[10];
  a.v_in = (const T*)p[11];
  a.done_in = (const int*)p[12];
  a.niter_in = (const int*)p[13];
  a.itv_in = (const int*)p[14];
  a.xrn_in = (const T*)p[15];
  a.lrn_in = (const T*)p[16];
  a.prim_in = (const T*)p[17];
  a.dual_in = (const T*)p[18];
  a.x_out = (T*)p[19];
  a.xb_out = (T*)p[20];
  a.lam_out = (T*)p[21];
  a.mux_out = (T*)p[22];
  a.mul_out = (T*)p[23];
  a.v_out = (T*)p[24];
  a.done_out = (int*)p[25];
  a.niter_out = (int*)p[26];
  a.itv_out = (int*)p[27];
  a.xrn_out = (T*)p[28];
  a.lrn_out = (T*)p[29];
  a.prim_out = (T*)p[30];
  a.dual_out = (T*)p[31];
  a.eps_b = eps_b;
  a.eps_f = eps_f;
  a.alpha = alpha;
  a.relax = alpha != T(1);
  a.B = B;
  a.n = n;
  a.nc = nc;
  a.ls = ls;
  a.K = K;
  a.max_iter = max_iter;
  a.gate = gate;
  const cudaStream_t s = (cudaStream_t)stream;
  if (n <= 32) return launch_full_rows<T, 1>(a, s);
  if (n <= 64) return launch_full_rows<T, 2>(a, s);
  return launch_full_rows<T, 3>(a, s);
}

}  // namespace

// Plain C interface (loaded with ctypes). `ptrs` holds the 29 device
// pointers in ChunkArgs order; `alpha` is the over-relaxation (1: none).
// Returns the cudaError_t of the launch.
extern "C" int admm_chunk_f64(void* const* ptrs, double eps_b, double eps_f,
                              double alpha, int B, int k, int kb, int K,
                              int max_iter, int inc_gate, void* stream) {
  return launch<double>(ptrs, eps_b, eps_f, alpha, B, k, kb, K, max_iter,
                        inc_gate, stream);
}

extern "C" int admm_chunk_f32(void* const* ptrs, float eps_b, float eps_f,
                              float alpha, int B, int k, int kb, int K,
                              int max_iter, void* stream) {
  return launch<float>(ptrs, eps_b, eps_f, alpha, B, k, kb, K, max_iter, 0,
                       stream);
}

// `ptrs` holds the 32 device pointers in FullArgs order; gate 0 (off),
// 1 (ds engine: non-cone rows / segment) or 2 (f64 engine: all rows /
// segment). Returns the cudaError_t of the launch.
extern "C" int admm_chunk_full_f64(void* const* ptrs, double eps_b,
                                   double eps_f, double alpha, int B, int n,
                                   int nc, int ls, int K, int max_iter,
                                   int gate, void* stream) {
  return launch_full<double>(ptrs, eps_b, eps_f, alpha, B, n, nc, ls, K,
                             max_iter, gate, stream);
}

extern "C" int admm_chunk_full_f32(void* const* ptrs, float eps_b,
                                   float eps_f, float alpha, int B, int n,
                                   int nc, int ls, int K, int max_iter,
                                   int gate, void* stream) {
  return launch_full<float>(ptrs, eps_b, eps_f, alpha, B, n, nc, ls, K,
                            max_iter, gate, stream);
}

// Resident blocks per SM of the full-layout kernel at n rows and of the
// reduced kernels at k rows (kernel 0: admm_chunk_f64, 1: admm_chunk_f32,
// 2: admm_chunk_full_f64, 3: admm_chunk_full_f32; a block holds four
// instances, and one for the reduced kernels above 64 rows, two for the
// full layout where four operators do not fit in shared memory), from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor.
// Returns the cudaError_t.
extern "C" int admm_chunk_blocks_per_sm(int kernel, int rows, int* blocks) {
  if (rows < 1 || rows > KMAX || kernel < 0 || kernel > 3)
    return (int)cudaErrorInvalidValue;
  switch (kernel) {
    case 0: return rows_occupancy<double>(rows, blocks);
    case 1: return rows_occupancy<float>(rows, blocks);
    case 2: return full_occupancy<double>(rows, blocks);
    default: return full_occupancy<float>(rows, blocks);
  }
}
