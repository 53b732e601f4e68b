// Newton-Schulz chains of the PDAS polish, for Hopper (sm_90a): one thread
// block runs the whole chain of one instance with the row-replaced pinned
// KKT M, the iterate X and the product in shared memory.
//
// Replaces no TPU kernel: the JAX package leaves these chains to XLA
// (fcc_qp_tpu/ops/polish.py, _polish_seed_f32 and _ns_refresh_guarded), and
// the port ran them as batched cuBLAS products. It computes the functions
// of fcc_qp_tpu_torch/ops/polish.py::polish_ns_plain, in two modes:
//
//   seed     X0 = M' / den (den = max(||M||_F^2, 1e-30), given by the
//            wrapper), then `iters` iterations of X <- X (2I - M X). With
//            `keep`, a block whose entry is 0 exits at once; with `idx`,
//            block b writes its seed into slot idx[b] of `out` (a rebuild
//            pass writes into the batch's seeds in place).
//   refresh  the guarded refresh of a carried seed X0 over `steps` steps:
//            r = ||M X - I||_inf (inf when not finite); a step restarts
//            from the best iterate when r >= 1, then X <- X (2I - P),
//            P = M X, and keeps the best-residual iterate. Writes X_best
//            to `out` and its residual to `r_out`. The restart product
//            M X_best runs only where X is not X_best already (there P is
//            M X_best, bit for bit).
//
// Arithmetic: every product entry is one chain of fmaf over k = 0, 1, ...,
// n - 1 from +0, FP32 only (no tensor cores, no TF32: the seeds do not
// contract under TF32), as cuBLAS's SIMT SGEMM sums it. 2I - P and the
// residual's |P - I| are the elementwise operations of the plain version.
// Row sums of the residual add in their own order (partials over a
// thread's columns, then the partials in order), so a residual can differ
// from the plain version's in its last bits; it only decides the
// restarts, the best iterate and the rebuilds. The rest of the file is
// built with --fmad=false, so nothing else contracts.
//
// Bound, per chain: 2 n^3 flops a product (n = N2; 40 iterations of two
// products a seed, 5 to 7 products a refresh) against the FP32 FMA peak
// (67 TFLOP/s, H100 SXM), M read once and X written once per instance:
// operations bound by two orders of magnitude (a seed of 8192 Cassie
// instances, n = 102: 1.39 TFLOP, 20.8 ms; 0.34 GB, 0.10 ms).
//
// Design: M, X and the product (stored as 2I - P) stay in dynamic shared
// memory for the whole chain, row-major at a row stride ld (an odd
// multiple of 4 words, so rows a few apart fall in different banks). One
// block an SM (the humanoid's three 128 x 132 matrices take 203 KB of the
// 227 KB a block may have), so the block's warps set the pace: each SM
// sub-partition issues the FMAs of its warps, ceil(warps / 4) of them.
// Thread (tx, ty) of a gy x gx grid owns a TR x 4 TQ tile of the product
// in registers: rows ty + gy r (r < TR), columns 4 (tx + gx h) + q
// (h < TQ, q < 4), with TR = 8 and TQ = 2 (an 8 x 8 tile): the humanoid
// (n = 125) on 16 x 16 threads, Cassie (n = 102) on 13 x 13. A product goes four k a pass: per row one 16-byte word of
// A (k .. k + 3, the same address for the warp's lanes of a row group),
// per k and column quad one 16-byte word of B; TR 4 TQ 4 fmaf to TR + 4 TQ
// shared loads. Pads (rows and columns past n) hold whatever the tiles
// put there; a pad feeds only pads, since every sum runs over k < n.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxBytes = 232448;  // 227 KB, a block's most

struct Geo {
  int n;       // N2
  int gy, gx;  // the thread grid: row groups, column-quad groups
  int ld;      // row stride
  int tx, ty, tid, nthreads;
};

// The thread grid and the shared layout of a tile at n
template <int TR, int TQ>
struct Layout {
  int gy, gx, rows, ld;
  __host__ __device__ explicit Layout(int n) {
    gy = (n + TR - 1) / TR;
    gx = (n + 4 * TQ - 1) / (4 * TQ);
    rows = gy * TR > n ? gy * TR : n;
    const int cols = 4 * TQ * gx;
    ld = ((cols > rows ? cols : rows) + 3) / 4 * 4;
    if (ld % 8 == 0) ld += 4;
  }
  __host__ __device__ int threads() const { return gy * gx; }
  __host__ __device__ int matrix() const { return rows * ld; }
  // M, X, 2I - P; the residual's row partials; its row sums
  __host__ __device__ int floats(int n) const {
    return 3 * matrix() + n * gx + n;
  }
};

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// acc = A B over k = 0 .. n-1 ascending, one fmaf a term from +0; four k
// a pass, the last n % 4 k one at a time
template <int TR, int TQ>
__device__ __forceinline__ void product(const float* A, const float* B,
                                        const Geo& g,
                                        float (&acc)[TR][4 * TQ]) {
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int c = 0; c < 4 * TQ; ++c) acc[r][c] = 0.f;
  const int rs = g.gy * g.ld, cs = 4 * g.gx;
  const float* a = A + g.ty * g.ld;
  const float* b = B + 4 * g.tx;
  const int n4 = g.n & ~3;
#pragma unroll 1
  for (int k = 0; k < n4; k += 4) {
    float4 av[TR], bv[4][TQ];
#pragma unroll
    for (int r = 0; r < TR; ++r)
      av[r] = *reinterpret_cast<const float4*>(a + r * rs + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < TQ; ++h)
        bv[kk][h] =
            *reinterpret_cast<const float4*>(b + (k + kk) * g.ld + h * cs);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < TR; ++r)
#pragma unroll
        for (int c = 0; c < 4 * TQ; ++c)
          acc[r][c] = __fmaf_rn(lane(av[r], kk), lane(bv[kk][c / 4], c % 4),
                                acc[r][c]);
  }
#pragma unroll 1
  for (int k = n4; k < g.n; ++k) {
    float av[TR];
    float4 bv[TQ];
#pragma unroll
    for (int r = 0; r < TR; ++r) av[r] = a[r * rs + k];
#pragma unroll
    for (int h = 0; h < TQ; ++h)
      bv[h] = *reinterpret_cast<const float4*>(b + k * g.ld + h * cs);
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int c = 0; c < 4 * TQ; ++c)
        acc[r][c] = __fmaf_rn(av[r], lane(bv[c / 4], c % 4), acc[r][c]);
  }
}

// C = acc (two_minus = false) or 0 - acc (true) over the whole tile
template <int TR, int TQ>
__device__ __forceinline__ void store(float* C,
                                      const float (&acc)[TR][4 * TQ],
                                      const Geo& g, bool two_minus) {
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    float* row = C + (g.ty + g.gy * r) * g.ld + 4 * g.tx;
#pragma unroll
    for (int h = 0; h < TQ; ++h) {
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float p = acc[r][4 * h + q];
        v[q] = two_minus ? 0.f - p : p;
      }
      *reinterpret_cast<float4*>(row + 4 * g.gx * h) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// After `store(C, acc, g, true)` and a barrier: C's diagonal 2 - P_ii
// (2 + (0 - P_ii) is 2 - P_ii exactly). Ends with a barrier.
__device__ __forceinline__ void two_on_diagonal(float* C, const Geo& g) {
  if (g.tid < g.n) {
    float* d = C + g.tid * (g.ld + 1);
    *d = 2.f + *d;
  }
  __syncthreads();
}

// The thread's geometry as values the compiler cannot hoist out of the
// chain's loop: the residual's masks and diagonal tests are recomputed at
// each use instead of holding a register each across the chain
__device__ __forceinline__ void opaque(const Geo& g, int& n, int& gy,
                                       int& gx, int& tx, int& ty) {
  n = g.n, gy = g.gy, gx = g.gx, tx = g.tx, ty = g.ty;
  asm volatile("" : "+r"(n), "+r"(gy), "+r"(gx), "+r"(tx), "+r"(ty));
}

// ||P - I||_inf of the product in the threads' tiles (inf when not
// finite), the same in every thread: a partial per row over the thread's
// columns, each row summed over its partials in order, the maximum over
// the rows in order. Ends with a barrier.
template <int TR, int TQ>
__device__ __forceinline__ float residual(const float (&acc)[TR][4 * TQ],
                                          float* part, float* rows,
                                          const Geo& g) {
  int n, gy, gx, tx, ty;
  opaque(g, n, gy, gx, tx, ty);
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    const int i = ty + gy * r;
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * TQ; ++c) {
      const int j = 4 * (tx + gx * (c / 4)) + c % 4;
      if (j < n) s += fabsf(acc[r][c] - (i == j ? 1.f : 0.f));
    }
    if (i < n) part[i * gx + tx] = s;
  }
  __syncthreads();
  if (g.tid < g.n) {
    float s = 0.f;
    for (int x = 0; x < g.gx; ++x) s += part[g.tid * g.gx + x];
    rows[g.tid] = s <= FLT_MAX ? s : INFINITY;  // NaN and inf read inf
  }
  __syncthreads();
  float m = 0.f;
  for (int i = 0; i < g.n; ++i) m = fmaxf(m, rows[i]);
  __syncthreads();
  return m;
}

// shared (n x n at stride ld) <- global (n x n, dense)
__device__ __forceinline__ void load(float* S, const float* __restrict__ G,
                                     const Geo& g) {
  for (int e = g.tid; e < g.n * g.n; e += g.nthreads)
    S[(e / g.n) * g.ld + e % g.n] = G[e];
}

__device__ __forceinline__ void save(float* __restrict__ G, const float* S,
                                     const Geo& g) {
  for (int e = g.tid; e < g.n * g.n; e += g.nthreads)
    G[e] = S[(e / g.n) * g.ld + e % g.n];
}

template <int TR, int TQ>
__global__ void __launch_bounds__(kMaxThreads)
    polish_ns_chain(const float* __restrict__ M, const float* __restrict__ den,
                    const float* __restrict__ X0, float* __restrict__ out,
                    float* __restrict__ r_out, const int64_t* __restrict__ idx,
                    const uint8_t* __restrict__ keep, int n, int iters,
                    int steps) {
  const int b = blockIdx.x;
  if (keep != nullptr && keep[b] == 0) return;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout<TR, TQ> lay(n);
  Geo g;
  g.n = n;
  g.gy = lay.gy;
  g.gx = lay.gx;
  g.ld = lay.ld;
  g.tid = threadIdx.x;
  g.nthreads = blockDim.x;
  g.tx = g.tid % g.gx;
  g.ty = g.tid / g.gx;
  const int mat = lay.matrix();
  float* sM = smem;
  float* sX = sM + mat;
  float* sQ = sX + mat;
  float* part = sQ + mat;
  float* rows = part + n * g.gx;
  const size_t nn = (size_t)n * n;
  const int64_t slot = idx != nullptr ? idx[b] : b;
  float* dst = out + slot * nn;

  for (int e = g.tid; e < 3 * mat; e += g.nthreads) smem[e] = 0.f;
  __syncthreads();
  load(sM, M + b * nn, g);
  float acc[TR][4 * TQ];

  if (X0 == nullptr) {  // seed
    __syncthreads();
    const float d = den[b];
    for (int e = g.tid; e < n * n; e += g.nthreads) {
      const int i = e / n, j = e % n;
      sX[i * g.ld + j] = sM[j * g.ld + i] / d;
    }
    __syncthreads();
    for (int it = 0; it < iters; ++it) {
      product<TR, TQ>(sM, sX, g, acc);
      store<TR, TQ>(sQ, acc, g, true);
      __syncthreads();
      two_on_diagonal(sQ, g);
      product<TR, TQ>(sX, sQ, g, acc);
      __syncthreads();
      store<TR, TQ>(sX, acc, g, false);
      __syncthreads();
    }
    save(dst, sX, g);
    return;
  }

  // refresh: X_best lives in X0 (the input) until an iterate beats it,
  // then in `out`
  const float* x0 = X0 + b * nn;
  load(sX, x0, g);
  __syncthreads();
  product<TR, TQ>(sM, sX, g, acc);
  float r = residual<TR, TQ>(acc, part, rows, g);
  store<TR, TQ>(sQ, acc, g, true);
  __syncthreads();
  two_on_diagonal(sQ, g);
  float r_best = r;
  bool best_in_input = true;
  bool x_is_best = true;
  for (int s = 0; s < steps; ++s) {
    if (!(r < 1.f) && !x_is_best) {  // restart from the best iterate
      load(sX, best_in_input ? x0 : dst, g);
      __syncthreads();
      product<TR, TQ>(sM, sX, g, acc);
      store<TR, TQ>(sQ, acc, g, true);
      __syncthreads();
      two_on_diagonal(sQ, g);
    }
    product<TR, TQ>(sX, sQ, g, acc);
    __syncthreads();
    store<TR, TQ>(sX, acc, g, false);
    __syncthreads();
    product<TR, TQ>(sM, sX, g, acc);
    r = residual<TR, TQ>(acc, part, rows, g);
    store<TR, TQ>(sQ, acc, g, true);
    __syncthreads();
    two_on_diagonal(sQ, g);
    x_is_best = r < r_best;
    if (x_is_best) {
      save(dst, sX, g);
      best_in_input = false;
      r_best = r;
    }
  }
  if (best_in_input)
    for (size_t e = g.tid; e < nn; e += g.nthreads) dst[e] = x0[e];
  if (g.tid == 0) r_out[b] = r_best;
}

// The thread tile: TR rows by 4 TQ columns
constexpr int kTR = 8, kTQ = 2;

// Whether a chain at n fits a block, and its shared bytes and threads: up
// to n = 128 (16 x 16 threads; ops/polish.py, NS_KERNEL_MAX_N2)
bool fits(int n, int* bytes, int* threads) {
  if (n < 1) return false;
  const Layout<kTR, kTQ> lay(n);
  const size_t b = sizeof(float) * (size_t)lay.floats(n);
  if (b > (size_t)kMaxBytes || lay.threads() > kMaxThreads) return false;
  *bytes = (int)b;
  *threads = lay.threads();
  return true;
}

}  // namespace

extern "C" {

// Once, before any launch: lets the kernel take up to 227 KB of
// shared memory. Returns the cudaError_t.
int polish_ns_init(void) {
  return (int)cudaFuncSetAttribute(
      polish_ns_chain<kTR, kTQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxBytes);
}

// One chain per block, B blocks on `stream`. Seed: X0 null, den (B,),
// iters; idx (B,) int64 and keep (B,) bytes may be null. Refresh: X0
// (B, n, n), r_out (B,), steps. Returns the cudaError_t of the launch.
int polish_ns(const float* M, const float* den, const float* X0, float* out,
              float* r_out, const int64_t* idx, const uint8_t* keep, int B,
              int n, int iters, int steps, void* stream) {
  int bytes = 0, threads = 0;
  if (!fits(n, &bytes, &threads) || B < 1) return (int)cudaErrorInvalidValue;
  polish_ns_chain<kTR, kTQ><<<B, threads, bytes, (cudaStream_t)stream>>>(
      M, den, X0, out, r_out, idx, keep, n, iters, steps);
  return (int)cudaGetLastError();
}

}  // extern "C"
