// Fused ADMM iteration chunks of the reduced FCCQP engine, for Hopper
// (sm_90a). Two precisions share one template:
//
//   admm_chunk_f64  replaces fcc_qp_tpu/ops/pallas_admm.py::admm_chunk_pallas
//                   (Pallas body `_kernel`), which runs the endgame in
//                   double-single because the TPU has no f64 ALU; here it
//                   is native f64, with the primal-increment gate.
//   admm_chunk_f32  replaces fcc_qp_tpu/ops/pallas_admm.py::admm_chunk_pallas32
//                   (Pallas body `_kernel32`), the plain-f32 approach phase.
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
// Design: one thread per instance. The batch is the last axis, so thread
// b's loads of F[j][i][b] coalesce across the warp, and each thread loops
// over its own iterations with no padding to a tile and no masked work.
// No contraction of mul+add into FMA (the library is built with
// --fmad=false): the kernel then rounds exactly like the plain PyTorch
// version in fcc_qp_tpu_torch/ops/pallas_admm.py, which is what the
// on-card check holds it to.
//
// Bound: per chunk the operator F is k*k*B*(8|4) bytes and the state in
// and out about 2*(5k + 8)*B*(8|4) bytes; the work is about
// (2k^2 + O(k)) * B * K flops. At Cassie (k = 22, B = 8192) F is 31.7 MB
// in f64 (15.9 MB in f32): it fits in the 50 MB L2, and the chunk is
// bound by the rate at which each SM streams F through L1 and by the
// per-thread local-memory state. This first version does nothing about
// that bound: it re-reads F from L2 on every iteration and keeps the
// state in local memory (runtime k, arrays sized for k <= 64).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int KMAX = 64;

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
__global__ void __launch_bounds__(128) admm_chunk_kernel(ChunkArgs<T> a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const int B = a.B, k = a.k, kb = a.kb;
  const int ncones = (k - kb) / 3;

  T x[KMAX], s[KMAX], mu[KMAX], v[KMAX], y[KMAX];
  for (int i = 0; i < k; ++i) {
    x[i] = a.x_in[i * B + b];
    s[i] = a.s_in[i * B + b];
    mu[i] = a.mu_in[i * B + b];
    v[i] = a.v_in[i * B + b];
  }
  int done = a.done_in[b];
  int niter = a.niter_in[b];
  int itv = a.itv_in[b];
  T xrn = a.xrn_in[b], lrn = a.lrn_in[b];
  T prim = a.prim_in[b], dual = a.dual_in[b];
  const T rho = a.rho[b];

  for (int it = 0; it < a.K; ++it) {
    if (done != 0 || itv >= a.max_iter) break;

    // v = s - mu ; y = F^T v, accumulated over j in ascending order
    for (int j = 0; j < k; ++j) v[j] = s[j] - mu[j];
    for (int i = 0; i < k; ++i) y[i] = a.F[i * B + b] * v[0];
    for (int j = 1; j < k; ++j) {
      const T* Fj = a.F + (size_t)j * k * B;
      const T vj = v[j];
      for (int i = 0; i < k; ++i) y[i] = y[i] + Fj[i * B + b] * vj;
    }

    T n_xrn = 0, n_lrn = 0, x_inc = 0, l_inc = 0, pp = 0, dd = 0;
    // box rows
    for (int i = 0; i < kb; ++i) {
      const T xi = a.xc[i * B + b] + rho * y[i];
      const T t = xi + mu[i];
      const T si = tclip(t, a.lb[i * B + b], a.ub[i * B + b]);
      const T r = xi - si;
      const T wi = a.w[i * B + b];
      n_xrn = tmax(n_xrn, tabs(r) * wi);
      x_inc = tmax(x_inc, tabs(xi - x[i]) * wi);
      const T dp = r * wi;
      const T dc = (si - s[i]) * wi;
      pp = pp + dp * dp;
      dd = dd + dc * dc;
      mu[i] = mu[i] + r;
      x[i] = xi;
      s[i] = si;
    }
    // cone rows, one friction cone (fx, fy, fz) at a time
    for (int c = 0; c < ncones; ++c) {
      const int i0 = kb + 3 * c;
      T xi3[3], t3[3], p3[3];
      for (int q = 0; q < 3; ++q) {
        xi3[q] = a.xc[(i0 + q) * B + b] + rho * y[i0 + q];
        t3[q] = xi3[q] + mu[i0 + q];
      }
      const T fx = t3[0], fy = t3[1], fz = t3[2];
      const T m = a.muf[c * B + b];
      const T norm = tsqrt<T>(fx * fx + fy * fy);
      const bool inside = m * fz - norm >= T(0);
      const bool polar = fz + m * norm < T(0);
      const T tt = (m * norm + fz) / (m * m + T(1));
      const T safe = norm > T(0) ? norm : T(1);
      const T sc = tt * m / safe;
      p3[0] = inside ? fx : (polar ? T(0) : sc * fx);
      p3[1] = inside ? fy : (polar ? T(0) : sc * fy);
      p3[2] = inside ? fz : (polar ? T(0) : tt);
      for (int q = 0; q < 3; ++q) {
        const int i = i0 + q;
        const T r = xi3[q] - p3[q];
        const T wi = a.w[i * B + b];
        n_lrn = tmax(n_lrn, tabs(r) * wi);
        l_inc = tmax(l_inc, tabs(xi3[q] - x[i]) * wi);
        const T dp = r * wi;
        const T dc = (p3[q] - s[i]) * wi;
        pp = pp + dp * dp;
        dd = dd + dc * dc;
        mu[i] = mu[i] + r;
        x[i] = xi3[q];
        s[i] = p3[q];
      }
    }

    bool conv = (n_lrn < a.eps_f) && (n_xrn < a.eps_b);
    if (a.inc_gate) conv = conv && (x_inc < a.eps_b) && (l_inc < a.eps_f);
    xrn = n_xrn;
    lrn = n_lrn;
    prim = tsqrt<T>(pp);
    dual = rho * tsqrt<T>(dd);
    if (conv) {
      niter = itv;
      done = 1;
    }
    itv = itv + 1;
  }

  for (int i = 0; i < k; ++i) {
    a.x_out[i * B + b] = x[i];
    a.s_out[i * B + b] = s[i];
    a.mu_out[i * B + b] = mu[i];
    a.v_out[i * B + b] = v[i];
  }
  a.done_out[b] = done;
  a.niter_out[b] = niter;
  a.itv_out[b] = itv;
  a.xrn_out[b] = xrn;
  a.lrn_out[b] = lrn;
  a.prim_out[b] = prim;
  a.dual_out[b] = dual;
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
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  admm_chunk_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
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
