// The whole adaptive line search of the PMF lookahead refit, every lane in
// one launch, for Hopper (sm_90a).
//
// Replaces the Pallas kernel pmf_lookahead_fused_t of
// amf_tpu/ops/pallas_kernels.py (body `_kernel_fused`). Lane l is the shared
// base problem (ratings R, mask) with its own cell (di, dj) set to rated with
// value dv. Every lane starts at the base factors (U0, V0) and minimises
//
//     f(U, V) = sum E^2 / 2s + sum U^2 / 2su + sum V^2 / 2sv,
//     E = mask * (R - U V^T),  ascent G = (E V / s - U / su, E^T U / s - V / sv)
//
// by the reference's accept/reject ascent: evaluate f and G at the start,
// then for max_steps steps propose (U, V) + lr G; accept if f falls
// (lr *= 1.25, converged if it fell by less than stop_thresh) or reject
// (lr *= 0.5, converged if lr / 2 < min_lr). A converged lane stops.
//
// Types: the lane's factors and gradients are stored in `T` (float or bf16);
// a proposal is formed in float from that storage; the products take the
// proposal rounded to `T`, and with bf16 the scaled residual E / s is rounded
// to bf16 before the two gradient contractions; the squared error, the prior
// terms of f and of G take the float proposal; every sum is float.
//
// What bounds it on this card: each evaluation needs ~6 d multiply-adds on
// each rated cell and the lane's own cell (pred, Gu, Gv), ~0.3 MFLOP a lane
// at the MovieLens-100k shape (943 x 1682, d = 10, ~5,000 rated cells), over
// up to 1 + max_steps evaluations; its bytes are R and the mask once and the
// final factors once. Dense, the TPU kernel does ~1,000x more products. So
// the bound is set by operations; in practice by latency: every step is a
// chain of dependent passes over a lane's ~26,000 factor values.
// What the design does about it:
//   * the wrapper indexes the rated cells of the shared mask once per call,
//     by row (CSR) and by column (CSC), with R's values beside them; the
//     kernel walks only those cells and never scans the (n, m) mask. The
//     lane's own cell is handled explicitly: if it is rated, its value is
//     replaced by dv; if not, one term is added to row di and column dj;
//   * one thread block per lane runs the whole line search, with
//     __syncthreads() between its phases: propose; a row pass (a thread per
//     row) that gives Gu and the squared error; a column pass (a thread per
//     column) that gives Gv; a block reduction, in a fixed order, of the
//     squared error and the priors; one thread decides accept, converged
//     and the new lr. No atomics: f is the same bit for bit from run to run,
//     so the accept test f' < f cannot flip between runs;
//   * the lane's state (factors and gradients, the outputs) and its float
//     proposal temporaries live in global scratch that the wrapper
//     allocates, (rows, d) a lane so that one row's d values are adjacent;
//     R and the indices are shared by all lanes and stay in L2;
//   * lanes that converge leave the loop; d (<= 32) is bucketed to 8, 16 or
//     32 at compile time so a row of factors sits in registers.
// One block per lane fills 128 of the 132 SMs at L = 128; fewer lanes leave
// SMs idle. Shared-memory staging of the lane's factors, and more than one
// block a lane, are left for a later change.
//
// C interface (loaded with ctypes): amf_pmf_lookahead_fused(...), at the
// bottom of this file. Returns the cudaError_t of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back: what the products take
template <typename T>
__device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

struct Args {
  const void* u0;         // (n, d) base factors, type T
  const void* v0;         // (m, d)
  const int32_t* row_ptr; // (n + 1,) rated cells by row (CSR)
  const int32_t* col_idx; // (nnz,)
  const void* r_row;      // (nnz,) R of those cells, type T
  const int32_t* col_ptr; // (m + 1,) rated cells by column (CSC)
  const int32_t* row_idx; // (nnz,)
  const void* r_col;      // (nnz,)
  const int32_t* di;      // (L,)
  const int32_t* dj;      // (L,)
  const float* dv;        // (L,)
  const float* sig;       // (3,) sigma^2, sigma_u^2, sigma_v^2
  const float* ls;        // (3,) lr0, stop_thresh, min_lr
  void* u;                // (L, n, d) type T: accepted factors (output)
  void* v;                // (L, m, d)
  void* gu;               // (L, n, d) type T: gradients at the accepted point
  void* gv;               // (L, m, d)
  float* up;              // (L, n, d) float proposal
  float* vp;              // (L, m, d)
  float* gup;             // (L, n, d) float gradients at the proposal
  float* gvp;             // (L, m, d)
  float* f;               // (L,) final value (output)
  int32_t* evals;         // (L,) evaluations made (output)
  int64_t n, m;
  int d, max_steps;
};

struct Lane {  // one lane's proposal buffers and cell
  float* up;
  float* vp;
  float* gup;
  float* gvp;
  int64_t di, dj;
  float dv;
};

// One cell of a residual walk: x holds one side's factors as the products
// take them, y points at the other side's float proposal. Adds the cell's
// squared error to sq and its scaled residual times y to g. The row pass
// and the column pass form pred from the same products in the same order,
// so both see the same residual.
template <typename T, int DMAX>
__device__ __forceinline__ void add_cell(const float (&x)[DMAX], const float* y,
                                         float r, int d, float inv_sig,
                                         float (&g)[DMAX], float& sq) {
  float pred = 0.0f;
#pragma unroll
  for (int k = 0; k < DMAX; ++k)
    if (k < d) pred = fmaf(x[k], rnd<T>(y[k]), pred);
  const float e = r - pred;
  sq = fmaf(e, e, sq);
  const float rs = rnd<T>(e * inv_sig);
#pragma unroll
  for (int k = 0; k < DMAX; ++k)
    if (k < d) g[k] = fmaf(rs, rnd<T>(y[k]), g[k]);
}

// f and the gradients at the lane's proposal (up, vp); writes gup and gvp.
// Every thread of the block calls it and gets f.
template <typename T, int DMAX, int NT>
__device__ float evaluate(const Args& a, const Lane& ln, float (*red)[NT]) {
  const int tid = threadIdx.x;
  const int d = a.d;
  const float inv_sig = 1.0f / a.sig[0];
  const float s_u = a.sig[1], s_v = a.sig[2];
  const T* r_row = (const T*)a.r_row;
  const T* r_col = (const T*)a.r_col;
  float sq = 0.0f, pu2 = 0.0f, pv2 = 0.0f, unused = 0.0f;

  // row pass: Gu and the squared error
  for (int64_t i = tid; i < a.n; i += NT) {
    const float* ui = ln.up + i * d;
    float x[DMAX], g[DMAX];
#pragma unroll
    for (int k = 0; k < DMAX; ++k) {
      const float t = k < d ? ui[k] : 0.0f;
      pu2 = fmaf(t, t, pu2);
      x[k] = rnd<T>(t);
      g[k] = 0.0f;
    }
    const bool mine = i == ln.di;
    bool found = false;
    for (int e = a.row_ptr[i]; e < a.row_ptr[i + 1]; ++e) {
      const int64_t j = a.col_idx[e];
      const bool hit = mine && j == ln.dj;
      found |= hit;
      add_cell<T, DMAX>(x, ln.vp + j * d, hit ? ln.dv : to_f(r_row[e]), d,
                        inv_sig, g, sq);
    }
    if (mine && !found)  // the lane's cell, not rated in the base
      add_cell<T, DMAX>(x, ln.vp + ln.dj * d, ln.dv, d, inv_sig, g, sq);
    float* gi = ln.gup + i * d;
#pragma unroll
    for (int k = 0; k < DMAX; ++k)
      if (k < d) gi[k] = g[k] - ui[k] / s_u;
  }

  // column pass: Gv
  for (int64_t j = tid; j < a.m; j += NT) {
    const float* vj = ln.vp + j * d;
    float x[DMAX], g[DMAX];
#pragma unroll
    for (int k = 0; k < DMAX; ++k) {
      const float t = k < d ? vj[k] : 0.0f;
      pv2 = fmaf(t, t, pv2);
      x[k] = rnd<T>(t);
      g[k] = 0.0f;
    }
    const bool mine = j == ln.dj;
    bool found = false;
    for (int e = a.col_ptr[j]; e < a.col_ptr[j + 1]; ++e) {
      const int64_t i = a.row_idx[e];
      const bool hit = mine && i == ln.di;
      found |= hit;
      add_cell<T, DMAX>(x, ln.up + i * d, hit ? ln.dv : to_f(r_col[e]), d,
                        inv_sig, g, unused);
    }
    if (mine && !found)
      add_cell<T, DMAX>(x, ln.up + ln.di * d, ln.dv, d, inv_sig, g, unused);
    float* gj = ln.gvp + j * d;
#pragma unroll
    for (int k = 0; k < DMAX; ++k)
      if (k < d) gj[k] = g[k] - vj[k] / s_v;
  }

  // f = sq / 2s + |up|^2 / 2su + |vp|^2 / 2sv, each sum in a fixed order
  red[0][tid] = sq;
  red[1][tid] = pu2;
  red[2][tid] = pv2;
  __syncthreads();
  for (int w = NT / 2; w > 0; w >>= 1) {
    if (tid < w) {
#pragma unroll
      for (int q = 0; q < 3; ++q) red[q][tid] += red[q][tid + w];
    }
    __syncthreads();
  }
  const float f = red[0][0] / (2.0f * a.sig[0]) + red[1][0] / (2.0f * s_u) +
                  red[2][0] / (2.0f * s_v);
  __syncthreads();  // red is written again by the next evaluation
  return f;
}

// the lane's state takes the proposal and its gradients
template <typename T, int NT>
__device__ void commit(const Lane& ln, T* u, T* v, T* gu, T* gv, int64_t nd,
                       int64_t md) {
  for (int64_t x = threadIdx.x; x < nd; x += NT) {
    u[x] = from_f<T>(ln.up[x]);
    gu[x] = from_f<T>(ln.gup[x]);
  }
  for (int64_t x = threadIdx.x; x < md; x += NT) {
    v[x] = from_f<T>(ln.vp[x]);
    gv[x] = from_f<T>(ln.gvp[x]);
  }
}

template <typename T, int DMAX, int NT>
__global__ void __launch_bounds__(NT) fused(Args a) {
  __shared__ float red[3][NT];
  __shared__ float s_f, s_lr;
  __shared__ int s_done, s_accept;
  const int tid = threadIdx.x;
  const int64_t l = blockIdx.x;
  const int64_t nd = a.n * a.d, md = a.m * a.d;
  const Lane ln{a.up + l * nd, a.vp + l * md, a.gup + l * nd, a.gvp + l * md,
                a.di[l], a.dj[l], a.dv[l]};
  T* u = (T*)a.u + l * nd;
  T* v = (T*)a.v + l * md;
  T* gu = (T*)a.gu + l * nd;
  T* gv = (T*)a.gv + l * md;

  // init: evaluate at the base factors
  for (int64_t x = tid; x < nd; x += NT) ln.up[x] = to_f(((const T*)a.u0)[x]);
  for (int64_t x = tid; x < md; x += NT) ln.vp[x] = to_f(((const T*)a.v0)[x]);
  __syncthreads();
  const float f0 = evaluate<T, DMAX, NT>(a, ln, red);
  commit<T, NT>(ln, u, v, gu, gv, nd, md);
  if (tid == 0) {
    s_f = f0;
    s_lr = a.ls[0];
    s_done = 0;
  }
  int evals = 1;
  __syncthreads();

  for (int step = 0; step < a.max_steps && !s_done; ++step) {
    const float lr = s_lr;
    // proposal in float from the stored state; no fused multiply-add, as
    // in the plain version: round(u + round(lr * g))
    for (int64_t x = tid; x < nd; x += NT)
      ln.up[x] = __fadd_rn(to_f(u[x]), __fmul_rn(lr, to_f(gu[x])));
    for (int64_t x = tid; x < md; x += NT)
      ln.vp[x] = __fadd_rn(to_f(v[x]), __fmul_rn(lr, to_f(gv[x])));
    __syncthreads();
    const float fp = evaluate<T, DMAX, NT>(a, ln, red);
    ++evals;
    if (tid == 0) {
      const float f_old = s_f;
      const bool accept = isfinite(fp) && fp < f_old;
      const bool conv = accept ? (f_old - fp) < a.ls[1] : lr * 0.5f < a.ls[2];
      if (accept) {
        s_f = fp;
        s_lr = lr * 1.25f;
      } else {
        s_lr = lr * 0.5f;
      }
      s_accept = accept;
      s_done = conv;
    }
    __syncthreads();
    if (s_accept) commit<T, NT>(ln, u, v, gu, gv, nd, md);
    __syncthreads();
  }
  if (tid == 0) {
    a.f[l] = s_f;
    a.evals[l] = evals;
  }
}

template <typename T, int DMAX>
cudaError_t launch(const Args& a, int64_t L, cudaStream_t stream) {
  // 512 threads keep a d <= 16 row in registers (<= 128 a thread); 256 at 32
  constexpr int NT = DMAX <= 16 ? 512 : 256;
  fused<T, DMAX, NT><<<(unsigned)L, NT, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_width(const Args& a, int64_t L, cudaStream_t stream) {
  if (a.d <= 8) return launch<T, 8>(a, L, stream);
  if (a.d <= 16) return launch<T, 16>(a, L, stream);
  return launch<T, 32>(a, L, stream);
}

}  // namespace

// in_bf16: 0 when the state, the base factors and R are float, 1 when bf16.
extern "C" int amf_pmf_lookahead_fused(
    int in_bf16, const void* u0, const void* v0, const int32_t* row_ptr,
    const int32_t* col_idx, const void* r_row, const int32_t* col_ptr,
    const int32_t* row_idx, const void* r_col, const int32_t* di,
    const int32_t* dj, const float* dv, const float* sig, const float* ls,
    void* u, void* v, void* gu, void* gv, float* up, float* vp, float* gup,
    float* gvp, float* f, int32_t* evals, long long L, long long n,
    long long m, int d, int max_steps, void* stream) {
  if (L < 1 || L > 65535 || n < 1 || m < 1 || n > 0x7fffffffLL ||
      m > 0x7fffffffLL || d < 1 || d > 32 || max_steps < 0)
    return (int)cudaErrorInvalidValue;
  Args a{u0, v0, row_ptr, col_idx, r_row, col_ptr, row_idx, r_col,
         di, dj, dv, sig, ls, u, v, gu, gv, up, vp, gup, gvp, f, evals,
         (int64_t)n, (int64_t)m, d, max_steps};
  cudaStream_t s = (cudaStream_t)stream;
  if (in_bf16) return (int)by_width<__nv_bfloat16>(a, (int64_t)L, s);
  return (int)by_width<float>(a, (int64_t)L, s);
}
