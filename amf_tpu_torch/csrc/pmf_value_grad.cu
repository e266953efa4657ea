// Per-lane PMF value and ascent gradients for Hopper (sm_90a).
//
// Replaces both Pallas kernels of amf_tpu/ops/pallas_kernels.py that compute
// this function: pmf_batched_value_grad (body `_kernel`, factors (L, rows, d))
// and pmf_batched_value_grad_t (body `_kernel_v2`, factors (L, d, rows)). One
// body serves both layouts: it is given each factor's element strides
// (lane, row, k). For every lane l, with the shared base ratings R and mask,
// and the lane's own cell (di, dj) set to rated with value dv:
//
//     E     = mask * (R - U V^T)
//     sqerr = sum E^2
//     Gu    = (E / s) V - U / su,     Gv = (E / s)^T U - V / sv
//
// with s, su, sv = sigma^2, sigma_u^2, sigma_v^2. The prior terms of the
// value are added by the caller. Inputs are float or bf16 (`T`), gradients
// float or bf16 (`TO`); every product and sum is taken in float. With
// `kRound` the scaled residual E / s is rounded to bf16 before the two
// gradient contractions, as the TPU kernel's bf16 path does.
//
// What bounds it on this card: the data term and both gradients involve only
// the rated cells and the lane's own cell, and E is exactly 0 elsewhere, so
// the kernel does the products only there. At the MovieLens-100k shape
// (943 x 1682, d = 10, ~0.3 % of cells rated in the smoke's data) that is
// ~3 * 5,000 * 10 multiply-adds a lane instead of ~3 * 1.6M * 10 dense, and
// the kernel is bound by the bytes it streams: the mask (1 byte a cell) once
// in each pass, R where rated, the factors in and the gradients out. R and
// the mask (8 MB in f32) are shared by all lanes and stay in the 50 MB L2.
// What the design does about it:
//   * row pass: one warp per (lane, row); its 32 threads walk the row's
//     columns side by side, so the mask and R reads are coalesced. Each
//     thread keeps partial sums of Gu and of the squared error, and a
//     butterfly of warp shuffles adds them in a fixed order;
//   * column pass: one thread per (lane, column); the threads of a warp read
//     neighbouring columns of the same row, again coalesced, and keep Gv in
//     registers. Mask bytes are loaded 8 rows ahead of their use;
//   * the per-row squared errors are summed by a third, small launch in a
//     fixed order. No atomics anywhere: the value is bitwise the same from
//     run to run, so the line search's accept test `f' < f` cannot change
//     between runs;
//   * the factor width d (<= 32) is bucketed to 8, 16 or 32 at compile time
//     so rows of U and V live in registers; lanes past d are masked.
// Shared-memory staging of V, wgmma and TMA are left for a later change.
//
// C interface (loaded with ctypes): amf_pmf_value_grad(...), see the bottom
// of this file. Returns the cudaError_t of the launches (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowWarps = 8;       // rows of one lane per block, row pass
constexpr int kColThreads = 128;   // columns of one lane per block, column pass
constexpr int kColAhead = 8;       // mask bytes loaded ahead, column pass
constexpr int kSumThreads = 256;   // threads of the final sum, one block a lane

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

struct Strides {
  int64_t lane, row, k;  // element strides of a factor and of its gradient
};

struct Args {
  const void* U;
  const void* V;
  const void* R;          // (n, m) row-major, type T
  const uint8_t* mask;    // (n, m) row-major, 0 or 1
  const int32_t* di;      // (L,)
  const int32_t* dj;      // (L,)
  const float* dv;        // (L,)
  const float* sig;       // (3,) sigma^2, sigma_u^2, sigma_v^2
  void* gu;               // like U, type TO
  void* gv;               // like V, type TO
  float* row_sq;          // (L, n) scratch: squared error of each row
  float* sqerr;           // (L,)
  int64_t n, m;
  int d;
  Strides su, sv;
};

template <bool kRound>
__device__ __forceinline__ float scaled_resid(float e, float inv_sig) {
  const float r = e * inv_sig;
  return kRound ? __bfloat162float(__float2bfloat16(r)) : r;
}

// Row pass: Gu and the squared error of every row.
template <typename T, typename TO, bool kRound, int DMAX>
__global__ void __launch_bounds__(kRowWarps * 32) row_pass(Args a) {
  const int warp = threadIdx.x >> 5;
  const int tid = threadIdx.x & 31;
  const int64_t i = (int64_t)blockIdx.x * kRowWarps + warp;
  const int64_t l = blockIdx.y;
  if (i >= a.n) return;  // the whole warp leaves together

  const T* U = (const T*)a.U + l * a.su.lane + i * a.su.row;
  const T* V = (const T*)a.V + l * a.sv.lane;
  const T* R = (const T*)a.R + i * a.m;
  const uint8_t* M = a.mask + i * a.m;
  const float inv_sig = 1.0f / a.sig[0];
  const int64_t hit_j = a.di[l] == i ? (int64_t)a.dj[l] : -1;
  const float hit_v = a.dv[l];

  float u[DMAX], g[DMAX];
#pragma unroll
  for (int k = 0; k < DMAX; ++k) {
    u[k] = k < a.d ? to_f(U[k * a.su.k]) : 0.0f;
    g[k] = 0.0f;
  }
  float sq = 0.0f;
  for (int64_t j = tid; j < a.m; j += 32) {
    const bool hit = j == hit_j;
    if (!(M[j] || hit)) continue;  // E = 0 off the rated cells
    const float r = hit ? hit_v : to_f(R[j]);
    const T* vj = V + j * a.sv.row;
    float v[DMAX];
    float pred = 0.0f;
#pragma unroll
    for (int k = 0; k < DMAX; ++k) {
      v[k] = k < a.d ? to_f(vj[k * a.sv.k]) : 0.0f;
      pred = fmaf(u[k], v[k], pred);
    }
    const float e = r - pred;
    sq = fmaf(e, e, sq);
    const float rs = scaled_resid<kRound>(e, inv_sig);
#pragma unroll
    for (int k = 0; k < DMAX; ++k) g[k] = fmaf(rs, v[k], g[k]);
  }
  // butterfly: a + b == b + a, so every thread ends with the same totals
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
#pragma unroll
    for (int k = 0; k < DMAX; ++k) g[k] += __shfl_xor_sync(0xffffffffu, g[k], off);
  }
  if (tid == 0) a.row_sq[l * a.n + i] = sq;
  TO* gu = (TO*)a.gu + l * a.su.lane + i * a.su.row;
  const float s_u = a.sig[1];
#pragma unroll
  for (int k = 0; k < DMAX; ++k)
    if (k == tid && k < a.d) gu[k * a.su.k] = from_f<TO>(g[k] - u[k] / s_u);
}

// Column pass: Gv of every column.
template <typename T, typename TO, bool kRound, int DMAX>
__global__ void __launch_bounds__(kColThreads) col_pass(Args a) {
  const int64_t j = (int64_t)blockIdx.x * kColThreads + threadIdx.x;
  const int64_t l = blockIdx.y;
  if (j >= a.m) return;

  const T* U = (const T*)a.U + l * a.su.lane;
  const T* vj = (const T*)a.V + l * a.sv.lane + j * a.sv.row;
  const T* R = (const T*)a.R + j;
  const uint8_t* M = a.mask + j;
  const float inv_sig = 1.0f / a.sig[0];
  const int64_t hit_i = a.dj[l] == j ? (int64_t)a.di[l] : -1;
  const float hit_v = a.dv[l];

  float v[DMAX], g[DMAX];
#pragma unroll
  for (int k = 0; k < DMAX; ++k) {
    v[k] = k < a.d ? to_f(vj[k * a.sv.k]) : 0.0f;
    g[k] = 0.0f;
  }
  for (int64_t i0 = 0; i0 < a.n; i0 += kColAhead) {
    uint8_t mk[kColAhead];
#pragma unroll
    for (int t = 0; t < kColAhead; ++t)
      mk[t] = i0 + t < a.n ? M[(i0 + t) * a.m] : 0;
#pragma unroll
    for (int t = 0; t < kColAhead; ++t) {
      const int64_t i = i0 + t;
      const bool hit = i == hit_i;
      if (!(mk[t] || hit)) continue;  // E = 0 off the rated cells
      const float r = hit ? hit_v : to_f(R[i * a.m]);
      const T* ui = U + i * a.su.row;
      float uu[DMAX];
      float pred = 0.0f;
#pragma unroll
      for (int k = 0; k < DMAX; ++k) {
        uu[k] = k < a.d ? to_f(ui[k * a.su.k]) : 0.0f;
        pred = fmaf(uu[k], v[k], pred);
      }
      const float rs = scaled_resid<kRound>(r - pred, inv_sig);
#pragma unroll
      for (int k = 0; k < DMAX; ++k) g[k] = fmaf(rs, uu[k], g[k]);
    }
  }
  TO* gv = (TO*)a.gv + l * a.sv.lane + j * a.sv.row;
  const float s_v = a.sig[2];
#pragma unroll
  for (int k = 0; k < DMAX; ++k)
    if (k < a.d) gv[k * a.sv.k] = from_f<TO>(g[k] - v[k] / s_v);
}

// sqerr[l] = sum over rows of row_sq[l, :], in a fixed order.
__global__ void __launch_bounds__(kSumThreads) sum_rows(Args a) {
  __shared__ float part[kSumThreads];
  const int64_t l = blockIdx.x;
  const float* rs = a.row_sq + l * a.n;
  float s = 0.0f;
  for (int64_t i = threadIdx.x; i < a.n; i += kSumThreads) s += rs[i];
  part[threadIdx.x] = s;
  __syncthreads();
  for (int w = kSumThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) part[threadIdx.x] += part[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) a.sqerr[l] = part[0];
}

template <typename T, typename TO, bool kRound, int DMAX>
cudaError_t launch(const Args& a, int64_t L, cudaStream_t stream) {
  const dim3 row_grid((unsigned)((a.n + kRowWarps - 1) / kRowWarps), (unsigned)L);
  row_pass<T, TO, kRound, DMAX><<<row_grid, kRowWarps * 32, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 col_grid((unsigned)((a.m + kColThreads - 1) / kColThreads), (unsigned)L);
  col_pass<T, TO, kRound, DMAX><<<col_grid, kColThreads, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_rows<<<(unsigned)L, kSumThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename TO, bool kRound>
cudaError_t by_width(const Args& a, int64_t L, cudaStream_t stream) {
  if (a.d <= 8) return launch<T, TO, kRound, 8>(a, L, stream);
  if (a.d <= 16) return launch<T, TO, kRound, 16>(a, L, stream);
  return launch<T, TO, kRound, 32>(a, L, stream);
}

}  // namespace

// in_bf16 / out_bf16: 0 for float, 1 for bf16. The combinations taken are
// (float in, float out), (bf16 in, float out) and (bf16 in, bf16 out, with
// the residual rounded: round_resid = 1). Strides are in elements; U and Gu
// share u_*, V and Gv share v_*.
extern "C" int amf_pmf_value_grad(
    int in_bf16, int out_bf16, int round_resid, const void* U, const void* V,
    const void* R, const uint8_t* mask, const int32_t* di, const int32_t* dj,
    const float* dv, const float* sig, void* gu, void* gv, float* row_sq,
    float* sqerr, long long L, long long n, long long m, int d,
    long long u_lane, long long u_row, long long u_k, long long v_lane,
    long long v_row, long long v_k, void* stream) {
  if (L < 1 || L > 65535 || n < 1 || m < 1 || d < 1 || d > 32 ||
      (n + kRowWarps - 1) / kRowWarps > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Args a{U, V, R, mask, di, dj, dv, sig, gu, gv, row_sq, sqerr,
         (int64_t)n, (int64_t)m, d,
         Strides{u_lane, u_row, u_k}, Strides{v_lane, v_row, v_k}};
  cudaStream_t s = (cudaStream_t)stream;
  if (!in_bf16 && !out_bf16 && !round_resid)
    return (int)by_width<float, float, false>(a, (int64_t)L, s);
  if (in_bf16 && !out_bf16 && !round_resid)
    return (int)by_width<__nv_bfloat16, float, false>(a, (int64_t)L, s);
  if (in_bf16 && out_bf16 && round_resid)
    return (int)by_width<__nv_bfloat16, __nv_bfloat16, true>(a, (int64_t)L, s);
  return (int)cudaErrorInvalidValue;
}
