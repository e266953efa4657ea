// Masked reductions of the poly line search's improvement quartic, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel pmf_line_coeffs_t of
// amf_tpu/ops/pallas_kernels.py (body `_kernel_coeffs`). Along the ray
// (U + a Gu, V + a Gv) the masked squared error of lane l is an exact quartic
// in a, built from the shared base ratings R and mask, with the lane's own
// cell (di, dj) set to rated with value dv:
//
//     E  = mask * (R - U V^T),  P1 = Gu V^T + U Gv^T,  P2 = Gu Gv^T
//     a2 = <E, P2>,  a11 = <mask P1, P1>,  a12 = <mask P1, P2>,
//     a22 = <mask P2, P2>
//
// Factors and directions come as (L, d, rows), contiguous, in float or bf16
// (`T`); every product and sum is float. The caller assembles the quartic's
// coefficients c1..c4 from these four sums and the directions' norms.
//
// What bounds it on this card: all four sums involve only the rated cells
// and the lane's own cell (E, mask P1 and mask P2 are 0 elsewhere), so the
// kernel does the products only there: ~8 d multiply-adds a cell, ~0.4 MFLOP
// a lane at the MovieLens-100k shape (943 x 1682, d = 10, ~5,000 rated
// cells). It is bound by the bytes it streams: the mask (1 byte a cell)
// once, R where rated, and the factors and directions once. R and the mask
// are shared by all lanes and stay in the 50 MB L2.
// What the design does about it:
//   * one pass over the rows: one warp per (lane, row); its 32 threads walk
//     the row's columns side by side, so the mask, R, V and Gv reads are
//     coalesced. The row's U and Gu columns sit in registers. Each thread
//     keeps four partial sums, and a butterfly of warp shuffles adds them
//     in a fixed order; the row's four totals go to a (L, n, 4) scratch;
//   * no column pass: the kernel returns scalars only;
//   * a second, small launch sums the rows of each lane in a fixed order.
//     No atomics: the sums are the same bit for bit from run to run, so the
//     line search's accept test on the quartic cannot change between runs;
//   * d (<= 32) is bucketed to 8, 16 or 32 at compile time.
//
// C interface (loaded with ctypes): amf_pmf_line_coeffs(...), at the bottom
// of this file. Returns the cudaError_t of the launches (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowWarps = 8;      // rows of one lane per block
constexpr int kSumThreads = 256;  // threads of the final sum, one block a lane

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Args {
  const void* Ut;        // (L, d, n)
  const void* Vt;        // (L, d, m)
  const void* Gut;       // (L, d, n)
  const void* Gvt;       // (L, d, m)
  const void* R;         // (n, m) row-major
  const uint8_t* mask;   // (n, m) row-major, 0 or 1
  const int32_t* di;     // (L,)
  const int32_t* dj;     // (L,)
  const float* dv;       // (L,)
  float* row_part;       // (L, n, 4) scratch
  float* acc;            // (L, 4): a2, a11, a12, a22
  int64_t n, m;
  int d;
};

template <typename T, int DMAX>
__global__ void __launch_bounds__(kRowWarps * 32) coeff_rows(Args a) {
  const int warp = threadIdx.x >> 5;
  const int tid = threadIdx.x & 31;
  const int64_t i = (int64_t)blockIdx.x * kRowWarps + warp;
  const int64_t l = blockIdx.y;
  if (i >= a.n) return;  // the whole warp leaves together

  const int64_t nd = a.n * a.d, md = a.m * a.d;
  const T* U = (const T*)a.Ut + l * nd + i;
  const T* GU = (const T*)a.Gut + l * nd + i;
  const T* V = (const T*)a.Vt + l * md;
  const T* GV = (const T*)a.Gvt + l * md;
  const T* R = (const T*)a.R + i * a.m;
  const uint8_t* M = a.mask + i * a.m;
  const int64_t hit_j = a.di[l] == i ? (int64_t)a.dj[l] : -1;
  const float hit_v = a.dv[l];

  float u[DMAX], gu[DMAX];
#pragma unroll
  for (int k = 0; k < DMAX; ++k) {
    u[k] = k < a.d ? to_f(U[k * a.n]) : 0.0f;
    gu[k] = k < a.d ? to_f(GU[k * a.n]) : 0.0f;
  }
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // a2, a11, a12, a22
  for (int64_t j = tid; j < a.m; j += 32) {
    const bool hit = j == hit_j;
    if (!(M[j] || hit)) continue;  // every term is 0 off the rated cells
    const float r = hit ? hit_v : to_f(R[j]);
    float pred = 0.0f, p1a = 0.0f, p1b = 0.0f, p2 = 0.0f;
#pragma unroll
    for (int k = 0; k < DMAX; ++k) {
      if (k < a.d) {
        const float v = to_f(V[k * a.m + j]);
        const float gv = to_f(GV[k * a.m + j]);
        pred = fmaf(u[k], v, pred);
        p1a = fmaf(gu[k], v, p1a);
        p1b = fmaf(u[k], gv, p1b);
        p2 = fmaf(gu[k], gv, p2);
      }
    }
    const float e = r - pred;
    const float p1 = p1a + p1b;
    s[0] = fmaf(e, p2, s[0]);
    s[1] = fmaf(p1, p1, s[1]);
    s[2] = fmaf(p1, p2, s[2]);
    s[3] = fmaf(p2, p2, s[3]);
  }
  // butterfly: a + b == b + a, so every thread ends with the same totals
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int q = 0; q < 4; ++q) s[q] += __shfl_xor_sync(0xffffffffu, s[q], off);
  }
  if (tid == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) a.row_part[(l * a.n + i) * 4 + q] = s[q];
  }
}

// acc[l, q] = sum over rows of row_part[l, :, q], in a fixed order.
__global__ void __launch_bounds__(kSumThreads) sum_rows(Args a) {
  __shared__ float part[4][kSumThreads];
  const int64_t l = blockIdx.x;
  const float* rp = a.row_part + l * a.n * 4;
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int64_t i = threadIdx.x; i < a.n; i += kSumThreads)
#pragma unroll
    for (int q = 0; q < 4; ++q) s[q] += rp[i * 4 + q];
#pragma unroll
  for (int q = 0; q < 4; ++q) part[q][threadIdx.x] = s[q];
  __syncthreads();
  for (int w = kSumThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w)
#pragma unroll
      for (int q = 0; q < 4; ++q) part[q][threadIdx.x] += part[q][threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x < 4) a.acc[l * 4 + threadIdx.x] = part[threadIdx.x][0];
}

template <typename T, int DMAX>
cudaError_t launch(const Args& a, int64_t L, cudaStream_t stream) {
  const dim3 grid((unsigned)((a.n + kRowWarps - 1) / kRowWarps), (unsigned)L);
  coeff_rows<T, DMAX><<<grid, kRowWarps * 32, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_rows<<<(unsigned)L, kSumThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_width(const Args& a, int64_t L, cudaStream_t stream) {
  if (a.d <= 8) return launch<T, 8>(a, L, stream);
  if (a.d <= 16) return launch<T, 16>(a, L, stream);
  return launch<T, 32>(a, L, stream);
}

}  // namespace

// in_bf16: 0 when Ut, Vt, Gut, Gvt and R are float, 1 when bf16.
extern "C" int amf_pmf_line_coeffs(
    int in_bf16, const void* Ut, const void* Vt, const void* Gut,
    const void* Gvt, const void* R, const uint8_t* mask, const int32_t* di,
    const int32_t* dj, const float* dv, float* row_part, float* acc,
    long long L, long long n, long long m, int d, void* stream) {
  if (L < 1 || L > 65535 || n < 1 || m < 1 || d < 1 || d > 32 ||
      (n + kRowWarps - 1) / kRowWarps > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Args a{Ut, Vt, Gut, Gvt, R, mask, di, dj, dv, row_part, acc,
         (int64_t)n, (int64_t)m, d};
  cudaStream_t s = (cudaStream_t)stream;
  if (in_bf16) return (int)by_width<__nv_bfloat16>(a, (int64_t)L, s);
  return (int)by_width<float>(a, (int64_t)L, s);
}
