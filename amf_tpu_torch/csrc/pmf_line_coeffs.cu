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
// What bounds it on this card: all four sums are sums over the rated cells
// and the lane's own cell (E, mask P1 and mask P2 are 0 elsewhere): ~8 d
// multiply-adds a cell, ~0.4 MFLOP a lane at the MovieLens-100k shape
// (943 x 1682, d = 10, ~5,000 rated cells), against 2 (943 + 1682) d factor
// and direction values in. Bytes bound it, and below them the latency of one
// lane's staging and walk.
// What the design does about it:
//   * it walks the caller's index of the rated cells (built once a refit, the
//     one the value+gradient kernel walks), never the dense mask or R;
//   * the four sums are sums over cells, so one pass over one side is
//     enough. The kernel is written for a "walked" side, a thread a row of
//     it with that row's factor and direction in registers (read coalesced
//     from the (L, d, rows) layout), and a "gathered" side, whose factor and
//     direction the block first copies into shared memory as float, rows at
//     an odd stride, so that the walk's gathers at random rows meet no bank
//     conflicts and never leave the SM. P1's two terms swap under an
//     exchange of the sides and the sums do not change, so the caller picks
//     the sides: it gathers the shorter one (the rows, by CSC, at 943 x 1682:
//     83 KB of shared memory at d = 10 against 148 KB for the columns);
//   * one launch, one block a lane, no scratch: each thread's four partial
//     sums are added through warp shuffles and then over the warps in a
//     fixed order. No atomics: the sums are the same bit for bit from run to
//     run, so the line search's accept test on the quartic cannot change
//     between runs;
//   * the lane's own cell is one more iteration of the walk's loop body: it
//     replaces the rated value when the cell is rated, and is one more cell
//     after its row's rated cells when not; a cell outside the problem is
//     ignored;
//   * d (<= 32) is bucketed to 8, 16 or 32 at compile time.
// A thread a walked row suits sparse data like the refit tiles measured so
// far (~3 rated cells a column, ~5 a row); at the density of the full
// MovieLens-100k ratings (~60 a column, up to several hundred) the rows are
// unbalanced and a warp a row would serve better. A row's cells are summed
// in index order by one thread whichever it is, so that order would not
// change. Where the gathered side does not fit the 227 KB a block may have
// (943 rows at d = 32), the caller picks the variant that runs the same walk
// on the factors in global memory (they sit in L2).
//
// C interface (loaded with ctypes): amf_pmf_line_coeffs(...),
// amf_pmf_line_coeffs_smem_bytes(...) and amf_pmf_line_coeffs_smem_limit(),
// at the bottom of this file.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may take
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Args {
  const void* X;           // (L, d, rows_w) factor of the walked side
  const void* GX;          // (L, d, rows_w) its direction
  const void* Y;           // (L, d, rows_g) factor of the gathered side
  const void* GY;          // (L, d, rows_g) its direction
  const int32_t* ptr;      // (rows_w + 1,) the walked side's cell pointers
  const int32_t* idx;      // (nnz,) gathered-side row of each cell
  const void* r;           // (nnz,) R of each cell, type T
  const int64_t* cell_w;   // (L,) the lane's cell: its walked-side row
  const int64_t* cell_g;   // (L,) and its gathered-side row
  const float* dv;         // (L,)
  float* acc;              // (L, 4): a2, a11, a12, a22
  int64_t rows_w, rows_g;
  int d;
};

// floats of shared memory: the warps' partial sums and, with the gathered
// side in shared memory, its factor and direction
inline int64_t smem_floats(int64_t rows_g, int d, bool shared) {
  return 4 * kWarps + (shared ? 2 * rows_g * (d | 1) : 0);
}

template <typename T, int DMAX, bool kShared>
__global__ void __launch_bounds__(kThreads) line_coeffs(Args a) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int d = a.d, ds = a.d | 1;
  const int64_t l = blockIdx.x;
  const int64_t nw = a.rows_w, ng = a.rows_g;
  float* red = smem;               // (4, kWarps)
  float* s_y = smem + 4 * kWarps;  // (ng, ds)
  float* s_gy = s_y + ng * ds;     // (ng, ds)

  const T* X = (const T*)a.X + l * nw * d;
  const T* GX = (const T*)a.GX + l * nw * d;
  const T* Y = (const T*)a.Y + l * ng * d;
  const T* GY = (const T*)a.GY + l * ng * d;
  if (kShared) {
    // neighbouring threads, neighbouring addresses; the odd row stride
    // spreads a warp's 32 rows over the 32 banks
    for (int k = 0; k < d; ++k) {
      for (int64_t i = tid; i < ng; i += kThreads) {
        s_y[i * ds + k] = to_f(Y[k * ng + i]);
        s_gy[i * ds + k] = to_f(GY[k * ng + i]);
      }
    }
    __syncthreads();
  }
  const T* r = (const T*)a.r;
  const int64_t cw = a.cell_w[l], cg = a.cell_g[l];
  const float dv = a.dv[l];
  const bool cell_ok = cw >= 0 && cw < nw && cg >= 0 && cg < ng;

  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // a2, a11, a12, a22
  for (int64_t w = tid; w < nw; w += kThreads) {
    float x[DMAX], gx[DMAX];
#pragma unroll
    for (int k = 0; k < DMAX; ++k) {
      x[k] = k < d ? to_f(X[k * nw + w]) : 0.0f;
      gx[k] = k < d ? to_f(GX[k * nw + w]) : 0.0f;
    }
    const bool mine = cell_ok && w == cw;
    bool found = false;
    const int end = a.ptr[w + 1];
    for (int e = a.ptr[w]; e <= end; ++e) {
      int64_t g;
      float rv;
      if (e < end) {
        g = a.idx[e];
        const bool hit = mine && g == cg;
        found |= hit;
        rv = hit ? dv : to_f(r[e]);
      } else {  // after the rated cells: the lane's cell, not rated
        if (!mine || found) break;
        g = cg;
        rv = dv;
      }
      float pred = 0.0f, p1a = 0.0f, p1b = 0.0f, p2 = 0.0f;
#pragma unroll
      for (int k = 0; k < DMAX; ++k) {
        if (k < d) {
          const float y = kShared ? s_y[g * ds + k] : to_f(Y[k * ng + g]);
          const float gy = kShared ? s_gy[g * ds + k] : to_f(GY[k * ng + g]);
          pred = fmaf(x[k], y, pred);
          p1a = fmaf(gx[k], y, p1a);
          p1b = fmaf(x[k], gy, p1b);
          p2 = fmaf(gx[k], gy, p2);
        }
      }
      const float err = rv - pred;
      const float p1 = p1a + p1b;
      s[0] = fmaf(err, p2, s[0]);
      s[1] = fmaf(p1, p1, s[1]);
      s[2] = fmaf(p1, p2, s[2]);
      s[3] = fmaf(p2, p2, s[3]);
    }
  }
  // butterfly: a + b == b + a, so every thread of a warp ends with the same
  // totals; then the warps' totals in order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int q = 0; q < 4; ++q) s[q] += __shfl_xor_sync(0xffffffffu, s[q], off);
  }
  if ((tid & 31) == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) red[q * kWarps + (tid >> 5)] = s[q];
  }
  __syncthreads();
  if (tid < 4) {
    float t = 0.0f;
    for (int w = 0; w < kWarps; ++w) t += red[tid * kWarps + w];
    a.acc[l * 4 + tid] = t;
  }
}

template <typename T, int DMAX, bool kShared>
cudaError_t launch(const Args& a, int64_t L, cudaStream_t stream) {
  const int64_t bytes = 4 * smem_floats(a.rows_g, a.d, kShared);
  if (bytes > kSmemLimit) return cudaErrorInvalidValue;
  auto kernel = line_coeffs<T, DMAX, kShared>;
  static bool configured = false;  // once per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  kernel<<<(unsigned)L, kThreads, (size_t)bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_width(const Args& a, int64_t L, bool shared, cudaStream_t s) {
#define AMF_WIDTH(DMAX)                                    \
  return shared ? launch<T, DMAX, true>(a, L, s)           \
                : launch<T, DMAX, false>(a, L, s)
  if (a.d <= 8) AMF_WIDTH(8);
  if (a.d <= 16) AMF_WIDTH(16);
  AMF_WIDTH(32);
#undef AMF_WIDTH
}

}  // namespace

// Bytes of shared memory a block of the shared-memory variant needs; the
// caller takes that variant when they are at most
// amf_pmf_line_coeffs_smem_limit().
extern "C" long long amf_pmf_line_coeffs_smem_bytes(long long rows_g, int d) {
  return 4 * smem_floats(rows_g, d, true);
}

extern "C" long long amf_pmf_line_coeffs_smem_limit() { return kSmemLimit; }

// in_bf16: 0 when the factors, directions and r are float, 1 when bf16.
// shared: 1 keeps the gathered side in shared memory (it must fit), 0 leaves
// it in global memory. (X, GX) are the walked side's factor and direction,
// (Y, GY) the gathered side's; ptr, idx and r are the index's cells by the
// walked side (CSR to walk the rows, CSC to walk the columns).
extern "C" int amf_pmf_line_coeffs(
    int in_bf16, int shared, const void* X, const void* GX, const void* Y,
    const void* GY, const int32_t* ptr, const int32_t* idx, const void* r,
    const int64_t* cell_w, const int64_t* cell_g, const float* dv, float* acc,
    long long L, long long rows_w, long long rows_g, int d, void* stream) {
  if (L < 1 || L > 0x7fffffffLL || rows_w < 1 || rows_g < 1 ||
      rows_w > 0x7fffffffLL / 33 || rows_g > 0x7fffffffLL / 33 || d < 1 ||
      d > 32)
    return (int)cudaErrorInvalidValue;
  Args a{X, GX, Y, GY, ptr, idx, r, cell_w, cell_g, dv, acc,
         (int64_t)rows_w, (int64_t)rows_g, d};
  cudaStream_t s = (cudaStream_t)stream;
  if (in_bf16) return (int)by_width<__nv_bfloat16>(a, (int64_t)L, shared != 0, s);
  return (int)by_width<float>(a, (int64_t)L, shared != 0, s);
}
