// The Gibbs row draws' masked Gram, summed over the rated cells, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves this product to XLA, as a
// dense matrix product of the shared 0/1 mask (amf_tpu/models/bpmf_gibbs.py).
// The port did the same with cuBLAS (ops/gram_kernel.dense_gram, still
// its path on the CPU and for dense masks). At the MovieLens-100k
// configuration (943 x 1682, 5,000 rated cells: 0.315 %) that product spends
// 99.7 % of its operations on zeros; summed over the rated cells the same
// products are ~300x fewer. For lane l and row i of the factor being drawn,
// with o_j = other[l, j] (D values), P = D (D + 1) / 2 and the rated cells j
// of row i with ratings r_ij, it writes
//
//     Gt[l, a (a + 1) / 2 + b, i] = sum_j o_ja o_jb     (a >= b, q < P)
//     Gt[l, P + k, i]             = sum_j o_jk
//     mrt[l, k, i]                = sum_j r_ij o_jk
//
// in exactly the layout the dense path leaves for the Cholesky kernel
// (csrc/chol_solve_sample.cu, chol_gram_kernel), which reads them unchanged.
// A row with no rated cell gets zeros.
//
// The index is the one the PMF kernels walk (ops/pmf_kernels.rated_index):
// for the U side its CSR (row pointers, column indices, ratings in CSR
// order), for the V side its CSC (column pointers, row indices, ratings in
// CSC order); the kernel does not know which.
//
// What bounds it on this card: writing Gt and mrt, (P + 2 D) r values a lane.
// At D = 20, 160 lanes, f32 that is 151 MB (r = 943) and 269 MB (r = 1682) a
// round of one sweep, 25 GB over a 30-round, 2-sweep lookahead tile: 7.5 ms
// at 3.35 TB/s. The operations (2 (P + 2 D) a rated cell and lane, 2.3e6 a
// lane and half sweep) and the reads of other (L2-resident: 21.5 MB at 160
// lanes x 1682 x 20 f32) are far below that.
// What the design does about it:
//   * a warp takes 32 consecutive rows of one lane, a thread a row, so every
//     one of the P + 2 D values is written by a warp as 32 neighbouring
//     addresses (128 B in f32): the writes are coalesced and written once;
//   * the P + 2 D sums of a row are split into chunks of kChunk, one chunk a
//     warp, so a thread keeps kChunk sums and the row's D values of o_j in
//     registers and nothing spills, at any D up to 32 and in f64. The chunk
//     is a template argument and every index into the sums and into o_j is a
//     compile-time constant (static_for), so the arrays stay in registers.
//     A block holds up to kWarps chunks of the same 32 rows, so those warps
//     read the same index entries and the same rows of other through one L1;
//   * each thread walks its row's rated cells in index order, however many
//     there are: no stage is sized by a row's length. A warp's time is its
//     longest row;
//   * plain fused multiply-adds in the caller's type (f32 or f64), no tensor
//     cores, no TF32.
//
// C interface (loaded with ctypes): see the bottom of this file. Every
// function returns the cudaError_t of its launch.
//
// Widths: the package builds one library a width, with AMF_ONLY_D=D
// (ops/cuda_build.width_defines): every D unrolls its P + 2 D sums at compile
// time, and all 32 widths in one library took 103.9 s of nvcc against 5.6 s
// for one. Built without AMF_ONLY_D the library takes every D from 1 to 32.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kChunk = 32;  // sums a thread keeps (16, 64: no faster at D = 20)
constexpr int kWarps = 8;   // chunks (warps) a block at most
constexpr int kRows = 32;   // rows a warp

template <int I, int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I < N) {
    f(std::integral_constant<int, I>{});
    static_for<I + 1, N>(f);
  }
}

// row a of the packed lower triangle's entry q (entry a (a + 1) / 2 + b)
__host__ __device__ constexpr int tri_row(int q) {
  int a = 0;
  while ((a + 1) * (a + 2) / 2 <= q) ++a;
  return a;
}

template <int D>
struct Shape {
  static constexpr int P = D * (D + 1) / 2;
  static constexpr int NQ = P + 2 * D;  // sums a row
  static constexpr int chunks = (NQ + kChunk - 1) / kChunk;
  static constexpr int warps = chunks < kWarps ? chunks : kWarps;
};

template <typename T>
struct Args {
  const int32_t* ptr;  // (r + 1,) each row's first cell
  const int32_t* idx;  // (nnz,) each cell's column of other
  const T* vals;       // (nnz,) each cell's rating
  const T* other;      // (L, c, D), lanes other_lane values apart
  T* Gt;               // (L, P + D, r)
  T* mrt;              // (L, D, r)
  int64_t r, other_lane;
  int row_blocks;      // blocks a lane: ceil(r / kRows)
};

// Sums Q0 .. Q0 + kChunk - 1 (those below NQ) of row i of lane l.
template <typename T, int D, int C>
__device__ __forceinline__ void chunk_sums(const Args<T>& a, int64_t l,
                                           int64_t i) {
  constexpr int P = Shape<D>::P, NQ = Shape<D>::NQ;
  constexpr int Q0 = C * kChunk;
  constexpr int N = (NQ - Q0 < kChunk) ? NQ - Q0 : kChunk;
  T acc[N];
  static_for<0, N>([&](auto t) { acc[decltype(t)::value] = T(0); });

  const T* ol = a.other + l * a.other_lane;
  const int e1 = a.ptr[i + 1];
  for (int e = a.ptr[i]; e < e1; ++e) {
    const T* o = ol + (int64_t)a.idx[e] * D;
    T v[D];  // loads this chunk does not use are dropped by the compiler
#pragma unroll
    for (int k = 0; k < D; ++k) v[k] = o[k];
    const T rv = a.vals[e];
    static_for<0, N>([&](auto t) {
      constexpr int n = decltype(t)::value, q = Q0 + n;
      if constexpr (q < P) {
        constexpr int ra = tri_row(q), cb = q - ra * (ra + 1) / 2;
        acc[n] = fma(v[ra], v[cb], acc[n]);
      } else if constexpr (q < P + D) {
        acc[n] += v[q - P];
      } else {
        acc[n] = fma(rv, v[q - P - D], acc[n]);
      }
    });
  }

  static_for<0, N>([&](auto t) {
    constexpr int n = decltype(t)::value, q = Q0 + n;
    if constexpr (q < P + D)
      a.Gt[(l * (P + D) + q) * a.r + i] = acc[n];
    else
      a.mrt[(l * D + (q - P - D)) * a.r + i] = acc[n];
  });
}

// chunk c, a runtime value uniform over the warp, to its template
template <typename T, int D, int C = 0>
__device__ __forceinline__ void run_chunk(int c, const Args<T>& a, int64_t l,
                                          int64_t i) {
  if constexpr (C < Shape<D>::chunks) {
    if (c == C)
      chunk_sums<T, D, C>(a, l, i);
    else
      run_chunk<T, D, C + 1>(c, a, l, i);
  }
}

// grid (L * row_blocks, ceil(chunks / warps)); block (32, warps)
template <typename T, int D>
__global__ void __launch_bounds__(kRows * kWarps)
masked_gram_rows_kernel(Args<T> a) {
  const int64_t l = blockIdx.x / a.row_blocks;
  const int64_t i = (int64_t)(blockIdx.x % a.row_blocks) * kRows + threadIdx.x;
  const int c = blockIdx.y * Shape<D>::warps + threadIdx.y;
  if (i >= a.r || c >= Shape<D>::chunks) return;
  run_chunk<T, D>(c, a, l, i);
}

template <typename T, int D>
cudaError_t launch(const Args<T>& a, int64_t L, cudaStream_t stream) {
  using S = Shape<D>;
  const dim3 grid((unsigned)(L * a.row_blocks),
                  (unsigned)((S::chunks + S::warps - 1) / S::warps));
  masked_gram_rows_kernel<T, D><<<grid, dim3(kRows, S::warps), 0, stream>>>(a);
  return cudaGetLastError();
}

#ifdef AMF_ONLY_D
static_assert(AMF_ONLY_D >= 1, "AMF_ONLY_D is a factor width");
#define AMF_CASES(CALL) \
  case AMF_ONLY_D: \
    return CALL(AMF_ONLY_D);
#else
#define AMF_CASES(C)                                                        \
  case 1: return C(1); case 2: return C(2); case 3: return C(3);            \
  case 4: return C(4); case 5: return C(5); case 6: return C(6);            \
  case 7: return C(7); case 8: return C(8); case 9: return C(9);            \
  case 10: return C(10); case 11: return C(11); case 12: return C(12);      \
  case 13: return C(13); case 14: return C(14); case 15: return C(15);      \
  case 16: return C(16); case 17: return C(17); case 18: return C(18);      \
  case 19: return C(19); case 20: return C(20); case 21: return C(21);      \
  case 22: return C(22); case 23: return C(23); case 24: return C(24);      \
  case 25: return C(25); case 26: return C(26); case 27: return C(27);      \
  case 28: return C(28); case 29: return C(29); case 30: return C(30);      \
  case 31: return C(31); case 32: return C(32);
#endif

template <typename T>
cudaError_t dispatch(Args<T> a, int64_t L, int d, cudaStream_t stream) {
  if (L <= 0 || a.r <= 0) return cudaErrorInvalidValue;
  const int64_t row_blocks = (a.r + kRows - 1) / kRows;
  if (row_blocks * L > 0x7fffffffLL) return cudaErrorInvalidValue;
  a.row_blocks = (int)row_blocks;
  switch (d) {
#define AMF_CALL(N) (launch<T, N>(a, L, stream))
    AMF_CASES(AMF_CALL)
#undef AMF_CALL
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// ptr (r + 1,), idx and vals (nnz,), other (L, c, d) with lanes other_lane
// values apart and contiguous (c, d) slabs; Gt (L, P + d, r) and mrt
// (L, d, r) contiguous, written whole.
#define AMF_MASKED_GRAM_ENTRY(NAME, T)                                       \
  extern "C" int NAME(const int32_t* ptr, const int32_t* idx, const T* vals, \
                      const T* other, T* Gt, T* mrt, long long L,            \
                      long long r, long long other_lane, int d,              \
                      void* stream) {                                        \
    Args<T> a{ptr, idx, vals, other, Gt, mrt, (int64_t)r,                    \
              (int64_t)other_lane, 0};                                       \
    return (int)dispatch<T>(a, (int64_t)L, d, (cudaStream_t)stream);         \
  }
AMF_MASKED_GRAM_ENTRY(amf_masked_gram_f32, float)
AMF_MASKED_GRAM_ENTRY(amf_masked_gram_f64, double)
