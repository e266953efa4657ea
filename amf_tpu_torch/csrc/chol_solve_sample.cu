// Batched small-matrix Cholesky factor-solve-sample for Hopper (sm_90a).
//
// Replaces amf_tpu/ops/chol_kernel.py::chol_solve_sample_tpu (Pallas body
// `_kernel`). For each of B symmetric positive-definite D x D matrices S with
// right-hand side b and standard normals z it computes
//
//     S = L L^T,   L y = b,   L^T x = y + z,
//
// so x = S^{-1} b + L^{-T} z ~ N(S^{-1} b, S^{-1}) when z ~ N(0, I). The Gibbs
// sampler calls it for every row of a factor in every sweep of every chain.
//
// Two entry points share one device body (`factor_solve_sample`):
//
//   * amf_chol_solve_sample_{f32,f64}: S, b and z given, on batch-minor
//     buffers (value k of matrix b at [k * B + b]). The counterpart of the TPU
//     kernel's signature;
//   * amf_chol_gram_solve_sample_{f32,f64}: what the Gibbs row draw calls. It
//     is fed straight from the masked Gram product and assembles S and b
//     itself. For lane l and row i, with P = D (D + 1) / 2,
//
//         S(a, b) = alpha_l(a, b) + beta * Gt[l, a (a + 1) / 2 + b, i]   (a >= b)
//         b(k)    = beta * (mrt[l, k, i] - center_l * Gt[l, P + k, i])
//                   + (alpha_l mu_l)(k)
//
//     and on the row of the lane's own cell (cell_row[l]), with o the factor
//     row other[l, cell_col[l]]:  S += beta dm_l o o^T,
//     b += beta (dr_l - dm_l center_l) o.  Gt (L, P + D, r) holds the packed
//     lower triangle of every row's Gram followed by mask @ other; mrt
//     (L, D, r) is (mask * ratings) @ other; both row-minor, as the matrix
//     products leave them. z and x keep the package's (L, r, D) layout.
//
// What bounds it on this card: at D = 10 one matrix moves 95 values through
// device memory (55 of the Gram's triangle, 10 of mask @ other, 10 of mrt, z
// and x) for ~D^3/3 + 2 D^2 ~ 530 flops, about 1.4 flop per byte in f32: far
// below the H100's balance point, so bytes and latency bound it.
// What the design does about it:
//   * one thread per matrix; the factor is a packed lower triangle in a
//     per-thread array. For D <= 16 every loop is unrolled at compile time
//     and the array lives in registers; above that the loops stay rolled and
//     the array lives in local memory (L1-cached). Fully unrolled large D
//     spilled tens of KB a thread anyway and made the build take minutes;
//   * a block takes kThreads consecutive rows of one lane, so for each of the
//     P + 2 D values the threads of a warp read neighbouring addresses, and
//     the streams of one block lie within (P + 2 D) r values of each other;
//     every load is started before the arithmetic;
//   * alpha's triangle, alpha mu and the lane's cell go to shared memory once
//     a block;
//   * z and x keep their (rows, D) layout and each thread reads and writes
//     its own D contiguous values: a warp covers one contiguous run, every
//     sector of it is used, and L1 serves the sectors that the D accesses
//     share. Copying the block's slab through shared memory with coalesced
//     accesses (AMF_CHOL_STAGED_ZX) measured 9 % slower at D = 10 (its two
//     barriers cost more than the repeated sectors);
//   * the ragged last block of a lane is masked, so nothing is padded, and no
//     transposed or assembled copy of anything exists outside the kernel.
//
// C interface (loaded with ctypes): see the bottom of this file. Every
// function returns the cudaError_t of its launch.
//
// Build-time knobs, for the probe (python -m amf_tpu_torch.ops.probe_kernels):
// AMF_CHOL_THREADS (threads a block), AMF_CHOL_MIN_BLOCKS (the second
// argument of __launch_bounds__), AMF_CHOL_ONLY_D (instantiate one D only),
// AMF_CHOL_PROBE (adds copy-only kernels with the same loads and stores),
// AMF_CHOL_STAGED_ZX (z and x go through a shared-memory slab).

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef AMF_CHOL_THREADS
#define AMF_CHOL_THREADS 128
#endif
#ifndef AMF_CHOL_MIN_BLOCKS
#define AMF_CHOL_MIN_BLOCKS 1
#endif

namespace {

constexpr int kThreads = AMF_CHOL_THREADS;
constexpr int kMinBlocks = AMF_CHOL_MIN_BLOCKS;
constexpr int kMaxUnrolledD = 16;

// Unroll factor of every loop: all of it up to kMaxUnrolledD, none above.
template <int D>
struct Unroll {
  static const int value = D <= kMaxUnrolledD ? D : 1;
};

__host__ __device__ constexpr int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// z of one matrix on batch-minor buffers
template <typename T>
struct BatchMinorZ {
  const T* z;
  int64_t B;
  __device__ __forceinline__ T operator()(int j) const { return z[(int64_t)j * B]; }
};

// z of one matrix as a row of the block's shared-memory slab
template <typename T>
struct RowZ {
  const T* row;
  __device__ __forceinline__ T operator()(int j) const { return row[j]; }
};

// The shared body. L holds S's lower triangle and is overwritten by the
// factor; w holds b and is overwritten by x. With kCopyOnly (the probe) the
// arithmetic is replaced by sums that keep every load alive.
template <typename T, int D, bool kCopyOnly, typename Z>
__device__ __forceinline__ void factor_solve_sample(T (&L)[D * (D + 1) / 2],
                                                    T (&w)[D], const Z& z) {
  if (kCopyOnly) {
    T s = T(0);
#pragma unroll (Unroll<D>::value)
    for (int q = 0; q < D * (D + 1) / 2; ++q) s += L[q];
#pragma unroll (Unroll<D>::value)
    for (int j = 0; j < D; ++j) w[j] += z(j) + s;
    return;
  }
  // Cholesky-Crout, column by column: L(j,j) = sqrt(S(j,j) - sum_k L(j,k)^2),
  // L(i,j) = (S(i,j) - sum_k L(i,k) L(j,k)) / L(j,j). inv[j] = 1 / L(j,j).
  T inv[D];
#pragma unroll (Unroll<D>::value)
  for (int j = 0; j < D; ++j) {
    T s = L[tri(j, j)];
#pragma unroll (Unroll<D>::value)
    for (int k = 0; k < j; ++k) s -= L[tri(j, k)] * L[tri(j, k)];
    const T r = T(1) / sqrt(s);
    inv[j] = r;
#pragma unroll (Unroll<D>::value)
    for (int i = j + 1; i < D; ++i) {
      T t = L[tri(i, j)];
#pragma unroll (Unroll<D>::value)
      for (int k = 0; k < j; ++k) t -= L[tri(i, k)] * L[tri(j, k)];
      L[tri(i, j)] = t * r;
    }
  }

  // forward substitution L y = b, then w = y + z
#pragma unroll (Unroll<D>::value)
  for (int j = 0; j < D; ++j) {
    T t = w[j];
#pragma unroll (Unroll<D>::value)
    for (int k = 0; k < j; ++k) t -= L[tri(j, k)] * w[k];
    w[j] = t * inv[j];
  }
#pragma unroll (Unroll<D>::value)
  for (int j = 0; j < D; ++j) w[j] += z(j);
  // back substitution L^T x = w
#pragma unroll (Unroll<D>::value)
  for (int j = D - 1; j >= 0; --j) {
    T t = w[j];
#pragma unroll (Unroll<D>::value)
    for (int k = j + 1; k < D; ++k) t -= L[tri(k, j)] * w[k];
    w[j] = t * inv[j];
  }
}

// ---------------------------------------------------------------------------
// S, b, z given, batch-minor

template <typename T, int D, bool kCopyOnly>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
chol_solve_sample_kernel(const T* __restrict__ S, const T* __restrict__ rhs,
                         const T* __restrict__ z, T* __restrict__ out,
                         int64_t B) {
  const int64_t b = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;

  T L[D * (D + 1) / 2];  // S's lower triangle, overwritten by the factor
  T w[D];                // b, then y + z, then x
#pragma unroll (Unroll<D>::value)
  for (int i = 0; i < D; ++i) {
#pragma unroll (Unroll<D>::value)
    for (int j = 0; j <= i; ++j) L[tri(i, j)] = S[(int64_t)(i * D + j) * B + b];
  }
#pragma unroll (Unroll<D>::value)
  for (int j = 0; j < D; ++j) w[j] = rhs[(int64_t)j * B + b];
  factor_solve_sample<T, D, kCopyOnly>(L, w, BatchMinorZ<T>{z + b, B});
#pragma unroll (Unroll<D>::value)
  for (int j = 0; j < D; ++j) out[(int64_t)j * B + b] = w[j];
}

// ---------------------------------------------------------------------------
// fed from the Gram

template <typename T>
struct GramArgs {
  const T* Gt;              // (L, P + D, r)
  const T* mrt;             // (L, D, r)
  const T* z;               // (L, r, D), lanes z_lane values apart
  const T* alpha;           // (L, D, D)
  const T* mu;              // (L, D)
  const T* center;          // (L,) or null: nothing is subtracted
  const T* other;           // (L, c, D), lanes other_lane values apart;
                            // read only with cells
  const int64_t* cell_row;  // (L,) or null: no lane has a cell
  const int64_t* cell_col;  // (L,)
  const T* dm;              // (L,)
  const T* dr;              // (L,)
  T* out;                   // (L, r, D)
  T beta;
  int64_t r, c, z_lane, other_lane;
  int chunks;               // blocks a lane: ceil(r / kThreads)
};

template <typename T, int D, bool kCopyOnly>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
chol_gram_kernel(GramArgs<T> a) {
  constexpr int P = D * (D + 1) / 2;
  __shared__ T s_alpha[P];   // alpha_l's lower triangle
  __shared__ T s_amu[D];     // alpha_l mu_l
  __shared__ T s_o[D];       // the lane cell's factor row
#ifdef AMF_CHOL_STAGED_ZX
  constexpr int ZS = D | 1;  // odd row stride of the z / x slab
  __shared__ T s_zx[kThreads * ZS];
#endif

  const int tid = threadIdx.x;
  const int64_t l = blockIdx.x / a.chunks;
  const int64_t i0 = (int64_t)(blockIdx.x % a.chunks) * kThreads;
  const int rows = (int)(a.r - i0 < kThreads ? a.r - i0 : kThreads);
  const int64_t cell_row = a.cell_row ? a.cell_row[l] : -1;
  const T center = a.center ? a.center[l] : T(0);

  // this thread's row; the ragged tail's threads reread the block's first.
  // Every load is started before the lane's constants are staged, so all are
  // in flight together.
  const bool active = tid < rows;
  const int64_t i = i0 + (active ? tid : 0);
  const T* g = a.Gt + l * (P + D) * a.r + i;
  const T* mr = a.mrt + l * D * a.r + i;
  T L[P], w[D], go[D];
#pragma unroll (Unroll<D>::value)
  for (int q = 0; q < P; ++q) L[q] = g[q * a.r];
#pragma unroll (Unroll<D>::value)
  for (int k = 0; k < D; ++k) go[k] = g[(P + k) * a.r];
#pragma unroll (Unroll<D>::value)
  for (int k = 0; k < D; ++k) w[k] = mr[k * a.r];
#ifndef AMF_CHOL_STAGED_ZX
  T zx[D];  // z, then x: the thread's own D contiguous values
  const T* zrow = a.z + l * a.z_lane + i * D;
#pragma unroll (Unroll<D>::value)
  for (int k = 0; k < D; ++k) zx[k] = zrow[k];
#endif

  // the lane's constants, once a block
  const T* alpha = a.alpha + l * D * D;
  for (int q = tid; q < D * D; q += kThreads) {
    const int p = q / D, j = q % D;
    if (j <= p) s_alpha[tri(p, j)] = alpha[q];
  }
  if (tid < D) {
    T s = T(0);
    for (int j = 0; j < D; ++j) s += alpha[tid * D + j] * a.mu[l * D + j];
    s_amu[tid] = s;
    if (a.cell_row) s_o[tid] = a.other[l * a.other_lane + a.cell_col[l] * D + tid];
  }
#ifdef AMF_CHOL_STAGED_ZX
  // probe: the block copies its (rows, D) slab of z through shared memory
  const T* zs = a.z + l * a.z_lane + i0 * D;
  for (int e = tid; e < rows * D; e += kThreads)
    s_zx[(e / D) * ZS + e % D] = zs[e];
  T* zx = s_zx + tid * ZS;
#endif
  __syncthreads();

  if (active) {
#pragma unroll (Unroll<D>::value)
    for (int q = 0; q < P; ++q) L[q] = s_alpha[q] + a.beta * L[q];
#pragma unroll (Unroll<D>::value)
    for (int k = 0; k < D; ++k)
      w[k] = a.beta * (w[k] - center * go[k]) + s_amu[k];
    if (i == cell_row) {
      const T sm = a.beta * a.dm[l];
      const T sr = a.beta * (a.dr[l] - a.dm[l] * center);
#pragma unroll (Unroll<D>::value)
      for (int p = 0; p < D; ++p) {
#pragma unroll (Unroll<D>::value)
        for (int q = 0; q <= p; ++q) L[tri(p, q)] += sm * (s_o[p] * s_o[q]);
        w[p] += sr * s_o[p];
      }
    }
    factor_solve_sample<T, D, kCopyOnly>(L, w, RowZ<T>{zx});
#ifdef AMF_CHOL_STAGED_ZX
#pragma unroll (Unroll<D>::value)
    for (int k = 0; k < D; ++k) zx[k] = w[k];
#else
    T* xrow = a.out + (l * a.r + i) * D;
#pragma unroll (Unroll<D>::value)
    for (int k = 0; k < D; ++k) xrow[k] = w[k];
#endif
  }
#ifdef AMF_CHOL_STAGED_ZX
  __syncthreads();
  T* xs = a.out + (l * a.r + i0) * D;
  for (int e = tid; e < rows * D; e += kThreads)
    xs[e] = s_zx[(e / D) * ZS + e % D];
#endif
}

// ---------------------------------------------------------------------------
// launches

template <typename T, int D, bool kCopyOnly = false>
cudaError_t launch(const T* S, const T* rhs, const T* z, T* out, int64_t B,
                   cudaStream_t stream) {
  const int64_t blocks = (B + kThreads - 1) / kThreads;
  chol_solve_sample_kernel<T, D, kCopyOnly>
      <<<(unsigned)blocks, kThreads, 0, stream>>>(S, rhs, z, out, B);
  return cudaGetLastError();
}

template <typename T, int D, bool kCopyOnly = false>
cudaError_t launch_gram(const GramArgs<T>& a, int64_t L, cudaStream_t stream) {
  chol_gram_kernel<T, D, kCopyOnly>
      <<<(unsigned)(L * a.chunks), kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

#ifdef AMF_CHOL_ONLY_D
#define AMF_CASES(CALL) \
  case AMF_CHOL_ONLY_D: \
    return CALL(AMF_CHOL_ONLY_D);
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
cudaError_t dispatch(const T* S, const T* rhs, const T* z, T* out, int64_t B,
                     int d, cudaStream_t stream) {
  if (B <= 0 || B > (int64_t)kThreads * 0x7fffffffLL) return cudaErrorInvalidValue;
  switch (d) {
#define AMF_CALL(N) (launch<T, N>(S, rhs, z, out, B, stream))
    AMF_CASES(AMF_CALL)
#undef AMF_CALL
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_gram(GramArgs<T> a, int64_t L, int d, cudaStream_t stream) {
  if (L <= 0 || a.r <= 0 || a.c <= 0) return cudaErrorInvalidValue;
  const int64_t chunks = (a.r + kThreads - 1) / kThreads;
  if (chunks * L > 0x7fffffffLL) return cudaErrorInvalidValue;
  a.chunks = (int)chunks;
  switch (d) {
#define AMF_CALL(N) (launch_gram<T, N>(a, L, stream))
    AMF_CASES(AMF_CALL)
#undef AMF_CALL
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// S (d*d, B) row-major entries S[i*d + j][b] = S_b(i, j); rhs, z and out (d, B).
extern "C" int amf_chol_solve_sample_f32(const float* S, const float* rhs,
                                         const float* z, float* out,
                                         long long B, int d, void* stream) {
  return (int)dispatch<float>(S, rhs, z, out, (int64_t)B, d,
                              (cudaStream_t)stream);
}

extern "C" int amf_chol_solve_sample_f64(const double* S, const double* rhs,
                                         const double* z, double* out,
                                         long long B, int d, void* stream) {
  return (int)dispatch<double>(S, rhs, z, out, (int64_t)B, d,
                               (cudaStream_t)stream);
}

// The Gram-fed entry; shapes and strides as in GramArgs. center may be null (nothing is
// subtracted); cell_row null means no lane has a cell, and other, cell_col,
// dm and dr are then not read.
#define AMF_GRAM_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const T* Gt, const T* mrt, const T* z, const T* alpha,  \
                      const T* mu, const T* center, const T* other,           \
                      const int64_t* cell_row, const int64_t* cell_col,       \
                      const T* dm, const T* dr, T* out, double beta,          \
                      long long L, long long r, long long c,                  \
                      long long z_lane, long long other_lane, int d,          \
                      void* stream) {                                         \
    GramArgs<T> a{Gt, mrt, z, alpha, mu, center, other, cell_row, cell_col,   \
                  dm, dr, out, (T)beta, (int64_t)r, (int64_t)c,               \
                  (int64_t)z_lane, (int64_t)other_lane, 0};                   \
    return (int)dispatch_gram<T>(a, (int64_t)L, d, (cudaStream_t)stream);     \
  }
AMF_GRAM_ENTRY(amf_chol_gram_solve_sample_f32, float)
AMF_GRAM_ENTRY(amf_chol_gram_solve_sample_f64, double)

#ifdef AMF_CHOL_PROBE
// Copy-only twins at d = 10, f32: the same loads and stores, no factorisation.
// mode 0: the batch-minor entry (Gt is S, mrt is rhs); mode 1: the Gram-fed.
extern "C" int amf_chol_copy_probe_f32(int mode, const float* Gt,
                                       const float* mrt, const float* z,
                                       const float* alpha, const float* mu,
                                       float* out, long long L, long long r,
                                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == 0) return (int)launch<float, 10, true>(Gt, mrt, z, out, L * r, s);
  GramArgs<float> a{Gt, mrt, z, alpha, mu, nullptr, nullptr, nullptr, nullptr,
                    nullptr, nullptr, out, 2.0f, (int64_t)r, 1,
                    (int64_t)r * 10, 0, (int)((r + kThreads - 1) / kThreads)};
  return (int)launch_gram<float, 10, true>(a, L, s);
}
#endif
