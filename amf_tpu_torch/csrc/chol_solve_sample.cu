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
// What bounds it on this card: at D = 10 one matrix moves ~85 values through
// device memory (the 55 of S's lower triangle, b, z and x) for ~D^3/3 + 2 D^2
// ~ 530 flops, about 1.6 flop per byte in f32. That is far below the H100's
// balance point, so the kernel is bound by memory traffic and by latency.
// What the design does about it:
//   * one thread per matrix; the factor is a packed lower triangle in a
//     per-thread array. For D <= 16 every loop is unrolled at compile time
//     and the array lives in registers; above that the loops stay rolled and
//     the array lives in local memory (L1-cached). Fully unrolled large D
//     spilled tens of KB a thread anyway and made the build take minutes;
//   * batch-minor layout: value k of matrix b sits at [k * B + b], so the 32
//     threads of a warp read 32 neighbouring addresses for every k;
//   * only the lower triangle of S is read, once; every load is issued before
//     the arithmetic starts;
//   * the ragged tail of the last block is masked, so nothing is padded.
//
// C interface (loaded with ctypes): amf_chol_solve_sample_{f32,f64}(S, rhs,
// z, out, B, d, stream) with S (d*d, B) row-major entries S[i*d + j][b] =
// S_b(i, j), rhs, z and out (d, B). Returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxUnrolledD = 16;

// Unroll factor of every loop: all of it up to kMaxUnrolledD, none above.
template <int D>
struct Unroll {
  static const int value = D <= kMaxUnrolledD ? D : 1;
};

__host__ __device__ constexpr int tri(int i, int j) { return i * (i + 1) / 2 + j; }

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
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
  for (int j = 0; j < D; ++j) w[j] += z[(int64_t)j * B + b];
  // back substitution L^T x = w
#pragma unroll (Unroll<D>::value)
  for (int j = D - 1; j >= 0; --j) {
    T t = w[j];
#pragma unroll (Unroll<D>::value)
    for (int k = j + 1; k < D; ++k) t -= L[tri(k, j)] * w[k];
    w[j] = t * inv[j];
  }
#pragma unroll (Unroll<D>::value)
  for (int j = 0; j < D; ++j) out[(int64_t)j * B + b] = w[j];
}

template <typename T, int D>
cudaError_t launch(const T* S, const T* rhs, const T* z, T* out, int64_t B,
                   cudaStream_t stream) {
  const int64_t blocks = (B + kThreads - 1) / kThreads;
  chol_solve_sample_kernel<T, D>
      <<<(unsigned)blocks, kThreads, 0, stream>>>(S, rhs, z, out, B);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const T* S, const T* rhs, const T* z, T* out, int64_t B,
                     int d, cudaStream_t stream) {
  if (B <= 0 || B > (int64_t)kThreads * 0x7fffffffLL) return cudaErrorInvalidValue;
  switch (d) {
#define AMF_CASE(N) \
  case N:           \
    return launch<T, N>(S, rhs, z, out, B, stream);
    AMF_CASE(1) AMF_CASE(2) AMF_CASE(3) AMF_CASE(4) AMF_CASE(5) AMF_CASE(6)
    AMF_CASE(7) AMF_CASE(8) AMF_CASE(9) AMF_CASE(10) AMF_CASE(11) AMF_CASE(12)
    AMF_CASE(13) AMF_CASE(14) AMF_CASE(15) AMF_CASE(16) AMF_CASE(17)
    AMF_CASE(18) AMF_CASE(19) AMF_CASE(20) AMF_CASE(21) AMF_CASE(22)
    AMF_CASE(23) AMF_CASE(24) AMF_CASE(25) AMF_CASE(26) AMF_CASE(27)
    AMF_CASE(28) AMF_CASE(29) AMF_CASE(30) AMF_CASE(31) AMF_CASE(32)
#undef AMF_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

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
