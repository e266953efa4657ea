// Every lane's noise of one Gibbs round in one launch, for Hopper (sm_90a):
// the numbers PyTorch's own per-lane calls give, bit for bit.
//
// Replaces no Pallas kernel: the JAX package draws a round's noise from each
// lane's threefry key inside its jitted round. The port keys each (candidate,
// value) lane by a torch.Generator of its own (utils/rng.lane_generators) and
// drew a round as, for each lane l,
//
//     row_l.normal_(generator=gen_l)                     (size values)
//     torch._standard_gamma(shape, generator=gen_l)      (k values)
//
// two launches of a few microseconds a lane: 2 L launches and their host
// calls a round, 30,720 a 512-lane, 30-round tile. The device work is tiny.
//
// A CUDA generator is a (seed, Philox offset) pair, and both calls are plain
// functions of it. This kernel computes, for all lanes at once, what those two
// launches compute, from each lane's seed and offset:
//
//   * normals (torch 2.11's torch/include/ATen/native/cuda/
//     DistributionTemplates.h: calc_execution_policy :50-62,
//     distribution_elementwise_grid_stride_kernel :65-88,
//     normal_and_transform :444-456, normal_kernel :461-473;
//     transformation::normal in ATen/core/TransformationHelper.h:97). A
//     tensor of `size` values is drawn by a grid of G blocks of 256 threads,
//     G = min(SMs * (max threads per SM / 256), ceil(size / 256)); thread idx
//     runs curand_init(seed, idx, offset) and, with T = 256 G threads and
//     unroll U (4 for float: curand_normal4; 2 for double:
//     curand_normal2_double), writes value ii of its k-th draw to element
//     idx + T (k U + ii) while that is below size. The generator then moves
//     by ((size - 1) / (T U) + 1) * 4. The caller passes G (normal_blocks),
//     which it computes from the card's properties as torch does
//     (ops/lane_noise.normal_policy);
//   * Gamma variates (torch 2.11's ATen/native/Distributions.h: compat_*
//     :16-24 from c10/cuda/CUDAMathCompat.h, BaseSampler :50-56,
//     sample_gamma :85-112; the launch itself is in torch's Distributions.cu,
//     which the wheel does not ship). Element e of lane l is drawn by thread
//     e of a pointwise apply (ATen/cuda/CUDAApplyUtils.cuh
//     kernelPointwiseApply2 :359-370, one element a thread), which runs
//     curand_init(seed, e, offset) on the generator's offset after the
//     normals, sample_gamma with curand_uniform and curand_normal as its
//     samplers in the type's accumulate type (float for float, double for
//     double), and keeps the larger of the sample and the type's smallest
//     normal number. Read on the H100 with torch 2.11.0+cu128: the call
//     moves the generator by 12 (philox_cuda_state(10), rounded up to a
//     multiple of 4) at every size from 1 to 3,000,000 values, and with
//     thread e on element e every value agrees bit for bit
//     (tests/test_torch_lane_noise.py holds the values, at shapes below 1
//     too, and every generator's offset).
//
// What bounds it on this card: by bytes, writing the normals, L * size values
// (512 lanes x 15,880 f32 at the DrugBank lookahead's round, 32.6 MB: 10 us at
// 3.35 TB/s). In fact the Philox rounds and Box-Muller transforms bound it:
// below 270,336 values a thread keeps one value but, as in torch, runs
// curand_init (one Philox block) and curand_normal4 (another, and two
// Box-Muller pairs). Measured on the H100: 0.130 ms at that round and 0.264
// ms at 160 lanes x 105,840 (7.5 and 7.7 % of the byte bound), against 15.4
// and 4.6 ms of host time for the per-lane calls. Computing only the value
// kept would cut that work by about half with the same bits; at one launch a
// round against a round of milliseconds elsewhere it is not worth a second
// form. The design: one launch, a grid of (G + ceil(k / 256), lanes); the
// first G blocks of a lane are torch's normal grid, with its threads, loop
// and stores (neighbouring threads write neighbouring elements), and the
// last blocks draw its Gamma variates, a thread an element (a second launch
// for them measured the same). Every lane reads its seed and offset from
// device memory (offset = base + starts[l], starts may be null), so a
// chain's rounds need no host work a lane. Arithmetic is the headers' own,
// in the caller's type; the library is built without fast math, as torch is.
//
// C interface (loaded with ctypes): see the bottom of this file. Every
// function returns the cudaError_t of its launch.

#include <cuda_runtime.h>
#include <curand_kernel.h>
#include <stdint.h>

#include <cfloat>

namespace {

constexpr int kBlock = 256;  // torch's block_size_bound
constexpr int kMaxLaneBlocks = 65535;  // gridDim.y

// the curand draw torch's normal_ takes a thread at a time, and its unroll
template <typename T>
struct NormalDraw;
template <>
struct NormalDraw<float> {
  static constexpr int kUnroll = 4;
  __device__ static float4 draw(curandStatePhilox4_32_10_t* s) {
    return curand_normal4(s);
  }
};
template <>
struct NormalDraw<double> {
  static constexpr int kUnroll = 2;
  __device__ static double2 draw(curandStatePhilox4_32_10_t* s) {
    return curand_normal2_double(s);
  }
};

// std::numeric_limits<T>::min(), the smallest normal number
template <typename T>
struct Tiny;
template <>
struct Tiny<float> {
  static constexpr float value = FLT_MIN;
};
template <>
struct Tiny<double> {
  static constexpr double value = DBL_MIN;
};

// c10::cuda::compat (CUDAMathCompat.h): the float functions for float
__device__ __forceinline__ float compat_pow(float x, float y) {
  return ::powf(x, y);
}
__device__ __forceinline__ double compat_pow(double x, double y) {
  return ::pow(x, y);
}
__device__ __forceinline__ float compat_sqrt(float x) { return ::sqrtf(x); }
__device__ __forceinline__ double compat_sqrt(double x) { return ::sqrt(x); }
__device__ __forceinline__ float compat_log(float x) { return ::logf(x); }
__device__ __forceinline__ double compat_log(double x) { return ::log(x); }

// ATen/native/Distributions.h sample_gamma (:85-112) as it stands, with
// scalar_t = accscalar_t = T and its samplers curand_uniform and
// curand_normal on the thread's state (converted to T, as BaseSampler<T>
// converts them). The float literals are the header's.
template <typename T>
__device__ T sample_gamma(T alpha, curandStatePhilox4_32_10_t* state) {
  T scale = 1.0f;

  // Boost alpha for higher acceptance probability.
  if (alpha < 1.0f) {
    if (alpha == 0.f) return 0.f;
    scale *= compat_pow(1 - static_cast<T>(curand_uniform(state)),
                        1.0f / alpha);
    alpha += 1.0f;
  }

  // Marsaglia and Tsang (2000), doi:10.1145/358407.358414
  const T d = alpha - 1.0f / 3.0f;
  const T c = 1.0f / compat_sqrt(9.0f * d);
  for (;;) {
    T x, y;
    do {
      x = static_cast<T>(curand_normal(state));
      y = 1.0f + c * x;
    } while (y <= 0);
    const T v = y * y * y;
    const T u = 1 - static_cast<T>(curand_uniform(state));
    const T xx = x * x;
    if (u < 1.0f - 0.0331f * xx * xx)
      return static_cast<T>(scale * d * v);
    if (compat_log(u) < 0.5f * xx + d * (1.0f - v + compat_log(v)))
      return static_cast<T>(scale * d * v);
  }
}

template <typename T>
struct Args {
  const int64_t* seeds;   // (L,) each lane's generator seed (its 64 bits)
  const int64_t* starts;  // (L,) each lane's offset before base, or null
  uint64_t base;          // added to every lane's offset
  T* normals;             // (L, size)
  int64_t size;
  int normal_blocks;      // torch's grid for `size` values; 0 when size = 0
  uint64_t gamma_skip;    // the normals' increment of the offset
  const T* shape;         // (k,) Gamma shapes, shared by every lane
  T* gammas;              // (L, k)
  int k;
  int64_t L;
};

// grid (normal_blocks + ceil(k / kBlock), min(L, kMaxLaneBlocks)); block kBlock
template <typename T>
__global__ void __launch_bounds__(kBlock) lane_noise_kernel(Args<T> a) {
  constexpr int U = NormalDraw<T>::kUnroll;
  const bool normal = (int)blockIdx.x < a.normal_blocks;
  for (int64_t l = blockIdx.y; l < a.L; l += gridDim.y) {
    const unsigned long long seed = (unsigned long long)a.seeds[l];
    const unsigned long long offset =
        a.base + (a.starts ? (uint64_t)a.starts[l] : 0);
    curandStatePhilox4_32_10_t state;
    if (normal) {
      const int64_t idx = (int64_t)blockIdx.x * kBlock + threadIdx.x;
      const int64_t stride = (int64_t)kBlock * a.normal_blocks;
      const int64_t rounded = ((a.size - 1) / (stride * U) + 1) * stride * U;
      T* out = a.normals + l * a.size;
      curand_init(seed, idx, offset, &state);
      for (int64_t li0 = idx; li0 < rounded; li0 += stride * U) {
        const auto r = NormalDraw<T>::draw(&state);
#pragma unroll
        for (int ii = 0; ii < U; ++ii) {
          const int64_t li = li0 + stride * ii;
          // transformation::normal(rand, mean = 0, std = 1)
          if (li < a.size) out[li] = (&r.x)[ii] * T(1) + T(0);
        }
      }
    } else {
      const int e = ((int)blockIdx.x - a.normal_blocks) * kBlock + threadIdx.x;
      if (e < a.k) {
        curand_init(seed, e, offset + a.gamma_skip, &state);
        const T sample = sample_gamma<T>(a.shape[e], &state);
        const T tiny = Tiny<T>::value;
        a.gammas[l * a.k + e] = (tiny > sample) ? tiny : sample;
      }
    }
  }
}

template <typename T>
cudaError_t launch(Args<T> a, cudaStream_t stream) {
  if (a.L < 0 || a.size < 0 || a.k < 0 || a.normal_blocks < 0 ||
      (a.size > 0) != (a.normal_blocks > 0) || a.size > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const int blocks = a.normal_blocks + (a.k + kBlock - 1) / kBlock;
  if (blocks == 0 || a.L == 0) return cudaSuccess;
  const unsigned lanes =
      (unsigned)(a.L < kMaxLaneBlocks ? a.L : kMaxLaneBlocks);
  lane_noise_kernel<T><<<dim3(blocks, lanes), kBlock, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// seeds (L,) int64; starts (L,) int64 or null; normals (L, size) and gammas
// (L, k) contiguous, written whole; shape (k,) contiguous. k = 0 draws no
// Gamma variates (shape and gammas may be null), size = 0 no normals.
#define AMF_LANE_NOISE_ENTRY(NAME, T)                                         \
  extern "C" int NAME(const int64_t* seeds, const int64_t* starts,            \
                      unsigned long long base, T* normals, long long size,    \
                      int normal_blocks, unsigned long long gamma_skip,       \
                      const T* shape, T* gammas, int k, long long L,          \
                      void* stream) {                                         \
    Args<T> a{seeds,         starts,     (uint64_t)base, normals,            \
              (int64_t)size, normal_blocks, (uint64_t)gamma_skip, shape,     \
              gammas,        k,          (int64_t)L};                         \
    return (int)launch<T>(a, (cudaStream_t)stream);                           \
  }
AMF_LANE_NOISE_ENTRY(amf_lane_noise_f32, float)
AMF_LANE_NOISE_ENTRY(amf_lane_noise_f64, double)
