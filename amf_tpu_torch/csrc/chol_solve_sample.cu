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
// below the H100's balance point, so bytes and latency bound it; at D = 20,
// 290 values for ~3,500 flops, still bytes.
//
// What the design does about it.
//
// The S-given entry: one thread a matrix (factor_solve_sample):
//   * the factor is a packed lower triangle in a per-thread array. For
//     D <= 16 every loop is unrolled at compile time and the array lives in
//     registers; above that the loops stay rolled and the array lives in
//     local memory (L1-cached);
//   * a block takes kThreads consecutive matrices, so the threads of a warp
//     read neighbouring addresses of every batch-minor value.
//
// The Gram-fed entry (chol_gram_kernel): a group of G threads of one warp
// shares one matrix (coop_group, a thread about five rows: G = 2 to D = 10,
// 4 to 20, 8 to 40, 16 to 80, 32 above), thread t owning rows t, t + G, ...
// of S and of its factor, in registers: every index is a compile-time
// constant. On the H100 (160 lanes x 1682 rows and one lane, f32 and f64;
// PERF.md, the B1 row) it is 30 % faster than one thread a matrix at d = 10,
// 35 % at 16 and 7 to 15x from 17, where one thread's loops stop unrolling;
// below 6 one thread a matrix was up to 2x faster on 160 lanes, but no
// workload draws rows that narrow in bulk, so the group serves every D.
//   * A block of kThreads takes kThreads / G consecutive rows of one lane
//     and stages them in shared memory with asynchronous copies (cp.async,
//     so that all of a block's copies are in flight at once and hold no
//     registers): the P + D Gram values and mr of every row (consecutive
//     threads on consecutive rows of one value) and the block's (rows, D)
//     slab of z. Each row is a record at an odd stride, so the threads of a
//     warp that stage one value of 32 rows, and the groups that read one
//     entry of their own rows, do not share a bank. Shared memory is
//     dynamic: f64 at D = 32 and 48 needs more than 48 KB;
//   * S and b are assembled from the records with the lane's constants;
//   * the factor is a left-looking Crout: for column j the owner of row j
//     hands L(j, 0..j-1) to its group by __shfl_sync in ascending k, each
//     thread subtracts them from its rows below j, and the owner's pivot
//     goes round the same way. The forward substitution hands y_j round as
//     it is found, and each thread subtracts L(i, j) y_j from its rows; for
//     the back substitution the group turns its factor through its records
//     (each thread then holds the columns of its rows) and hands x_j round
//     from the bottom up. Every sum is taken in the order of
//     factor_solve_sample, so the two entries differ only where the compiler
//     contracts;
//   * a shuffle never leaves its group, so a matrix that is not positive
//     definite gives NaN on its own row only;
//   * the Crout's chain of shuffles is latency, hidden by more warps an SM:
//     __launch_bounds__ caps the registers a thread by width and type
//     (coop_min_blocks), 9 to 35 % faster than no cap where a cap binds;
//   * x goes back into the records and the block writes its slab with
//     coalesced stores.
//
// The lane's constants (alpha's triangle, alpha mu and the lane's cell) are
// staged once a block in shared memory, and the ragged last block of a lane
// is masked, so nothing is padded, and no transposed or assembled copy of
// anything exists outside the kernel.
//
// C interface (loaded with ctypes): see the bottom of this file. Every
// launching function returns the cudaError_t of its launch.
//
// Widths: built without AMF_ONLY_D the library takes every D from 1 to
// 32; built with AMF_ONLY_D=D it takes that one D. The package builds one
// library a width (cuda_build.width_defines): all 32 in one took 112.8 s of
// nvcc, one width 7 to 17 s. The Gram-fed entry's records must fit the
// 227 KB of shared memory a block may have on the H100 (coop_smem_bytes):
// it takes D up to 149 in f32 and, in f64, up to 77 and from 81 to 104
// (groups of 32 hold fewer records a block); ops/chol_kernel.py refuses a
// wider D before it builds a library. Above D = 48 the register arrays
// spill more and more, and nothing is measured there.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // threads a block, both entries
constexpr int kMinBlocks = 1;   // the S-given entry's __launch_bounds__
constexpr int kMaxUnrolledD = 16;
constexpr unsigned kFullMask = 0xffffffffu;

// Threads that share one matrix in the Gram-fed entry: a power of two (a
// group lies in one warp) that gives a thread about five rows. Mirrored by
// ops/chol_kernel.py's gram_group.
template <int D>
__host__ __device__ constexpr int coop_group() {
  int g = 2;
  while (g < 32 && 5 * g < D) g *= 2;
  return g;
}

// The Gram-fed entry's blocks an SM (the second argument of
// __launch_bounds__, which caps its registers a thread): the cap that was
// fastest on the H100 at d = 6, 10, 16, 17, 20, 24, 32 and 48 (more warps an
// SM hide the Crout's chain of shuffles; f64 at d = 17 and 20 spills a few
// hundred bytes under its cap and is still faster). Widths between take
// their neighbours' cap; above 48 none.
template <typename T, int D>
__host__ __device__ constexpr int coop_min_blocks() {
  if (sizeof(T) == 4) return D <= 24 ? 5 : D <= 48 ? 4 : 1;
  return D <= 7 ? 5 : D <= 16 ? 4 : D <= 20 ? 3 : 1;
}

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

// The shared body. L holds S's lower triangle and is overwritten by the
// factor; w holds b and is overwritten by x.
template <typename T, int D, typename Z>
__device__ __forceinline__ void factor_solve_sample(T (&L)[D * (D + 1) / 2],
                                                    T (&w)[D], const Z& z) {
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

template <typename T, int D>
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
  factor_solve_sample<T, D>(L, w, BatchMinorZ<T>{z + b, B});
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
  int chunks;               // blocks a lane: ceil(r / rows a block)
};

// The lane's constants, once a block: alpha_l's lower triangle, alpha_l mu_l
// and, with cells, the lane cell's factor row. The caller synchronises.
template <typename T, int D>
__device__ __forceinline__ void stage_lane(const GramArgs<T>& a, int64_t l,
                                           T* s_alpha, T* s_amu, T* s_o) {
  const int tid = threadIdx.x;
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
}

// Entries a thread keeps of its row slot q (rows q G .. q G + G - 1 of the
// matrix): columns 0 .. min((q + 1) G, D) - 1.
__host__ __device__ constexpr int slot_width(int q, int G, int D) {
  return (q + 1) * G < D ? (q + 1) * G : D;
}

// A row's record in the Gram-fed kernel's shared memory: the packed Gram (P
// values), G_o (D), mr (D), then z, overwritten by x (D); an odd stride.
template <int D>
__host__ __device__ constexpr int record_stride() {
  return (D * (D + 1) / 2 + 3 * D) | 1;
}

// Matrices a block of the Gram-fed kernel takes.
template <int D>
__host__ __device__ constexpr int gram_rows_a_block() {
  return kThreads / coop_group<D>();
}

// The Gram-fed kernel's dynamic shared memory: the block's records, alpha's
// triangle, alpha mu and the lane cell's factor row. Mirrored by
// ops/chol_kernel.py's gram_smem_bytes.
template <typename T, int D>
__host__ __device__ constexpr size_t coop_smem_bytes() {
  return sizeof(T) * ((size_t)gram_rows_a_block<D>() *
                          record_stride<D>() +
                      D * (D + 1) / 2 + 2 * D);
}

// One value from device memory into shared memory without a register
// (cp.async): the copies of a block are all in flight together.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "n"(sizeof(T))
               : "memory");
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void wait_async() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
#endif
}

// A group of G threads a matrix (see the top of the file). Thread t of a
// group owns rows t, t + G, ... (its slots q = 0 .. R - 1).
template <typename T, int D>
__device__ __forceinline__ void gram_coop(const GramArgs<T>& a) {
  constexpr int P = D * (D + 1) / 2;
  constexpr int G = coop_group<D>();
  constexpr int R = (D + G - 1) / G;  // rows a thread owns
  constexpr int RB = kThreads / G;    // matrices a block
  constexpr int ST = record_stride<D>();
  constexpr int GO = P, MR = P + D, ZX = P + 2 * D;  // offsets in a record
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0,
                "a group is a power of two within one warp");
  static_assert(kThreads % 32 == 0, "whole warps a block");
  extern __shared__ __align__(16) unsigned char s_dyn[];
  T* s_rec = reinterpret_cast<T*>(s_dyn);
  T* s_alpha = s_rec + RB * ST;
  T* s_amu = s_alpha + P;
  T* s_o = s_amu + D;

  const int tid = threadIdx.x;
  const int64_t l = blockIdx.x / a.chunks;
  const int64_t i0 = (int64_t)(blockIdx.x % a.chunks) * RB;
  const int rows = (int)(a.r - i0 < RB ? a.r - i0 : RB);
  const int64_t cell_row = a.cell_row ? a.cell_row[l] : -1;
  const T center = a.center ? a.center[l] : T(0);

  // stage the block's rows: thread tid copies values tid / RB, + G, ... of
  // row tid % RB, so a warp reads one value of consecutive rows. The ragged
  // tail's records copy the block's first row; their groups store nothing.
  {
    const int row = tid % RB;
    const int64_t i = i0 + (row < rows ? row : 0);
    T* rec = s_rec + row * ST;
    const T* g = a.Gt + l * (P + D) * a.r + i;
    const T* mr = a.mrt + l * D * a.r + i;
#pragma unroll 8
    for (int q = tid / RB; q < P + D; q += G) copy_async(rec + q, g + q * a.r);
    for (int q = tid / RB; q < D; q += G)
      copy_async(rec + MR + q, mr + q * a.r);
    const T* zs = a.z + l * a.z_lane + i0 * D;
    for (int e = tid; e < RB * D; e += kThreads) {
      const int zrow = e / D, k = e % D;
      copy_async(s_rec + zrow * ST + ZX + k, zs + (zrow < rows ? e : k));
    }
  }
  stage_lane<T, D>(a, l, s_alpha, s_amu, s_o);
  wait_async();
  __syncthreads();

  const int t = tid % G;
  T* rec = s_rec + (tid / G) * ST;
  const bool cell = i0 + tid / G == cell_row;
  T sm = T(0), sr = T(0);
  if (cell) {
    sm = a.beta * a.dm[l];
    sr = a.beta * (a.dr[l] - a.dm[l] * center);
  }

  // S and b of the thread's rows
  T Lr[R][D];  // slot q: S(q G + t, k), then L(q G + t, k), k <= q G + t
  T w[R];      // b, then y + z, then x
  T inv[R];    // 1 / L(q G + t, q G + t)
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int row = q * G + t;
    const bool mine = row < D;
    const int e0 = mine ? tri(row, 0) : 0;
#pragma unroll
    for (int k = 0; k < slot_width(q, G, D); ++k) {
      T s = T(0);
      if (mine && k <= row) {
        s = s_alpha[e0 + k] + a.beta * rec[e0 + k];
        if (cell) s += sm * (s_o[row] * s_o[k]);
      }
      Lr[q][k] = s;
    }
    T b = T(0);
    if (mine) {
      b = a.beta * (rec[MR + row] - center * rec[GO + row]) + s_amu[row];
      if (cell) b += sr * s_o[row];
    }
    w[q] = b;
    inv[q] = T(0);
  }

  // Cholesky-Crout, left-looking: column j takes row j of L from its owner,
  // k ascending, then the owner's pivot
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const int qj = j / G, tj = j % G;
    T acc[R];
#pragma unroll
    for (int q = 0; q < R; ++q) acc[q] = q >= qj ? Lr[q][j] : T(0);
#pragma unroll
    for (int k = 0; k < j; ++k) {
      const T v = __shfl_sync(kFullMask, Lr[qj][k], tj, G);
#pragma unroll
      for (int q = 0; q < R; ++q)
        if (q >= qj) acc[q] -= Lr[q][k] * v;
    }
    const T r = T(1) / sqrt(__shfl_sync(kFullMask, acc[qj], tj, G));
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (q < qj) continue;
      const int row = q * G + t;
      if (row > j) Lr[q][j] = acc[q] * r;
      else if (row == j) inv[q] = r;
    }
  }

  // forward substitution L y = b: y_j goes round as it is found and each
  // thread takes L(i, j) y_j off its rows below j; then w = y + z
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const int qj = j / G, tj = j % G;
    const T y = __shfl_sync(kFullMask, w[qj] * inv[qj], tj, G);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (q < qj) continue;
      const int row = q * G + t;
      if (row > j) w[q] -= Lr[q][j] * y;
      else if (row == j) w[q] = y;
    }
  }
#pragma unroll
  for (int q = 0; q < R; ++q)
    if (q * G + t < D) w[q] += rec[ZX + q * G + t];

  // turn the factor through the record's triangle: each thread writes the
  // rows it owns and reads the columns it owns
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int row = q * G + t;
    if (row < D) {
#pragma unroll
      for (int k = 0; k < slot_width(q, G, D); ++k)
        if (k < row) rec[tri(row, k)] = Lr[q][k];
    }
  }
  __syncwarp();
  T Lc[R][D];  // slot q: L(k, q G + t), k > q G + t
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int row = q * G + t;
#pragma unroll
    for (int k = q * G + 1; k < D; ++k)
      Lc[q][k] = k > row ? rec[tri(k, row)] : T(0);
  }

  // back substitution L^T x = w, from the bottom up; x_j goes round as it
  // is found and into the record's z
  T xs[D];
#pragma unroll
  for (int j = D - 1; j >= 0; --j) {
    const int qj = j / G, tj = j % G;
    T s = w[qj];
#pragma unroll
    for (int k = j + 1; k < D; ++k) s -= Lc[qj][k] * xs[k];
    xs[j] = __shfl_sync(kFullMask, s * inv[qj], tj, G);
    if (t == tj) rec[ZX + j] = xs[j];
  }

  __syncthreads();
  T* xb = a.out + (l * a.r + i0) * D;
  for (int e = tid; e < rows * D; e += kThreads)
    xb[e] = s_rec[(e / D) * ST + ZX + e % D];
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, coop_min_blocks<T, D>())
chol_gram_kernel(GramArgs<T> a) {
  gram_coop<T, D>(a);
}

// ---------------------------------------------------------------------------
// launches

template <typename T, int D>
cudaError_t launch(const T* S, const T* rhs, const T* z, T* out, int64_t B,
                   cudaStream_t stream) {
  const int64_t blocks = (B + kThreads - 1) / kThreads;
  chol_solve_sample_kernel<T, D>
      <<<(unsigned)blocks, kThreads, 0, stream>>>(S, rhs, z, out, B);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_gram(GramArgs<T> a, int64_t L, cudaStream_t stream) {
  constexpr int rows = gram_rows_a_block<D>();
  const int64_t chunks = (a.r + rows - 1) / rows;
  if (chunks * L > 0x7fffffffLL) return cudaErrorInvalidValue;
  a.chunks = (int)chunks;
  constexpr size_t smem = coop_smem_bytes<T, D>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        chol_gram_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  chol_gram_kernel<T, D><<<(unsigned)(L * chunks), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

#ifdef AMF_ONLY_D
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
