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
// the rated cells and the lane's own cell, and E is exactly 0 elsewhere. At
// the MovieLens-100k shape (943 x 1682, d = 10, ~5,000 cells rated in the
// smoke's data) that is ~3 * 5,000 * 10 multiply-adds a lane, against
// (943 + 1682) * 10 factor values in and as many gradient values out: bytes
// bound it, and below them the latency of a lane's dependent passes.
// What the design does about it:
//   * the caller indexes the rated cells of the shared mask once (not once an
//     evaluation): by row (CSR: pointers, columns, R's values), by column
//     (CSC: pointers, rows) and, for every CSC entry, the position of the
//     same cell in CSR order. The kernel never reads the dense mask or R;
//     the ~100 KB index is shared by all lanes and stays in L2;
//   * one launch, one block a lane. The block copies the lane's U and V into
//     shared memory with coalesced loads, converted to float, rows at an odd
//     stride (a thread a row then meets no bank conflicts);
//   * row pass: a thread a row walks that row's CSR entries in order,
//     computes e = r - u.v once per rated cell, keeps e in shared memory in
//     CSR order, and sums Gu and the row's squared error in that order;
//   * column pass: a thread a column walks its CSC entries, fetches e through
//     the CSC -> CSR position and sums Gv in that order: no second U V^T
//     product, no mask read;
//   * the lane's own cell replaces the rated value when the cell is rated and
//     is one more cell of its row and column when not (its e sits after the
//     rated cells'); a cell outside the problem is ignored;
//   * the threads' squared errors are summed by a tree in shared memory. No
//     atomics anywhere and every sum in a fixed order: the value is bitwise
//     the same from run to run, so the line search's accept test `f' < f`
//     cannot change between runs;
//   * gradients leave coalesced in the caller's layout: (L, d, rows) straight
//     from the threads (neighbouring rows, neighbouring addresses), (L, rows,
//     d) through a per-warp tile of shared memory;
//   * the factor width d (<= 32) is bucketed to 8, 16 or 32 at compile time
//     so a row of factors sits in registers; a wider d is built one library
//     a width (-DAMF_ONLY_D=d, the caller's choice above 32).
// Where a lane's factors and residuals do not fit the 227 KB a block may have
// (943 x 1682 at d = 32), the caller picks the variant that runs the same
// walk on the factors in global memory (they sit in L2), with e in a scratch
// buffer. With L far below the 132 SMs the card is mostly idle: more than
// one block a lane is left for a later change.
//
// C interface (loaded with ctypes): amf_pmf_value_grad(...) and
// amf_pmf_value_grad_smem_bytes(...), at the bottom of this file.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may take

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
  const int32_t* row_ptr;  // (n + 1,) rated cells by row (CSR)
  const int32_t* col_idx;  // (nnz,)
  const void* r_row;       // (nnz,) R of those cells, type T
  const int32_t* col_ptr;  // (m + 1,) rated cells by column (CSC)
  const int32_t* row_idx;  // (nnz,)
  const int32_t* csc_pos;  // (nnz,) CSR position of each CSC entry
  const int64_t* di;       // (L,)
  const int64_t* dj;       // (L,)
  const float* dv;         // (L,)
  const float* sig;        // (3,) sigma^2, sigma_u^2, sigma_v^2
  void* gu;                // like U, type TO
  void* gv;                // like V, type TO
  float* e_scratch;        // (L, nnz + 1): e, when it is not in shared memory
  float* sqerr;            // (L,)
  int64_t n, m, nnz;
  int d;
  Strides su, sv;
};

// threads a block: a d <= 16 row of factors, its gradient and one gathered
// row stay in registers at 512 threads (<= 128 a thread); 256 above
constexpr int threads_for(int dmax) { return dmax <= 16 ? 512 : 256; }

// floats of shared memory: the reduction, the warps' output tiles and, with
// the factors in shared memory, U, V and e
inline int64_t smem_floats(int nt, int64_t n, int64_t m, int64_t nnz, int d,
                            bool shared) {
  const int ds = d | 1;
  return nt + (int64_t)nt * ds + (shared ? (n + m) * ds + nnz + 1 : 0);
}

template <bool kRound>
__device__ __forceinline__ float scaled_resid(float e, float inv_sig) {
  const float r = e * inv_sig;
  return kRound ? __bfloat162float(__float2bfloat16(r)) : r;
}

// A lane's factor: rows at stride ds in shared memory, or where the caller
// left it.
template <typename T, bool kShared>
struct Factor {
  const float* s;  // shared copy, (rows, ds)
  const T* g;      // the lane's factor in global memory
  Strides st;
  int ds;
  __device__ __forceinline__ float operator()(int64_t row, int k) const {
    return kShared ? s[row * ds + k] : to_f(g[row * st.row + k * st.k]);
  }
};

// Copy a lane's factor into shared memory in the order it lies in global
// memory, so neighbouring threads read neighbouring addresses.
template <typename T, int NT>
__device__ void stage_factor(const T* g, Strides st, int64_t rows, int d,
                             int ds, float* s) {
  // element e of the lane's factor is (major, minor) = (e / inner, e % inner)
  // with inner = d for (rows, d) and rows for (d, rows); the pair is stepped
  // along with e, so the loop holds no division
  const bool by_rows = st.k == 1;
  const int inner = by_rows ? d : (int)rows;
  const int total = (int)rows * d;
  const int step_major = NT / inner, step_minor = NT % inner;
  int major = threadIdx.x / inner, minor = threadIdx.x % inner;
  for (int e = threadIdx.x; e < total; e += NT) {
    s[by_rows ? major * ds + minor : minor * ds + major] = to_f(g[e]);
    major += step_major;
    minor += step_minor;
    if (minor >= inner) {
      minor -= inner;
      ++major;
    }
  }
}

// The warp's 32 rows of gradients, row0 + lane each, to global memory.
template <typename TO, int DMAX>
__device__ __forceinline__ void store_rows(TO* G, Strides st, int64_t row0,
                                           int64_t rows, int d, int ds,
                                           const float (&g)[DMAX], float* tile) {
  const int lane = threadIdx.x & 31;
  if (st.row == 1) {  // (d, rows): neighbouring rows, neighbouring addresses
    if (row0 + lane < rows) {
#pragma unroll
      for (int k = 0; k < DMAX; ++k)
        if (k < d) G[k * st.k + row0 + lane] = from_f<TO>(g[k]);
    }
    return;
  }
  // (rows, d): the warp's rows are one contiguous run of values
#pragma unroll
  for (int k = 0; k < DMAX; ++k)
    if (k < d) tile[lane * ds + k] = g[k];
  __syncwarp();
  const int64_t left = rows - row0;
  const int count = (int)(left < 32 ? left : 32) * d;
  for (int e = lane; e < count; e += 32) {
    const int row = e / d;
    G[row0 * d + e] = from_f<TO>(tile[row * ds + (e - row * d)]);
  }
  __syncwarp();
}

template <typename T, typename TO, bool kRound, int DMAX, int NT, bool kShared>
__global__ void __launch_bounds__(NT) value_grad(Args a) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int d = a.d, ds = a.d | 1;
  const int64_t l = blockIdx.x;
  float* red = smem;                                 // (NT,)
  float* tile = smem + NT + (tid >> 5) * 32 * ds;    // this warp's (32, ds)
  float* s_u = smem + NT + NT * ds;                  // (n, ds)
  float* s_v = s_u + a.n * ds;                       // (m, ds)
  float* E = kShared ? s_v + a.m * ds : a.e_scratch + l * (a.nnz + 1);

  const T* Ug = (const T*)a.U + l * a.su.lane;
  const T* Vg = (const T*)a.V + l * a.sv.lane;
  if (kShared) {
    stage_factor<T, NT>(Ug, a.su, a.n, d, ds, s_u);
    stage_factor<T, NT>(Vg, a.sv, a.m, d, ds, s_v);
    __syncthreads();
  }
  const Factor<T, kShared> U{s_u, Ug, a.su, ds}, V{s_v, Vg, a.sv, ds};
  const T* r_row = (const T*)a.r_row;
  const float inv_sig = 1.0f / a.sig[0];
  const float sig_u = a.sig[1], sig_v = a.sig[2];
  const int64_t di = a.di[l], dj = a.dj[l];
  const float dv = a.dv[l];
  const bool cell_ok = di >= 0 && di < a.n && dj >= 0 && dj < a.m;

  // row pass: e of every rated cell, Gu, the squared error
  float sq = 0.0f;
  for (int64_t base = 0; base < a.n; base += NT) {
    const int64_t row0 = base + (tid & ~31);
    if (row0 >= a.n) break;  // the whole warp leaves together
    const int64_t i = base + tid;
    float x[DMAX], g[DMAX];
#pragma unroll
    for (int k = 0; k < DMAX; ++k) {
      x[k] = (i < a.n && k < d) ? U(i, k) : 0.0f;
      g[k] = 0.0f;
    }
    if (i < a.n) {
      const bool mine = cell_ok && i == di;
      bool found = false;
      const int end = a.row_ptr[i + 1];
      for (int e = a.row_ptr[i]; e <= end; ++e) {
        int64_t j;
        float r;
        if (e < end) {
          j = a.col_idx[e];
          const bool hit = mine && j == dj;
          found |= hit;
          r = hit ? dv : to_f(r_row[e]);
        } else {  // after the rated cells: the lane's cell, not rated
          if (!mine || found) break;
          j = dj;
          r = dv;
        }
        float v[DMAX];
        float pred = 0.0f;
#pragma unroll
        for (int k = 0; k < DMAX; ++k) {
          v[k] = k < d ? V(j, k) : 0.0f;
          pred = fmaf(x[k], v[k], pred);
        }
        const float err = r - pred;
        sq = fmaf(err, err, sq);
        E[e < end ? e : a.nnz] = err;
        const float rs = scaled_resid<kRound>(err, inv_sig);
#pragma unroll
        for (int k = 0; k < DMAX; ++k) g[k] = fmaf(rs, v[k], g[k]);
      }
#pragma unroll
      for (int k = 0; k < DMAX; ++k) g[k] -= x[k] / sig_u;
    }
    store_rows<TO, DMAX>((TO*)a.gu + l * a.su.lane, a.su, row0, a.n, d, ds, g,
                         tile);
  }
  red[tid] = sq;
  __syncthreads();  // e and the partial sums are visible to the block

  // column pass: Gv from the stored e
  for (int64_t base = 0; base < a.m; base += NT) {
    const int64_t row0 = base + (tid & ~31);
    if (row0 >= a.m) break;
    const int64_t j = base + tid;
    float x[DMAX], g[DMAX];
#pragma unroll
    for (int k = 0; k < DMAX; ++k) {
      x[k] = (j < a.m && k < d) ? V(j, k) : 0.0f;
      g[k] = 0.0f;
    }
    if (j < a.m) {
      const bool mine = cell_ok && j == dj;
      bool found = false;
      const int end = a.col_ptr[j + 1];
      for (int e = a.col_ptr[j]; e <= end; ++e) {
        int64_t i;
        float err;
        if (e < end) {
          i = a.row_idx[e];
          found |= mine && i == di;
          err = E[a.csc_pos[e]];
        } else {
          if (!mine || found) break;
          i = di;
          err = E[a.nnz];
        }
        const float rs = scaled_resid<kRound>(err, inv_sig);
#pragma unroll
        for (int k = 0; k < DMAX; ++k)
          if (k < d) g[k] = fmaf(rs, U(i, k), g[k]);
      }
#pragma unroll
      for (int k = 0; k < DMAX; ++k) g[k] -= x[k] / sig_v;
    }
    store_rows<TO, DMAX>((TO*)a.gv + l * a.sv.lane, a.sv, row0, a.m, d, ds, g,
                         tile);
  }

  // sqerr[l]: the threads' sums, added in a fixed order
  for (int w = NT / 2; w > 0; w >>= 1) {
    if (tid < w) red[tid] += red[tid + w];
    __syncthreads();
  }
  if (tid == 0) a.sqerr[l] = red[0];
}

template <typename T, typename TO, bool kRound, int DMAX, bool kShared>
cudaError_t launch(const Args& a, int64_t L, cudaStream_t stream) {
  constexpr int NT = threads_for(DMAX);
  const int64_t bytes = 4 * smem_floats(NT, a.n, a.m, a.nnz, a.d, kShared);
  if (bytes > kSmemLimit) return cudaErrorInvalidValue;
  auto kernel = value_grad<T, TO, kRound, DMAX, NT, kShared>;
  static bool configured = false;  // once per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  kernel<<<(unsigned)L, NT, (size_t)bytes, stream>>>(a);
  return cudaGetLastError();
}

// The widths this library takes: 1..32 in buckets of 8, 16 and 32, or, built
// with -DAMF_ONLY_D=d, the one width d.
#ifdef AMF_ONLY_D
static_assert(AMF_ONLY_D >= 1, "AMF_ONLY_D is a factor width");
constexpr bool width_ok(int d) { return d == AMF_ONLY_D; }
constexpr int bucket(int) { return AMF_ONLY_D; }
#else
constexpr bool width_ok(int d) { return d >= 1 && d <= 32; }
constexpr int bucket(int d) { return d <= 8 ? 8 : d <= 16 ? 16 : 32; }
#endif

template <typename T, typename TO, bool kRound>
cudaError_t by_width(const Args& a, int64_t L, bool shared, cudaStream_t s) {
#define AMF_WIDTH(DMAX)                                                    \
  return shared ? launch<T, TO, kRound, DMAX, true>(a, L, s)               \
                : launch<T, TO, kRound, DMAX, false>(a, L, s)
#ifdef AMF_ONLY_D
  AMF_WIDTH(AMF_ONLY_D);
#else
  if (a.d <= 8) AMF_WIDTH(8);
  if (a.d <= 16) AMF_WIDTH(16);
  AMF_WIDTH(32);
#endif
#undef AMF_WIDTH
}

}  // namespace

// Bytes of shared memory a block of the shared-memory variant needs; the
// caller takes that variant when they are at most amf_pmf_value_grad_smem_limit.
extern "C" long long amf_pmf_value_grad_smem_bytes(long long n, long long m,
                                                   long long nnz, int d) {
  return 4 * smem_floats(threads_for(bucket(d)), n, m, nnz, d, true);
}

extern "C" long long amf_pmf_value_grad_smem_limit() { return kSmemLimit; }

// in_bf16 / out_bf16: 0 for float, 1 for bf16. The combinations taken are
// (float in, float out), (bf16 in, float out) and (bf16 in, bf16 out, with
// the residual rounded: round_resid = 1). shared: 1 keeps the lane's factors
// and residuals in shared memory (they must fit), 0 leaves the factors in
// global memory and takes e_scratch (L, nnz + 1). Strides are in elements; U
// and Gu share u_*, V and Gv share v_*; each factor is contiguous, (rows, d)
// or (d, rows) a lane. d must be a width this library takes (width_ok).
extern "C" int amf_pmf_value_grad(
    int in_bf16, int out_bf16, int round_resid, int shared, const void* U,
    const void* V, const int32_t* row_ptr, const int32_t* col_idx,
    const void* r_row, const int32_t* col_ptr, const int32_t* row_idx,
    const int32_t* csc_pos, const int64_t* di, const int64_t* dj,
    const float* dv, const float* sig, void* gu, void* gv, float* e_scratch,
    float* sqerr, long long L, long long n, long long m, long long nnz, int d,
    long long u_lane, long long u_row, long long u_k, long long v_lane,
    long long v_row, long long v_k, void* stream) {
  if (L < 1 || L > 0x7fffffffLL || n < 1 || m < 1 || nnz < 0 ||
      !width_ok(d) || n > 0x7fffffffLL / (d | 1) ||
      m > 0x7fffffffLL / (d | 1) || nnz >= 0x7fffffffLL ||
      (!shared && e_scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{U, V, row_ptr, col_idx, r_row, col_ptr, row_idx, csc_pos, di, dj, dv,
         sig, gu, gv, e_scratch, sqerr, (int64_t)n, (int64_t)m, (int64_t)nnz,
         d, Strides{u_lane, u_row, u_k}, Strides{v_lane, v_row, v_k}};
  cudaStream_t s = (cudaStream_t)stream;
  if (!in_bf16 && !out_bf16 && !round_resid)
    return (int)by_width<float, float, false>(a, (int64_t)L, shared, s);
  if (in_bf16 && !out_bf16 && !round_resid)
    return (int)by_width<__nv_bfloat16, float, false>(a, (int64_t)L, shared, s);
  if (in_bf16 && out_bf16 && round_resid)
    return (int)by_width<__nv_bfloat16, __nv_bfloat16, true>(a, (int64_t)L,
                                                            shared, s);
  return (int)cudaErrorInvalidValue;
}
