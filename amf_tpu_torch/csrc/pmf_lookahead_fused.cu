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
// a proposal is formed in float from that storage, with no fused
// multiply-add: round(u + round(lr * g)); the products take the proposal
// rounded to `T`, and with bf16 the scaled residual E / s is rounded to bf16
// before the two gradient contractions; the squared error, the prior terms
// of f and of G take the float proposal; every sum is float.
//
// What bounds it on this card: each evaluation needs ~6 d multiply-adds on
// each rated cell and the lane's own cell (pred, Gu, Gv), ~0.3 MFLOP a lane
// at the MovieLens-100k shape (943 x 1682, d = 10, ~5,000 rated cells), over
// up to 1 + max_steps evaluations; its bytes are the index of the rated cells
// and the base factors once and the final factors once. So the bound is set
// by operations; in practice by latency: the launch ends with its slowest
// lane, and that lane's time is a chain of dependent evaluations, each a
// chain of passes over the lane's ~26,000 factor values by one block.
// What the design does about it:
//   * the kernel walks the caller's index of the rated cells (by row, by
//     column, and each column entry's position in row order: the index the
//     value+gradient kernel walks), never the (n, m) mask or R;
//   * one block a lane runs the whole search; an evaluation is
//       propose  a thread a row (then a thread a column) forms the proposal
//                from the stored state, d coalesced loads of the factor and
//                d of the gradient in flight at once, adds its squares, and
//                writes it twice: rounded to T into the lane's spare set of
//                state buffers, and as the products take it into shared
//                memory, rows at an odd stride;
//       row pass a thread a row walks its CSR cells, gathers V's rows from
//                shared memory, keeps every cell's residual e in shared
//                memory in CSR order, sums the squared error and Gu, and
//                writes Gu (with its prior term) to the spare set;
//       value    the threads' three sums (squared error, |U|^2, |V|^2) are
//                added through warp shuffles and then over the warps in a
//                fixed order; every thread forms f and takes the same
//                accept decision, so none waits for another's;
//       column pass, only if the proposal is accepted: a thread a column
//                walks its CSC cells, fetches e through the CSC -> CSR
//                position (no second U V^T product), gathers U's rows from
//                shared memory and writes Gv to the spare set.
//     No gather leaves the SM. No atomics and every sum in a fixed order: f
//     is the same bit for bit from run to run, so the accept test f' < f
//     cannot flip between runs;
//   * the state lives in global memory as (d, rows) a lane, the layout of
//     the output, which a thread a row reads and writes coalesced. There are
//     two sets of it: a proposal and its gradients are written to the spare
//     set, and accepting is swapping the sets, not copying. Set 0 is the
//     output; a lane that ends on set 1 copies its factors once;
//   * the passes are bound by the instructions one block can run, so the
//     library is built for one factor width d (-DAMF_D=d, one library a
//     width): a row of d values is a register array of exactly d, with no
//     slots or predicates of a wider bucket. Built for a bucket of 16 the
//     same kernel took 7.0 ms against 4.0 ms at d = 10 (an H100, 128 lanes,
//     200 steps);
//   * the lane's own cell is found once, when the block starts: where it is
//     rated its value replaces the rated one, where not it is one more cell
//     after its row's and its column's rated cells.
// Where a lane's factors and residuals do not fit the 227 KB a block may
// have (943 x 1682 at d = 32; the residuals alone at the density of the full
// MovieLens-100k ratings), the caller picks the variant that runs the same
// walk with the gathers on the spare set in global memory (it sits in L2)
// and e in a scratch buffer.
// A thread a row suits sparse data like the refit tiles measured so far (~5
// rated cells a row); at ~100 cells a row a warp a row would balance better.
// Tried on the card and left out, each within 3 % of this design: loading
// the next cell's index entries ahead of the current cell's products, two
// rows of the proposal a turn, 768 or 1,024 threads a block. Numbering the
// rows and columns by falling count of rated cells (32 neighbouring rows of
// like length) made the launch 9 % shorter and the refit tile no shorter,
// for the index's longer build and the renumbering of what goes in and out.
// More than one block a lane, as a thread-block cluster of 2 or 4 (every
// block holds the whole proposal and e, does its share of every pass and
// writes what the others gather into every block's shared memory), read
// slower on that tile: 5.4 and 9.9 ms against 3.8 ms with one block, since
// every barrier of an evaluation becomes a cluster barrier and every shared
// store 2 or 4 remote ones.
//
// C interface (loaded with ctypes): amf_pmf_lookahead_fused(...),
// amf_pmf_lookahead_fused_smem_bytes(...) and
// amf_pmf_lookahead_fused_smem_limit(), at the bottom of this file.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#ifndef AMF_D
#error "build with -DAMF_D=<factor width d>: one library a width"
#endif

namespace {

constexpr int D = AMF_D;            // the factor width this library is for
constexpr int DS = D | 1;           // odd stride of a row in shared memory
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may take
// threads a block: a row of factors, its gradient and one gathered row stay
// in registers (3 D + ~45 a thread, 65,536 an SM)
constexpr int NT = D <= 16 ? 512 : 256;
static_assert(D >= 1 && D <= 32, "1 <= d <= 32");

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

// The state streams past the L1 cache (each value is read once an
// evaluation), so that the index, which every evaluation walks, stays in it.
template <typename T>
__device__ __forceinline__ T ld_state(const T* p) { return __ldcg(p); }
template <typename T>
__device__ __forceinline__ void st_state(T* p, T x) { __stcg(p, x); }
template <typename T>
__device__ __forceinline__ T ld_index(const T* p) { return __ldg(p); }

struct Args {
  const void* u0;          // (D, n) base factors, type T
  const void* v0;          // (D, m)
  const int32_t* row_ptr;  // (n + 1,) rated cells by row (CSR)
  const int32_t* col_idx;  // (nnz,)
  const void* r_row;       // (nnz,) R of those cells, type T
  const int32_t* col_ptr;  // (m + 1,) rated cells by column (CSC)
  const int32_t* row_idx;  // (nnz,)
  const int32_t* csc_pos;  // (nnz,) CSR position of each CSC entry
  const int32_t* di;       // (L,)
  const int32_t* dj;       // (L,)
  const float* dv;         // (L,)
  const float* sig;        // (3,) sigma^2, sigma_u^2, sigma_v^2
  const float* ls;         // (3,) lr0, stop_thresh, min_lr
  void* u;                 // (2, L, D, n) type T: both sets of the factors;
  void* v;                 // (2, L, D, m)   set 0 is the output
  void* gu;                // (2, L, D, n) type T: both sets of the gradients
  void* gv;                // (2, L, D, m)
  float* e_scratch;        // (L, nnz + 1): e, when it is not in shared memory
  float* f;                // (L,) final value (output)
  int32_t* counts;         // (L, 2) evaluations made, proposals accepted
                           //   (output)
  int64_t L, n, m, nnz;
  int max_steps;
};

// floats of shared memory a block: the warps' partial sums of the lane and,
// with the factors in shared memory, the proposal's U and V and e
inline int64_t smem_floats(int64_t n, int64_t m, int64_t nnz, bool shared) {
  return 3 * (NT / 32) + (shared ? (n + m) * DS + nnz + 1 : 0);
}

// The proposal's factor as the products take it: rows at stride DS in shared
// memory, or the spare set's (D, rows) in global memory.
template <typename T, bool kShared>
struct Factor {
  const float* s;
  const T* g;
  int rows;
  __device__ __forceinline__ float operator()(int row, int k) const {
    return kShared ? s[row * DS + k] : to_f(ld_state(g + k * rows + row));
  }
};

template <typename T, bool kShared>
struct Search {
  static constexpr int NW = NT / 32;  // warps a block
  static constexpr bool kExact = std::is_same<T, float>::value;

  const Args& a;
  int tid, n, m, nnz, di, dj;  // n D, m D < 2^31 (checked)
  int own_e;  // CSR position of the lane's cell where it is rated, else -1
  int64_t l;
  float *red, *s_u, *s_v, *E;
  float inv_sig, sig_u, sig_v, dv;

  __device__ Search(const Args& args, float* smem) : a(args) {
    tid = threadIdx.x;
    l = blockIdx.x;
    n = (int)a.n;
    m = (int)a.m;
    nnz = (int)a.nnz;
    red = smem;            // (3, NW)
    s_u = smem + 3 * NW;   // (n, DS)
    s_v = s_u + n * DS;    // (m, DS)
    E = kShared ? s_v + m * DS : a.e_scratch + l * (nnz + 1);
    inv_sig = 1.0f / a.sig[0];
    sig_u = a.sig[1];
    sig_v = a.sig[2];
    di = a.di[l];
    dj = a.dj[l];
    dv = a.dv[l];
    // where the lane's cell sits among its row's rated cells (every thread
    // looks for itself: the same few loads)
    own_e = -1;
    const int end = ld_index(a.row_ptr + di + 1);
    for (int e = ld_index(a.row_ptr + di); e < end; ++e)
      if (ld_index(a.col_idx + e) == dj) own_e = e;
  }

  // set s of the lane's state buffers
  __device__ T* U(int s) const { return (T*)a.u + (s * a.L + l) * (n * D); }
  __device__ T* V(int s) const { return (T*)a.v + (s * a.L + l) * (m * D); }
  __device__ T* GU(int s) const { return (T*)a.gu + (s * a.L + l) * (n * D); }
  __device__ T* GV(int s) const { return (T*)a.gv + (s * a.L + l) * (m * D); }

  // element e of the float proposal x + lr g (x alone where g is null)
  __device__ static __forceinline__ float proposed(const T* x, const T* g,
                                                   int e, float lr) {
    const float t = to_f(ld_state(x + e));
    return g ? __fadd_rn(t, __fmul_rn(lr, to_f(ld_state(g + e)))) : t;
  }

  // One side's proposal, a thread a row: rounded to T into `out` (D, rows)
  // and, as the products take it, into shared memory `s`
  // (rows, DS). Returns this thread's share of |proposal|^2.
  __device__ float propose(const T* x, const T* g, float lr, int rows,
                           T* out, float* s) const {
    float sum2 = 0.0f;
    for (int i = tid; i < rows; i += NT) {
      // every load of the row first, so that all are in flight together
      T xs[D], gs[D];
#pragma unroll
      for (int k = 0; k < D; ++k) xs[k] = ld_state(x + k * rows + i);
      if (g) {
#pragma unroll
        for (int k = 0; k < D; ++k) gs[k] = ld_state(g + k * rows + i);
      }
#pragma unroll
      for (int k = 0; k < D; ++k) {
        float t = to_f(xs[k]);
        if (g) t = __fadd_rn(t, __fmul_rn(lr, to_f(gs[k])));
        sum2 = fmaf(t, t, sum2);
        const T q = from_f<T>(t);
        st_state(out + k * rows + i, q);
        if (kShared) s[i * DS + k] = to_f(q);
      }
    }
    return sum2;
  }

  // f at the proposal (xu, xv) + lr (gu, gv). Writes the proposal to
  // (ou, ov), its Gu to ogu, and e; every thread gets f.
  __device__ float value(const T* xu, const T* gu, const T* xv, const T* gv,
                         float lr, T* ou, T* ov, T* ogu) const {
    float s[3];  // squared error, |up|^2, |vp|^2
    s[1] = propose(xu, gu, lr, n, ou, s_u);
    s[2] = propose(xv, gv, lr, m, ov, s_v);
    __syncthreads();
    const Factor<T, kShared> Up{s_u, ou, n}, Vp{s_v, ov, m};
    const T* r_row = (const T*)a.r_row;
    float sq = 0.0f;
    for (int i = tid; i < n; i += NT) {
      float x[D], g[D];
#pragma unroll
      for (int k = 0; k < D; ++k) {
        x[k] = Up(i, k);
        g[k] = 0.0f;
      }
      // one cell of the row: column j rated r, its residual kept at pos
      auto cell = [&](int j, float r, int pos) {
        float v[D];
        float pred = 0.0f;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          v[k] = Vp(j, k);
          pred = fmaf(x[k], v[k], pred);
        }
        const float err = r - pred;
        sq = fmaf(err, err, sq);
        if (kShared) E[pos] = err;
        else st_state(E + pos, err);
        const float rs = rnd<T>(err * inv_sig);
#pragma unroll
        for (int k = 0; k < D; ++k) g[k] = fmaf(rs, v[k], g[k]);
      };
      const int end = ld_index(a.row_ptr + i + 1);
      for (int e = ld_index(a.row_ptr + i); e < end; ++e)
        cell(ld_index(a.col_idx + e),
             e == own_e ? dv : to_f(ld_index(r_row + e)), e);
      // after the rated cells: the lane's cell, where it is not rated
      if (i == di && own_e < 0) cell(dj, dv, nnz);
      // the prior term takes the float proposal: x itself in float, formed
      // again from the state where x is its bf16 rounding
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const float t = kExact ? x[k] : proposed(xu, gu, k * n + i, lr);
        st_state(ogu + k * n + i, from_f<T>(g[k] - t / sig_u));
      }
    }
    s[0] = sq;
    // butterfly: a + b == b + a, so every thread of a warp ends with the
    // same totals; then the warps in order, by every thread
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int q = 0; q < 3; ++q) s[q] += __shfl_xor_sync(0xffffffffu, s[q], off);
    }
    if ((tid & 31) == 0) {
#pragma unroll
      for (int q = 0; q < 3; ++q) red[q * NW + (tid >> 5)] = s[q];
    }
    __syncthreads();  // e, the proposal and the partial sums are visible
    float t[3] = {0.0f, 0.0f, 0.0f};
    for (int w = 0; w < NW; ++w) {
#pragma unroll
      for (int q = 0; q < 3; ++q) t[q] += red[q * NW + w];
    }
    return t[0] / (2.0f * a.sig[0]) + t[1] / (2.0f * sig_u) +
           t[2] / (2.0f * sig_v);
  }

  // Gv at the proposal that `value` just took, from its e, to ogv.
  __device__ void grad_v(const T* xv, const T* gv, float lr, const T* ou,
                         const T* ov, T* ogv) const {
    const Factor<T, kShared> Up{s_u, ou, n}, Vp{s_v, ov, m};
    for (int j = tid; j < m; j += NT) {
      float g[D];
#pragma unroll
      for (int k = 0; k < D; ++k) g[k] = 0.0f;
      auto cell = [&](int i, int pos) {
        const float err = kShared ? E[pos] : ld_state(E + pos);
        const float rs = rnd<T>(err * inv_sig);
#pragma unroll
        for (int k = 0; k < D; ++k) g[k] = fmaf(rs, Up(i, k), g[k]);
      };
      const int end = ld_index(a.col_ptr + j + 1);
      for (int e = ld_index(a.col_ptr + j); e < end; ++e)
        cell(ld_index(a.row_idx + e), ld_index(a.csc_pos + e));
      if (j == dj && own_e < 0) cell(di, nnz);
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const float t = kExact ? Vp(j, k) : proposed(xv, gv, k * m + j, lr);
        st_state(ogv + k * m + j, from_f<T>(g[k] - t / sig_v));
      }
    }
  }

  __device__ void run() const {
    const float stop = a.ls[1], min_lr = a.ls[2];
    const T* u0 = (const T*)a.u0;
    const T* v0 = (const T*)a.v0;
    // init: evaluate at the base factors, into set 0
    float f = value(u0, nullptr, v0, nullptr, 0.0f, U(0), V(0), GU(0));
    grad_v(v0, nullptr, 0.0f, U(0), V(0), GV(0));
    __syncthreads();
    float lr = a.ls[0];
    int cur = 0, evals = 1, accepts = 0;
    bool done = false;
    // f is the same in every thread, so all take the same branches
    for (int step = 0; step < a.max_steps && !done; ++step) {
      const int nxt = cur ^ 1;
      const float fp = value(U(cur), GU(cur), V(cur), GV(cur), lr, U(nxt),
                             V(nxt), GU(nxt));
      ++evals;
      const bool accept = isfinite(fp) && fp < f;
      done = accept ? (f - fp) < stop : lr * 0.5f < min_lr;
      if (accept) {
        grad_v(V(cur), GV(cur), lr, U(nxt), V(nxt), GV(nxt));
        f = fp;
        lr *= 1.25f;
        cur = nxt;
        ++accepts;
      } else {
        lr *= 0.5f;
      }
      __syncthreads();  // the next proposal overwrites what the passes gather
    }
    if (cur == 1) {  // the output is set 0
      const T* us = U(1);
      const T* vs = V(1);
      T* ud = U(0);
      T* vd = V(0);
      for (int x = tid; x < n * D; x += NT) st_state(ud + x, ld_state(us + x));
      for (int x = tid; x < m * D; x += NT) st_state(vd + x, ld_state(vs + x));
    }
    if (tid == 0) {
      a.f[l] = f;
      a.counts[2 * l] = evals;
      a.counts[2 * l + 1] = accepts;
    }
  }
};

template <typename T, bool kShared>
__global__ void __launch_bounds__(NT) fused(Args a) {
  extern __shared__ float smem[];
  Search<T, kShared>(a, smem).run();
}

template <typename T, bool kShared>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int64_t bytes = 4 * smem_floats(a.n, a.m, a.nnz, kShared);
  if (bytes > kSmemLimit) return cudaErrorInvalidValue;
  auto kernel = fused<T, kShared>;
  static bool configured = false;  // once per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  kernel<<<(unsigned)a.L, NT, (size_t)bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_variant(const Args& a, bool shared, cudaStream_t s) {
  return shared ? launch<T, true>(a, s) : launch<T, false>(a, s);
}

}  // namespace

// Bytes of shared memory a block of the shared-memory variant needs; the
// caller takes that variant when they are at most
// amf_pmf_lookahead_fused_smem_limit().
extern "C" long long amf_pmf_lookahead_fused_smem_bytes(
    long long n, long long m, long long nnz) {
  return 4 * smem_floats(n, m, nnz, true);
}

extern "C" long long amf_pmf_lookahead_fused_smem_limit() { return kSmemLimit; }

// in_bf16: 0 when the state, the base factors and r_row are float, 1 when
// bf16. shared: 1 keeps the proposal and e in shared memory (they must fit),
// 0 gathers from the spare set in global memory and takes e_scratch
// (L, nnz + 1). d must be the width the library was built for.
extern "C" int amf_pmf_lookahead_fused(
    int in_bf16, int shared, const void* u0, const void* v0,
    const int32_t* row_ptr, const int32_t* col_idx, const void* r_row,
    const int32_t* col_ptr, const int32_t* row_idx, const int32_t* csc_pos,
    const int32_t* di, const int32_t* dj, const float* dv, const float* sig,
    const float* ls, void* u, void* v, void* gu, void* gv, float* e_scratch,
    float* f, int32_t* counts, long long L, long long n, long long m,
    long long nnz, int d, int max_steps, void* stream) {
  if (d != D || L < 1 || L > 0x7fffffffLL / 4 || n < 1 || m < 1 || nnz < 0 ||
      n > 0x7fffffffLL / 33 || m > 0x7fffffffLL / 33 ||
      nnz >= 0x7fffffffLL || max_steps < 0 ||
      (!shared && e_scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{u0, v0, row_ptr, col_idx, r_row, col_ptr, row_idx, csc_pos,
         di, dj, dv, sig, ls, u, v, gu, gv, e_scratch, f, counts,
         (int64_t)L, (int64_t)n, (int64_t)m, (int64_t)nnz, max_steps};
  cudaStream_t s = (cudaStream_t)stream;
  if (in_bf16) return (int)by_variant<__nv_bfloat16>(a, shared != 0, s);
  return (int)by_variant<float>(a, shared != 0, s);
}
