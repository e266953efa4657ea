// Host-side native kernels for amf_tpu_torch (a copy of the JAX package's
// amf_tpu/_native/kernels.cc, kept here because the port never imports
// that package).
//
// C++ equivalents of the reference's native data-path components: the
// MATLAB MEX sparse kernels ratingconcentration/spouterprod.c:47-120,
// sprowsumprod.c:6-60 and sprowcolsum.c, plus a COO<->dense packer serving
// the data-loader role. The port's maxent model computes these sums with
// tensor ops (models/ratingconc.py); this library is a host fast path over
// numpy and a cross-implementation oracle for the tests.
//
// Build: g++ -O3 -shared -fPIC kernels.cc -o libamfnative.so (done at first
// use by __init__.py)
// ABI: plain C, row-major contiguous double buffers (ctypes-friendly).

#include <cstdint>
#include <cstring>

extern "C" {

// out[e] = u[i[e]] * v[j[e]] for each masked entry e, clamped at `clamp`
// (reference: spouterprod.c computes mask .* (u v^T) over nnz only, with a
// 1e128 overflow clamp at :114-115).
void amf_spouterprod(const int64_t nnz,
                     const int64_t* i_idx,
                     const int64_t* j_idx,
                     const double* u,
                     const double* v,
                     const double clamp,
                     double* out) {
  for (int64_t e = 0; e < nnz; ++e) {
    double val = u[i_idx[e]] * v[j_idx[e]];
    if (val > clamp) val = clamp;
    out[e] = val;
  }
}

// Fused row/col sums of (p @ F) over the mask (the maxent dual's gradient
// inner loop; reference: sprowsumprod.c:6-60):
//   rowsum[i[e], :] += sum_s p[e, s] * F[s, :]
//   colsum[j[e], :] += sum_s p[e, s] * F[s, :]
// p: (nnz, S) row-major; F: (S, K) row-major; rowsum: (n, K); colsum: (m, K).
void amf_sprowsumprod(const int64_t nnz,
                      const int64_t S,
                      const int64_t K,
                      const int64_t* i_idx,
                      const int64_t* j_idx,
                      const double* p,
                      const double* F,
                      double* rowsum,
                      double* colsum) {
  // small scratch for the per-entry feature expectation
  double* ef = new double[K];
  for (int64_t e = 0; e < nnz; ++e) {
    std::memset(ef, 0, sizeof(double) * K);
    const double* pe = p + e * S;
    for (int64_t s = 0; s < S; ++s) {
      const double ps = pe[s];
      if (ps == 0.0) continue;
      const double* fs = F + s * K;
      for (int64_t k = 0; k < K; ++k) ef[k] += ps * fs[k];
    }
    double* rs = rowsum + i_idx[e] * K;
    double* cs = colsum + j_idx[e] * K;
    for (int64_t k = 0; k < K; ++k) {
      rs[k] += ef[k];
      cs[k] += ef[k];
    }
  }
  delete[] ef;
}

// Row/col sums of per-entry expectation vectors (reference: sprowcolsum.c):
//   rowsum[i[e], :] += E[e, :];  colsum[j[e], :] += E[e, :]
void amf_sprowcolsum(const int64_t nnz,
                     const int64_t K,
                     const int64_t* i_idx,
                     const int64_t* j_idx,
                     const double* E,
                     double* rowsum,
                     double* colsum) {
  for (int64_t e = 0; e < nnz; ++e) {
    const double* ee = E + e * K;
    double* rs = rowsum + i_idx[e] * K;
    double* cs = colsum + j_idx[e] * K;
    for (int64_t k = 0; k < K; ++k) {
      rs[k] += ee[k];
      cs[k] += ee[k];
    }
  }
}

// COO -> dense packer (the data-loader role): fills value and mask buffers
// for the framework's dense masked Problem representation. Returns the
// number of duplicate (i, j) pairs encountered (last write wins).
int64_t amf_coo_to_dense(const int64_t nnz,
                         const int64_t n,
                         const int64_t m,
                         const double* ratings,  // (nnz, 3) [i, j, value]
                         double* values,         // (n, m) zero-initialized
                         uint8_t* mask) {        // (n, m) zero-initialized
  int64_t dups = 0;
  for (int64_t e = 0; e < nnz; ++e) {
    const int64_t i = static_cast<int64_t>(ratings[e * 3 + 0]);
    const int64_t j = static_cast<int64_t>(ratings[e * 3 + 1]);
    if (i < 0 || i >= n || j < 0 || j >= m) continue;
    const int64_t off = i * m + j;
    if (mask[off]) ++dups;
    values[off] = ratings[e * 3 + 2];
    mask[off] = 1;
  }
  return dups;
}

// Dense masked RMSE between prediction and target over a mask — the hot
// metric of the results pipeline, for host-side batch analysis.
double amf_masked_rmse(const int64_t size,
                       const double* pred,
                       const double* target,
                       const uint8_t* mask) {
  double acc = 0.0;
  int64_t cnt = 0;
  for (int64_t e = 0; e < size; ++e) {
    if (!mask[e]) continue;
    const double d = pred[e] - target[e];
    acc += d * d;
    ++cnt;
  }
  if (cnt == 0) return 0.0;
  return __builtin_sqrt(acc / cnt);
}

}  // extern "C"
