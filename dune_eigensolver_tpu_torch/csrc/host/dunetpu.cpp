// Copy of native/dunetpu.cpp, the JAX package's host-setup helper, kept
// unchanged below this header so that the port never reads the JAX
// package's tree. The port compiles it with g++ at first use
// (dune_eigensolver_tpu_torch/utils/native.py::build_host) and calls it
// from factorize/host_lu.py and factorize/banded.py.

// libdunetpu — native host-side setup kernels for dune_eigensolver_tpu.
//
// The reference implements its entire runtime in C++ (header templates,
// dune/eigensolver/*.hh); in the TPU framework the device compute path is
// JAX/XLA/Pallas, and the O(nnz) *host-side* setup loops live here:
//
//  * dependency-level computation for the level-scheduled multi-RHS
//    triangular solve (the TPU replacement for the row-sequential loop of
//    matmul_inverse_tallskinny_blocked, kernels_cpp.hh:660-755);
//  * chunk-schedule packing: grouping rows into fixed-size, level-respecting
//    chunks and packing their CSR entries into dense (nchunk, C, kmax)
//    gather tables consumed by the device trisolve;
//  * CSR -> ELL packing for the general-matrix SpMM path.
//
// Exposed as a plain C ABI consumed via ctypes (utils/native.py); pure-numpy
// fallbacks exist for every entry point, so the library is an optional fast
// path. Build: `make -C native` (g++ -O3 -march=native -shared -fPIC).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

// Phase 2 impl: pack rows/cols/vals gather tables.
//   rows: (nchunk, C) int32, padded with n
//   cols: (nchunk, C, kmax) int32, padded with n
//   vals: (nchunk, C, kmax) T, padded with 0
// Caller allocates (numpy) and pre-fills pads; we only write real entries.
template <typename T>
static void pack_chunks_impl(int64_t n, int64_t chunk_cap, int64_t kmax,
                             int64_t nchunk, const int64_t* indptr,
                             const int64_t* indices, const T* data,
                             const int32_t* order, const int64_t* boundaries,
                             int32_t* rows, int32_t* cols, T* vals) {
  for (int64_t c = 0; c < nchunk; ++c) {
    const int64_t lo = boundaries[c], hi = boundaries[c + 1];
    int32_t* rc = rows + c * chunk_cap;
    for (int64_t k = 0; k < hi - lo; ++k) {
      const int32_t r = order[lo + k];
      rc[k] = r;
      const int64_t s = indptr[r], e = indptr[r + 1];
      int32_t* cc = cols + (c * chunk_cap + k) * kmax;
      T* vv = vals + (c * chunk_cap + k) * kmax;
      for (int64_t p = s; p < e; ++p) {
        cc[p - s] = static_cast<int32_t>(indices[p]);
        vv[p - s] = data[p];
      }
    }
  }
  (void)n;
}

// CSR -> ELL impl (row-padded to width kmax): cols padded with `pad_col`,
// vals with 0.
template <typename T>
static void csr_to_ell_impl(int64_t n, int64_t kmax, int64_t pad_col,
                            const int64_t* indptr, const int64_t* indices,
                            const T* data, int32_t* cols, T* vals) {
  for (int64_t i = 0; i < n; ++i) {
    const int64_t s = indptr[i], e = indptr[i + 1];
    int32_t* cc = cols + i * kmax;
    T* vv = vals + i * kmax;
    int64_t k = 0;
    for (int64_t p = s; p < e; ++p, ++k) {
      cc[k] = static_cast<int32_t>(indices[p]);
      vv[k] = data[p];
    }
    for (; k < kmax; ++k) {
      cc[k] = static_cast<int32_t>(pad_col);
      vv[k] = T(0);
    }
  }
}

extern "C" {

// lev[i] = 0 if row i has no off-diagonal deps, else 1 + max(lev[deps]).
// indptr/indices describe the STRICT triangular part in CSR; for a lower
// triangular matrix every dependency j < i, so one forward sweep suffices.
void levels_from_csr(int64_t n, const int64_t* indptr, const int64_t* indices,
                     int32_t* lev) {
  for (int64_t i = 0; i < n; ++i) {
    int32_t m = -1;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      const int32_t lj = lev[indices[p]];
      m = lj > m ? lj : m;
    }
    lev[i] = m + 1;
  }
}

// Full chunk schedule, phase 1: compute levels, a stable level-sort order,
// and chunk boundaries (never splitting a level, at most `chunk` rows per
// chunk). Returns nchunk. boundaries must hold n+1 entries; order n.
int64_t chunk_schedule(int64_t n, int64_t chunk, const int64_t* indptr,
                       const int64_t* indices, int32_t* lev, int32_t* order,
                       int64_t* boundaries) {
  levels_from_csr(n, indptr, indices, lev);
  // counting sort by level == stable argsort (levels are small ints).
  int32_t nlev = 0;
  for (int64_t i = 0; i < n; ++i) nlev = std::max(nlev, lev[i]);
  ++nlev;
  std::vector<int64_t> count(static_cast<size_t>(nlev) + 1, 0);
  for (int64_t i = 0; i < n; ++i) ++count[lev[i] + 1];
  std::partial_sum(count.begin(), count.end(), count.begin());
  std::vector<int64_t> pos(count.begin(), count.end() - 1);
  for (int64_t i = 0; i < n; ++i) order[pos[lev[i]]++] = static_cast<int32_t>(i);

  int64_t nchunk = 0;
  boundaries[0] = 0;
  int64_t start = 0;
  for (int64_t i = 1; i <= n; ++i) {
    if (i == n || lev[order[i]] != lev[order[start]] || i - start == chunk) {
      boundaries[++nchunk] = i;
      start = i;
    }
  }
  return nchunk;
}

// Phase 2: pack rows/cols/vals gather tables (see pack_chunks_impl above).
void pack_chunks_f32(int64_t n, int64_t chunk_cap, int64_t kmax,
                     int64_t nchunk, const int64_t* indptr,
                     const int64_t* indices, const float* data,
                     const int32_t* order, const int64_t* boundaries,
                     int32_t* rows, int32_t* cols, float* vals) {
  pack_chunks_impl<float>(n, chunk_cap, kmax, nchunk, indptr, indices, data,
                          order, boundaries, rows, cols, vals);
}

void pack_chunks_f64(int64_t n, int64_t chunk_cap, int64_t kmax,
                     int64_t nchunk, const int64_t* indptr,
                     const int64_t* indices, const double* data,
                     const int32_t* order, const int64_t* boundaries,
                     int32_t* rows, int32_t* cols, double* vals) {
  pack_chunks_impl<double>(n, chunk_cap, kmax, nchunk, indptr, indices, data,
                           order, boundaries, rows, cols, vals);
}

// CSR -> ELL packing, used by the general-matrix SpMM container build.
void csr_to_ell_f32(int64_t n, int64_t kmax, int64_t pad_col,
                    const int64_t* indptr, const int64_t* indices,
                    const float* data, int32_t* cols, float* vals) {
  csr_to_ell_impl<float>(n, kmax, pad_col, indptr, indices, data, cols, vals);
}

void csr_to_ell_f64(int64_t n, int64_t kmax, int64_t pad_col,
                    const int64_t* indptr, const int64_t* indices,
                    const double* data, int32_t* cols, double* vals) {
  csr_to_ell_impl<double>(n, kmax, pad_col, indptr, indices, data, cols, vals);
}

// No-pivot banded LU, in place on the column-band array
//   work[bw + r, i] = A[i + r, i], r in [-bw, bw]   (row-major (2bw+1, n))
// On return the strictly-lower part holds L (unit diag implied) and the
// upper part holds U. Returns the index of the first zero pivot, or -1.
// This is the host-setup factorization behind the TPU block-banded
// partitioned-inverse trisolve (factorize/banded.py); the reference's
// analogous native setup is the UMFPACK call in umfpacktools.hh:100-111.
int64_t lu_banded_f64(int64_t n, int64_t bw, double* work) {
  const int64_t ld = n;  // row stride
  for (int64_t i = 0; i < n; ++i) {
    const double piv = work[bw * ld + i];
    if (piv == 0.0) return i;
    const int64_t r = std::min(bw, n - 1 - i);
    if (r == 0) continue;
    const double pinv = 1.0 / piv;
    for (int64_t a = 1; a <= r; ++a) work[(bw + a) * ld + i] *= pinv;
    // trailing update: A[i+a, i+b] -= L[i+a, i] * U[i, i+b]
    // A[i+a, i+b] lives at work[bw + a - b, i + b]
    for (int64_t b = 1; b <= r; ++b) {
      const double u = work[(bw - b) * ld + i + b];
      if (u == 0.0) continue;
      double* colb = work + (bw - b) * ld + i + b;  // row index offset base
      // entries a = 1..r: work[(bw + a - b)*ld + i + b]
      const double* lcol = work + bw * ld + i;  // L[i+a, i] at (bw+a)*ld + i
      for (int64_t a = 1; a <= r; ++a) {
        colb[a * ld] -= lcol[a * ld] * u;
      }
    }
  }
  return -1;
}

}  // extern "C"
