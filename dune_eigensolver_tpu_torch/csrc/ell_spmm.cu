// General-sparsity (ELL) SpMM in the transposed layout, for Hopper (sm_90a).
//
// Replaces dune_eigensolver_tpu/kernels/gather_spmm.py:792 _seg_kernel
// (launched by windowed_spmm_t, gather_spmm.py:898). It computes what that
// kernel computes, not its machinery:
//
//     Y[r, i] = sum_j data[i, j] * X[r, cols[i, j]]
//
// with X (m, ncols) and Y (m, n) contiguous row-major, f32 storage and f32
// accumulation, or f64 storage and f64 accumulation (the card's f64 solves
// and the f64 Rayleigh-Ritz refinement; the TPU had no f64). The TPU
// kernel's segments, 128-lane windows, COO tail and
// right-padded layout exist because tpu.dynamic_gather reads one 128-lane
// vreg; a CUDA thread gathers from device memory through L1/L2 directly,
// so the ELL container feeds the kernel as it is. Padding slots hold an
// in-bounds column and a zero coefficient, so no load is masked.
//
// What bounds it: not bytes. Each stored entry is a 4-byte coefficient and
// a 4-byte index serving 2 flops per row of X, and each of those flops
// gathers an X value from an irregular column: one 4-byte L1 request per
// multiply-add. The first version held at most one row of X and a
// chunk of 8-32 gathers in flight, loaded its chunk under a per-slot
// predicate with 92 registers at k = 18, and took 45% of its copy bound
// on the 2^20 graph, 30% on elasticity_2d(512) as scalar ELL (E4: without
// the irregular addresses it took a third of the time). And it paid for
// padding: the RCM-ordered 2^20 graph has 7,340,032 slots for 3,250,580
// entries (44% real; k = 7 is set by seven rows), and every padded slot
// streamed a coefficient and an index and gathered X like a real one.
//
// What the design does about that:
// - The slot loop of a warp stops at that warp's last stored entry: one
//   count per 32 consecutive rows (ELLMatrix.warp_slots, made once per
//   container), uniform across the warp, so no thread diverges. On the
//   graph the counts average 4.00 against k = 7. Slots after a warp's
//   count are padding (zero coefficient, the row's own column), whose
//   products are zero on finite X: skipping them changes no bit. (Alone
//   this is worth 10-18% on the graph: the first version was held less by
//   the padding's bytes than by how few gathers it had in flight.)
// - No predicated slot: up to ELL_KC (coefficient, column) pairs sit in
//   registers, with the exact count a template constant (recursive tail).
//   A warp of at most ELL_KC slots loads its pairs once and keeps them
//   over all rows of X; a longer one (elasticity's 18) sweeps chunks of
//   ELL_KC and an exact remainder for each group of rows of X, reloading
//   the pairs (the block's lie in L1) and keeping the sums in registers,
//   so that Y is written once, not read back and written per chunk.
// - ELL_ROWS rows of X are unrolled, so a thread has ELL_ROWS x chunk
//   independent gathers in flight, and the registers are capped so that
//   ELL_MIN_BLOCKS blocks share an SM: latency is hidden by more warps as
//   much as by more loads a warp (at these caps ptxas keeps a few words in
//   local memory, which L1 holds; every higher cap and fewer rows measured
//   slower, PERF.md section 6).
// - Where every column lies within int16 of its row (a mesh-ordered
//   operator: elasticity_2d's span is about +-1,024), the index stream is
//   int16 offsets col - i (formats.py::ell_column_offsets), half the bytes
//   of int32 columns. The container holds one index stream, whichever its
//   columns allow (ELLMatrix.kernel_streams): a choice, not a fallback.
// The coefficients arrive as (k, n) streams (ELLMatrix.kernel_streams), so
// one thread per row i loads its pairs coalesced across the warp, once,
// and reuses them for every row of X; Y's stores are coalesced. The
// gathers of neighbouring rows land near each other for a banded (RCM- or
// mesh-ordered) operator and are left to L1/L2. When n is small the m rows
// are split over blockIdx.y so that the card still gets enough threads.
// Slots in stored order, one chain of fused multiply-adds per output from
// +0: the first version's bits on finite X.
// f64 is the same body with the value type a template parameter (EllCfg):
// ELL_ROWS_F64 rows of X in flight, since each gathered value and each sum
// takes two registers, and its own register cap; the index stream is the
// same.
// Registers (ptxas, sm_90a): see PERF.md section 6; the build log prints
// them.
//
// Interface: plain C, loaded with ctypes. The launch goes on the caller's
// stream and the function returns cudaGetLastError() so the wrapper can
// raise on a refused launch.

#include <cuda_runtime.h>

#define ELL_THREADS 128
#define ELL_MIN_BLOCKS 6      // blocks an SM holds, int32 columns: 80 registers
#define ELL_MIN_BLOCKS_I16 5  // the same, int16 offsets: 96 registers
#define ELL_ROWS 8    // rows of X a thread has in flight
#define ELL_ROWS_F64 4        // the same in f64
#define ELL_MIN_BLOCKS_F64 3  // blocks an SM holds in f64: 168 registers
#define ELL_KC 9      // (coefficient, column) pairs in registers at a time
#define ELL_WARP 32   // rows that share a slot count (formats.py WARP_ROWS)
#define ELL_TARGET_THREADS (528 * 256)  // half of what 132 SMs can hold

// rows of X in flight and blocks an SM is held to, by value and index type
template <typename T, typename IDX> struct EllCfg {
  static constexpr int ROWS = ELL_ROWS;
  static constexpr int MIN_BLOCKS = sizeof(IDX) == 2 ? ELL_MIN_BLOCKS_I16 : ELL_MIN_BLOCKS;
};
template <typename IDX> struct EllCfg<double, IDX> {
  static constexpr int ROWS = ELL_ROWS_F64;
  static constexpr int MIN_BLOCKS = ELL_MIN_BLOCKS_F64;
};

__device__ __forceinline__ float fma_acc(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_acc(double a, double b, double c) { return fma(a, b, c); }

// slots j0 .. j0 + KC - 1 of row i into registers; IDX is int (columns) or
// short (offsets col - i)
template <int KC, typename T, typename IDX>
__device__ __forceinline__ void ell_load(const T* __restrict__ data_t,
                                         const IDX* __restrict__ cols_t, size_t n, size_t i,
                                         int j0, T (&v)[KC], int (&c)[KC]) {
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    v[j] = __ldg(data_t + (size_t)(j0 + j) * n + i);
    const int s = __ldg(cols_t + (size_t)(j0 + j) * n + i);
    c[j] = sizeof(IDX) == 2 ? (int)i + s : s;
  }
}

// RR rows of X from row r on: KC pairs times their X values, onto acc
template <int KC, int RR, typename T>
__device__ __forceinline__ void ell_fma(const T* __restrict__ x, size_t ncols, int r,
                                        const T (&v)[KC], const int (&c)[KC],
                                        T (&acc)[RR]) {
  T xv[RR][KC];
#pragma unroll
  for (int q = 0; q < RR; ++q) {
    const T* xr = x + (size_t)(r + q) * ncols;
#pragma unroll
    for (int j = 0; j < KC; ++j) xv[q][j] = __ldg(xr + c[j]);
  }
#pragma unroll
  for (int q = 0; q < RR; ++q) {
#pragma unroll
    for (int j = 0; j < KC; ++j) acc[q] = fma_acc(v[j], xv[q][j], acc[q]);
  }
}

template <int RR, typename T>
__device__ __forceinline__ void ell_store(T* __restrict__ y, size_t n, int r, size_t i,
                                          const T (&acc)[RR]) {
#pragma unroll
  for (int q = 0; q < RR; ++q) y[(size_t)(r + q) * n + i] = acc[q];
}

// A warp whose rows hold at most ELL_KC slots: exactly KC pairs, loaded
// once, kept in registers over the rows r0 .. r1 - 1 of X.
template <int KC, typename T, typename IDX>
__device__ __forceinline__ void ell_short(const T* __restrict__ data_t,
                                          const IDX* __restrict__ cols_t,
                                          const T* __restrict__ x, T* __restrict__ y,
                                          size_t n, size_t ncols, size_t i, int r0, int r1) {
  constexpr int ROWS = EllCfg<T, IDX>::ROWS;
  T v[KC];
  int c[KC];
  ell_load<KC>(data_t, cols_t, n, i, 0, v, c);
  int r = r0;
  for (; r + ROWS <= r1; r += ROWS) {
    T acc[ROWS] = {};
    ell_fma<KC, ROWS>(x, ncols, r, v, c, acc);
    ell_store<ROWS>(y, n, r, i, acc);
  }
  for (; r < r1; ++r) {
    T acc[1] = {};
    ell_fma<KC, 1>(x, ncols, r, v, c, acc);
    ell_store<1>(y, n, r, i, acc);
  }
}

// exactly ``kw`` slots, 1 <= kw <= K
template <int K, typename T, typename IDX>
__device__ __forceinline__ void ell_short_tail(int kw, const T* __restrict__ data_t,
                                               const IDX* __restrict__ cols_t,
                                               const T* __restrict__ x,
                                               T* __restrict__ y, size_t n, size_t ncols,
                                               size_t i, int r0, int r1) {
  if constexpr (K > 0) {
    if (kw == K) {
      ell_short<K>(data_t, cols_t, x, y, n, ncols, i, r0, r1);
    } else {
      ell_short_tail<K - 1>(kw, data_t, cols_t, x, y, n, ncols, i, r0, r1);
    }
  }
}

// the last ``rem`` slots from j0 on, 0 <= rem <= K, onto acc
template <int K, int RR, typename T, typename IDX>
__device__ __forceinline__ void ell_long_tail(int rem, const T* __restrict__ data_t,
                                              const IDX* __restrict__ cols_t,
                                              const T* __restrict__ x, size_t n,
                                              size_t ncols, size_t i, int j0, int r,
                                              T (&acc)[RR]) {
  if constexpr (K > 0) {
    if (rem == K) {
      T v[K];
      int c[K];
      ell_load<K>(data_t, cols_t, n, i, j0, v, c);
      ell_fma<K, RR>(x, ncols, r, v, c, acc);
    } else {
      ell_long_tail<K - 1, RR>(rem, data_t, cols_t, x, n, ncols, i, j0, r, acc);
    }
  }
}

// A warp whose rows hold more than ELL_KC slots, RR rows of X from row r
// on: chunks of ELL_KC pairs and an exact remainder, each loaded again for
// every group of rows (the block's pairs stay in L1), the sums kept in
// registers, so Y is written once.
template <int RR, typename T, typename IDX>
__device__ __forceinline__ void ell_long(int kw, const T* __restrict__ data_t,
                                         const IDX* __restrict__ cols_t,
                                         const T* __restrict__ x, T* __restrict__ y,
                                         size_t n, size_t ncols, size_t i, int r) {
  T acc[RR] = {};
  int j0 = 0;
  for (; j0 + ELL_KC <= kw; j0 += ELL_KC) {
    T v[ELL_KC];
    int c[ELL_KC];
    ell_load<ELL_KC>(data_t, cols_t, n, i, j0, v, c);
    ell_fma<ELL_KC, RR>(x, ncols, r, v, c, acc);
  }
  ell_long_tail<ELL_KC - 1, RR>(kw - j0, data_t, cols_t, x, n, ncols, i, j0, r, acc);
  ell_store<RR>(y, n, r, i, acc);
}

// One thread per row i; its warp's rows run warp_slots[i / ELL_WARP] slots.
template <typename T, typename IDX>
__global__ void __launch_bounds__(ELL_THREADS, EllCfg<T, IDX>::MIN_BLOCKS)
ell_spmm_t_kernel(const T* __restrict__ data_t, const IDX* __restrict__ cols_t,
                  const int* __restrict__ warp_slots, const T* __restrict__ x,
                  T* __restrict__ y, int n, int ncols, int m, int rows_per_block) {
  constexpr int ROWS = EllCfg<T, IDX>::ROWS;
  const int i = blockIdx.x * ELL_THREADS + threadIdx.x;
  if (i >= n) return;
  const int r0 = blockIdx.y * rows_per_block;
  const int r1 = min(m, r0 + rows_per_block);
  const int kw = __ldg(warp_slots + i / ELL_WARP);
  if (kw == 0) {  // the warp's rows store nothing but padding: Y = 0
    for (int r = r0; r < r1; ++r) y[(size_t)r * n + i] = T(0);
  } else if (kw <= ELL_KC) {
    ell_short_tail<ELL_KC>(kw, data_t, cols_t, x, y, (size_t)n, (size_t)ncols, (size_t)i, r0,
                           r1);
  } else {
    int r = r0;
    for (; r + ROWS <= r1; r += ROWS)
      ell_long<ROWS>(kw, data_t, cols_t, x, y, (size_t)n, (size_t)ncols, (size_t)i, r);
    for (; r < r1; ++r)
      ell_long<1>(kw, data_t, cols_t, x, y, (size_t)n, (size_t)ncols, (size_t)i, r);
  }
}

template <typename T>
static void launch(dim3 grid, cudaStream_t s, const void* data_t, const void* cols_t,
                   int index_bytes, const int* slots, const void* x, void* y, int n, int ncols,
                   int m, int rows_per_block) {
  if (index_bytes == 2) {
    ell_spmm_t_kernel<T, short><<<grid, ELL_THREADS, 0, s>>>(
        (const T*)data_t, (const short*)cols_t, slots, (const T*)x, (T*)y, n, ncols, m,
        rows_per_block);
  } else {
    ell_spmm_t_kernel<T, int><<<grid, ELL_THREADS, 0, s>>>(
        (const T*)data_t, (const int*)cols_t, slots, (const T*)x, (T*)y, n, ncols, m,
        rows_per_block);
  }
}

extern "C" {

// value_bytes: 4 (float32 coefficients, X and Y) or 8 (float64); cols_t:
// (k, n) int32 columns (index_bytes 4) or int16 offsets col - i (index_bytes
// 2); warp_slots: ceil(n / 32) int32 counts, each at most k. Returns a
// cudaError_t as int.
int ell_spmm_t_launch(int value_bytes, const void* data_t, const void* cols_t,
                      int index_bytes, const void* warp_slots, long long n, int k,
                      long long ncols, const void* x, void* y, int m, void* stream) {
  if (n < 0 || n > 0x7fffffffLL || ncols < 1 || ncols > 0x7fffffffLL || k < 0 || m < 1 ||
      (index_bytes != 2 && index_bytes != 4) || (value_bytes != 4 && value_bytes != 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 0) return (int)cudaGetLastError();
  if (k == 0) {  // no stored entries: Y = 0
    cudaMemsetAsync(y, 0, (size_t)m * (size_t)n * value_bytes, s);
    return (int)cudaGetLastError();
  }
  const unsigned gx = (unsigned)((n + ELL_THREADS - 1) / ELL_THREADS);
  const unsigned target = ELL_TARGET_THREADS / ELL_THREADS;
  int split = (int)((target + gx - 1) / gx);
  split = split < 1 ? 1 : (split > m ? m : split);
  const int rows_per_block = (m + split - 1) / split;
  const dim3 grid(gx, (unsigned)((m + rows_per_block - 1) / rows_per_block));
  const int* slots = (const int*)warp_slots;
  if (value_bytes == 4) {
    launch<float>(grid, s, data_t, cols_t, index_bytes, slots, x, y, (int)n, (int)ncols, m,
                  rows_per_block);
  } else {
    launch<double>(grid, s, data_t, cols_t, index_bytes, slots, x, y, (int)n, (int)ncols, m,
                   rows_per_block);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
