// The body of the ELL SpMM (K2, csrc/ell_spmm.cu), shared with its
// ablation (csrc/ell_ablate.cu), for Hopper (sm_90a).
//
// One thread per row i; its warp's rows run warp_slots[i / ELL_WARP]
// slots. The body is a template over
//
//   V           the variant: ELL_FULL is K2's function; the ablation's
//               three degraded variants each remove one mechanism (below)
//   ROWS        rows of X a thread has in flight
//   KC          (coefficient, column) pairs held in registers at a time
//   MIN_BLOCKS  blocks an SM is held to (the register cap)
//   T, IDX      value type (float, double) and index stream (int32
//               columns, int16 offsets col - i)
//
// K2 instantiates ELL_FULL at ELL_ROWS, ELL_KC and its caps; the ablation
// instantiates the degraded variants at those constants and ELL_FULL at
// other (ROWS, KC), so it times the body K2 ships and cannot drift from it.
// Every (ROWS, KC) sums a row's slots in stored order, one fused
// multiply-add chain per output from +0: the same bits.
//
//   ELL_FULL      Y[r,i] = sum_j data[i,j] * X[r, cols[i,j]]
//   ELL_NOGATHER  Y[r,i] = sum_j data[i,j] * X[r, i']     i' = min(i, ncols-1)
//                 no irregular address, and nothing else taken away: every
//                 slot's coefficient and index are loaded as K2 loads them,
//                 and each term loads X at i' + (index & zero), zero = 0 a
//                 kernel argument (the low word of ``never``). So the X
//                 loads keep K2's count (one a term) and its dependence on
//                 the index load, and ptxas can neither drop the index load
//                 nor merge the X loads: only the addresses are regular
//   ELL_NODYN     Y[r,i] = sum_j data[i,j] * X[r, (i' + j) mod ncols]
//                 no index stream: the column is computed (needs k <= ncols)
//   ELL_NOFMA     Y[r,i] = X[r, i'] + data[i,0]
//                 no inner loop: the warp's slots are loaded once, the
//                 coefficients after data[i,0] and every index XOR-folded
//                 into one 32-bit register that is stored only if it equals
//                 ``never`` = 2^32, which no fold can; X read and Y written
//                 once
//
// ``never`` is a kernel argument that ell_body_launch sets to ELL_NEVER,
// so ptxas cannot prove the fold unused or the mask zero: each kept load
// has a reader. (A load whose value nothing reads is removed by ptxas,
// ``asm volatile`` or not: the volatile binds only the front end.)
// ELL_FULL never reads it.
//
// Every variant keeps the warp-slot skip. The slots after a warp's count
// are padding (zero coefficient), so on finite X the skip changes no value
// of any variant's function.

#pragma once

#include <cuda_runtime.h>

#define ELL_THREADS 128
#define ELL_MIN_BLOCKS 6      // blocks an SM holds, int32 columns: 80 registers
#define ELL_MIN_BLOCKS_I16 5  // the same, int16 offsets: 96 registers
#define ELL_ROWS 8            // rows of X a thread has in flight
#define ELL_KC 9              // (coefficient, column) pairs in registers at a time
#define ELL_WARP 32           // rows that share a slot count (formats.py WARP_ROWS)
#define ELL_TARGET_THREADS (528 * 256)  // half of what 132 SMs can hold

enum EllVariant { ELL_FULL = 0, ELL_NOGATHER = 1, ELL_NODYN = 2, ELL_NOFMA = 3 };

__device__ __forceinline__ float fma_acc(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_acc(double a, double b, double c) { return fma(a, b, c); }

#define ELL_NEVER (1ULL << 32)  // no 32-bit fold equals it; its low word is 0

__device__ __forceinline__ unsigned fold_bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ unsigned fold_bits(double v) {
  const unsigned long long b = (unsigned long long)__double_as_longlong(v);
  return (unsigned)b ^ (unsigned)(b >> 32);
}

// slots j0 .. j0 + KC - 1 of row i into registers; IDX is int (columns) or
// short (offsets col - i); ic = min(i, ncols - 1); zero = 0 (ELL_NOGATHER's
// mask, unknown to ptxas)
template <int V, int KC, typename T, typename IDX>
__device__ __forceinline__ void ell_load(const T* __restrict__ data_t,
                                         const IDX* __restrict__ cols_t, size_t n, size_t i,
                                         int ic, int ncols, int zero, int j0, T (&v)[KC],
                                         int (&c)[KC]) {
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    v[j] = __ldg(data_t + (size_t)(j0 + j) * n + i);
    if constexpr (V == ELL_FULL) {
      const int s = __ldg(cols_t + (size_t)(j0 + j) * n + i);
      c[j] = sizeof(IDX) == 2 ? (int)i + s : s;
    } else if constexpr (V == ELL_NOGATHER) {
      const int s = __ldg(cols_t + (size_t)(j0 + j) * n + i);
      c[j] = ic + (s & zero);
    } else {  // ELL_NODYN: k <= ncols (checked by the launcher), so one subtract
      const int cc = ic + j0 + j;
      c[j] = cc >= ncols ? cc - ncols : cc;
    }
  }
}

// RR rows of X from row r on: KC pairs times their X values, onto acc
template <int V, int KC, int RR, typename T>
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

// A warp whose rows hold at most KC slots: exactly K pairs, loaded once,
// kept in registers over the rows r0 .. r1 - 1 of X.
template <int V, int K, int ROWS, typename T, typename IDX>
__device__ __forceinline__ void ell_short(const T* __restrict__ data_t,
                                          const IDX* __restrict__ cols_t,
                                          const T* __restrict__ x, T* __restrict__ y,
                                          size_t n, size_t ncols, size_t i, int ic, int zero,
                                          int r0, int r1) {
  T v[K];
  int c[K];
  ell_load<V, K>(data_t, cols_t, n, i, ic, (int)ncols, zero, 0, v, c);
  int r = r0;
  for (; r + ROWS <= r1; r += ROWS) {
    T acc[ROWS] = {};
    ell_fma<V, K, ROWS>(x, ncols, r, v, c, acc);
    ell_store<ROWS>(y, n, r, i, acc);
  }
  for (; r < r1; ++r) {
    T acc[1] = {};
    ell_fma<V, K, 1>(x, ncols, r, v, c, acc);
    ell_store<1>(y, n, r, i, acc);
  }
}

// exactly ``kw`` slots, 1 <= kw <= K
template <int V, int K, int ROWS, typename T, typename IDX>
__device__ __forceinline__ void ell_short_tail(int kw, const T* __restrict__ data_t,
                                               const IDX* __restrict__ cols_t,
                                               const T* __restrict__ x,
                                               T* __restrict__ y, size_t n, size_t ncols,
                                               size_t i, int ic, int zero, int r0,
                                               int r1) {
  if constexpr (K > 0) {
    if (kw == K) {
      ell_short<V, K, ROWS>(data_t, cols_t, x, y, n, ncols, i, ic, zero, r0, r1);
    } else {
      ell_short_tail<V, K - 1, ROWS>(kw, data_t, cols_t, x, y, n, ncols, i, ic, zero, r0,
                                     r1);
    }
  }
}

// the last ``rem`` slots from j0 on, 0 <= rem <= K, onto acc
template <int V, int K, int RR, typename T, typename IDX>
__device__ __forceinline__ void ell_long_tail(int rem, const T* __restrict__ data_t,
                                              const IDX* __restrict__ cols_t,
                                              const T* __restrict__ x, size_t n,
                                              size_t ncols, size_t i, int ic, int zero, int j0,
                                              int r, T (&acc)[RR]) {
  if constexpr (K > 0) {
    if (rem == K) {
      T v[K];
      int c[K];
      ell_load<V, K>(data_t, cols_t, n, i, ic, (int)ncols, zero, j0, v, c);
      ell_fma<V, K, RR>(x, ncols, r, v, c, acc);
    } else {
      ell_long_tail<V, K - 1, RR>(rem, data_t, cols_t, x, n, ncols, i, ic, zero, j0, r, acc);
    }
  }
}

// A warp whose rows hold more than KC slots, RR rows of X from row r on:
// chunks of KC pairs and an exact remainder, each loaded again for every
// group of rows (the block's pairs stay in L1), the sums kept in
// registers, so Y is written once.
template <int V, int KC, int RR, typename T, typename IDX>
__device__ __forceinline__ void ell_long(int kw, const T* __restrict__ data_t,
                                         const IDX* __restrict__ cols_t,
                                         const T* __restrict__ x, T* __restrict__ y,
                                         size_t n, size_t ncols, size_t i, int ic, int zero,
                                         int r) {
  T acc[RR] = {};
  int j0 = 0;
  for (; j0 + KC <= kw; j0 += KC) {
    T v[KC];
    int c[KC];
    ell_load<V, KC>(data_t, cols_t, n, i, ic, (int)ncols, zero, j0, v, c);
    ell_fma<V, KC, RR>(x, ncols, r, v, c, acc);
  }
  ell_long_tail<V, KC - 1, RR>(kw - j0, data_t, cols_t, x, n, ncols, i, ic, zero, j0, r,
                               acc);
  ell_store<RR>(y, n, r, i, acc);
}

// One thread per row i; its warp's rows run warp_slots[i / ELL_WARP] slots.
// never: ELL_NEVER (header); ELL_FULL does not read it.
template <int V, int ROWS, int KC, int MIN_BLOCKS, typename T, typename IDX>
__global__ void __launch_bounds__(ELL_THREADS, MIN_BLOCKS)
ell_spmm_t_kernel(const T* __restrict__ data_t, const IDX* __restrict__ cols_t,
                  const int* __restrict__ warp_slots, const T* __restrict__ x,
                  T* __restrict__ y, int n, int ncols, int m, int rows_per_block,
                  unsigned long long never) {
  const int i = blockIdx.x * ELL_THREADS + threadIdx.x;
  if (i >= n) return;
  const int r0 = blockIdx.y * rows_per_block;
  const int r1 = min(m, r0 + rows_per_block);
  const int kw = __ldg(warp_slots + i / ELL_WARP);
  const int ic = min(i, ncols - 1);
  const int zero = (int)(unsigned)never;  // 0, unknown to ptxas
  if constexpr (V == ELL_NOFMA) {
    const T d0 = __ldg(data_t + i);
    unsigned seen = 0;  // slots 1.. of the coefficients, every slot of the indices
    for (int j = 0; j < kw; ++j) {
      if (j) seen ^= fold_bits(__ldg(data_t + (size_t)j * n + i));
      seen ^= (unsigned)__ldg(cols_t + (size_t)j * n + i);
    }
    for (int r = r0; r < r1; ++r) y[(size_t)r * n + i] = __ldg(x + (size_t)r * ncols + ic) + d0;
    if (seen == never) y[i] = T(seen);  // never taken
  } else if (kw == 0) {  // the warp's rows store nothing but padding: Y = 0
    for (int r = r0; r < r1; ++r) y[(size_t)r * n + i] = T(0);
  } else if (kw <= KC) {
    ell_short_tail<V, KC, ROWS>(kw, data_t, cols_t, x, y, (size_t)n, (size_t)ncols, (size_t)i,
                                ic, zero, r0, r1);
  } else {
    int r = r0;
    for (; r + ROWS <= r1; r += ROWS)
      ell_long<V, KC, ROWS>(kw, data_t, cols_t, x, y, (size_t)n, (size_t)ncols, (size_t)i, ic,
                            zero, r);
    for (; r < r1; ++r)
      ell_long<V, KC, 1>(kw, data_t, cols_t, x, y, (size_t)n, (size_t)ncols, (size_t)i, ic,
                         zero, r);
  }
}

// K2's grid: one thread a row, the m rows of X split over blockIdx.y when
// n alone gives the card too few threads
static inline dim3 ell_grid(long long n, int m, int* rows_per_block) {
  const unsigned gx = (unsigned)((n + ELL_THREADS - 1) / ELL_THREADS);
  const unsigned target = ELL_TARGET_THREADS / ELL_THREADS;
  int split = (int)((target + gx - 1) / gx);
  split = split < 1 ? 1 : (split > m ? m : split);
  *rows_per_block = (m + split - 1) / split;
  return dim3(gx, (unsigned)((m + *rows_per_block - 1) / *rows_per_block));
}

// One launch of the body on the caller's stream; index_bytes 2 (int16
// offsets) or 4 (int32 columns); MIN_BLOCKS16 / MIN_BLOCKS32 the caps for
// each.
template <int V, int ROWS, int KC, int MIN_BLOCKS16, int MIN_BLOCKS32, typename T>
static void ell_body_launch(dim3 grid, cudaStream_t s, const void* data_t, const void* cols_t,
                            int index_bytes, const int* slots, const void* x, void* y, int n,
                            int ncols, int m, int rows_per_block) {
  if (index_bytes == 2) {
    ell_spmm_t_kernel<V, ROWS, KC, MIN_BLOCKS16, T, short><<<grid, ELL_THREADS, 0, s>>>(
        (const T*)data_t, (const short*)cols_t, slots, (const T*)x, (T*)y, n, ncols, m,
        rows_per_block, ELL_NEVER);
  } else {
    ell_spmm_t_kernel<V, ROWS, KC, MIN_BLOCKS32, T, int><<<grid, ELL_THREADS, 0, s>>>(
        (const T*)data_t, (const int*)cols_t, slots, (const T*)x, (T*)y, n, ncols, m,
        rows_per_block, ELL_NEVER);
  }
}
