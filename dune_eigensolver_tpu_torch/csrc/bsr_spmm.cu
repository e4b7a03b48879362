// Block-ELL (BSR) SpMM in the transposed layout, for Hopper (sm_90a).
//
// Replaces dune_eigensolver_tpu/kernels/gather_spmm.py:845 _blk_kernel
// (launched by windowed_spmm_t, gather_spmm.py:898). It computes what that
// kernel computes, not its machinery:
//
//     Y[r, b*I + a] = sum_j sum_c bdata[I, j, a, c] * X[r, b*bcols[I, j] + c]
//
// for square b x b blocks, b in {2, 4}, with X (m, ncols) and Y (m, n)
// contiguous row-major, f32 storage and f32 accumulation, or f64 storage
// and f64 accumulation (the card's f64 solves and the f64 Rayleigh-Ritz
// refinement; the TPU had no f64). The TPU kernel
// gathers one 128-lane vreg per block column into b shift-group
// accumulators and aligns them with lane rolls; all of that is TPU
// artefact. Here a block column is b adjacent X values, one vector load.
// Padding slots hold an in-bounds block column and a zero block.
//
// What bounds it: device-memory traffic. Each stored block is b*b 4-byte
// coefficients and one 4-byte block index serving 2*b*b flops per row of
// X, far below the card's ops-per-byte balance; at m = 8 the coefficient
// stream is 58% of the bytes. What held the first version under half of
// that bound was the number of load requests and how few were in flight
// (two 8-byte halves a 2 x 2 block, a serial row loop with k gathers in
// flight) and, for wide block rows, a register chunk of 16 blocks.
//
// What the design does about that: the blocks arrive as (k, nbr, b, b)
// streams (BSRMatrix.kernel_streams), so one thread per block row I loads
// each 2 x 2 block with one 16-byte request (a 4 x 4 block with four),
// adjacent across the warp, once, into registers, and reuses it for every
// row of X; the row loop is unrolled by BSR_ROWS rows, so BSR_ROWS x k
// gathers of X (one 8- or 16-byte load a block column) are in flight; the
// b outputs of a block row are one vector store. A block row of up to
// BSR_KC blocks is held whole, with the exact count as a template constant
// (no predicated slot); a wider one is swept in chunks of BSR_KC and an
// exact remainder, each chunk adding into Y (on a 27-block row chunks of 9
// beat 8, 6 and 4: a pass over X and Y costs more than the registers). The
// gathers of neighbouring block rows land near each other for a banded
// (RCM-ordered or mesh-ordered) operator and are left to L1/L2. When the
// operator is small the m rows are split over blockIdx.y so that the card
// still gets enough threads. Blocks in stream order, one chain of fused
// multiply-adds per output, the chunks chained through Y: the first
// version's bits.
// f64 is the same body with the value type a template parameter (BsrCfg):
// a 2 x 2 block is two 16-byte requests, a 4 x 4 block eight, a block
// column of X one (b = 2) or two (b = 4); fewer rows of X and, for b = 4,
// fewer blocks in registers, since each value takes two registers.
// Registers (ptxas, sm_90a): see PERF.md section 6; the build log prints
// them.
//
// Interface: plain C, loaded with ctypes. The launch goes on the caller's
// stream and the function returns cudaGetLastError() so the wrapper can
// raise on a refused launch.

#include <cuda_runtime.h>

#define BSR_THREADS 128
#define BSR_ROWS 4  // rows of X a thread has in flight
#define BSR_KC 9    // blocks of a 2 x 2 block row in registers at a time
#define BSR_KC4 4   // the same for 4 x 4 blocks
#define BSR_TARGET_THREADS (528 * 256)  // half of what 132 SMs can hold
#define BSR_ROWS_F64 2  // rows of X in flight in f64
#define BSR_KC4_F64 2   // blocks of a 4 x 4 block row in registers in f64

// blocks in registers and rows of X in flight, by value type and block size
template <typename T, int B> struct BsrCfg {
  static constexpr int KC = B == 2 ? BSR_KC : BSR_KC4;
  static constexpr int ROWS = BSR_ROWS;
};
template <int B> struct BsrCfg<double, B> {
  static constexpr int KC = B == 2 ? BSR_KC : BSR_KC4_F64;
  static constexpr int ROWS = BSR_ROWS_F64;
};

__device__ __forceinline__ float fma_acc(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_acc(double a, double b, double c) { return fma(a, b, c); }

template <int B> struct Vec;
template <> struct Vec<2> { using type = float2; };
template <> struct Vec<4> { using type = float4; };

// B adjacent f64 values, 16-byte aligned: B / 2 requests of 16 bytes
template <int B>
__device__ __forceinline__ void load_vec(const double* p, double (&v)[B]) {
#pragma unroll
  for (int h = 0; h < B; h += 2) {
    const double2 t = __ldg(reinterpret_cast<const double2*>(p + h));
    v[h] = t.x;
    v[h + 1] = t.y;
  }
}

template <int B>
__device__ __forceinline__ void store_vec(double* p, const double (&v)[B]) {
#pragma unroll
  for (int h = 0; h < B; h += 2)
    *reinterpret_cast<double2*>(p + h) = make_double2(v[h], v[h + 1]);
}

template <int B>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[B]) {
  const typename Vec<B>::type t = __ldg(reinterpret_cast<const typename Vec<B>::type*>(p));
  v[0] = t.x;
  v[1] = t.y;
  if constexpr (B == 4) {
    v[2] = t.z;
    v[3] = t.w;
  }
}

template <int B>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[B]) {
  typename Vec<B>::type t;
  t.x = v[0];
  t.y = v[1];
  if constexpr (B == 4) {
    t.z = v[2];
    t.w = v[3];
  }
  *reinterpret_cast<typename Vec<B>::type*>(p) = t;
}

// one block, row-major, 16-byte aligned: one request for 2 x 2, four for 4 x 4
template <int B>
__device__ __forceinline__ void load_block(const float* p, float (&a)[B][B]) {
  if constexpr (B == 2) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    a[0][0] = t.x;
    a[0][1] = t.y;
    a[1][0] = t.z;
    a[1][1] = t.w;
  } else {
#pragma unroll
    for (int p_ = 0; p_ < B; ++p_) load_vec<B>(p + p_ * B, a[p_]);
  }
}

// the same in f64, one row of the block at a time
template <int B>
__device__ __forceinline__ void load_block(const double* p, double (&a)[B][B]) {
#pragma unroll
  for (int p_ = 0; p_ < B; ++p_) load_vec<B>(p + p_ * B, a[p_]);
}

// RR rows of Y from row r on: KC blocks in registers times their block
// columns of X, onto zero (first chunk) or onto what Y holds.
template <int B, int KC, int RR, typename T>
__device__ __forceinline__ void bsr_rows(const T* __restrict__ x, T* __restrict__ y,
                                         size_t ncols, size_t n, int r, size_t col0, bool first,
                                         const T (&a)[KC][B][B], const int (&c)[KC]) {
  T xv[RR][KC][B];
  T acc[RR][B];
#pragma unroll
  for (int q = 0; q < RR; ++q) {
    const T* xr = x + (size_t)(r + q) * ncols;
#pragma unroll
    for (int j = 0; j < KC; ++j) load_vec<B>(xr + c[j], xv[q][j]);
    if (first) {
#pragma unroll
      for (int p = 0; p < B; ++p) acc[q][p] = T(0);
    } else {
      load_vec<B>(y + (size_t)(r + q) * n + col0, acc[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < RR; ++q) {
#pragma unroll
    for (int j = 0; j < KC; ++j) {
#pragma unroll
      for (int p = 0; p < B; ++p) {
#pragma unroll
        for (int s = 0; s < B; ++s) acc[q][p] = fma_acc(a[j][p][s], xv[q][j][s], acc[q][p]);
      }
    }
    store_vec<B>(y + (size_t)(r + q) * n + col0, acc[q]);
  }
}

// blocks j0 .. j0 + KC - 1 of block row I, over rows r0 .. r1 - 1
template <int B, int KC, typename T>
__device__ __forceinline__ void bsr_chunk(const T* __restrict__ bdata_t,
                                          const int* __restrict__ bcols_t,
                                          const T* __restrict__ x, T* __restrict__ y,
                                          size_t nbr, size_t ncols, size_t I, int j0, int r0,
                                          int r1) {
  constexpr int ROWS = BsrCfg<T, B>::ROWS;
  T a[KC][B][B];
  int c[KC];
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    load_block<B>(bdata_t + ((size_t)(j0 + j) * nbr + I) * (B * B), a[j]);
    c[j] = B * __ldg(bcols_t + (size_t)(j0 + j) * nbr + I);
  }
  const size_t n = nbr * B, col0 = I * B;
  int r = r0;
  for (; r + ROWS <= r1; r += ROWS)
    bsr_rows<B, KC, ROWS>(x, y, ncols, n, r, col0, j0 == 0, a, c);
  for (; r < r1; ++r) bsr_rows<B, KC, 1>(x, y, ncols, n, r, col0, j0 == 0, a, c);
}

// the remainder of a block row: exactly ``rem`` blocks, 0 <= rem <= K
template <int B, int K, typename T>
__device__ __forceinline__ void bsr_tail(int rem, const T* __restrict__ bdata_t,
                                         const int* __restrict__ bcols_t,
                                         const T* __restrict__ x, T* __restrict__ y,
                                         size_t nbr, size_t ncols, size_t I, int j0, int r0,
                                         int r1) {
  if constexpr (K > 0) {
    if (rem == K) {
      bsr_chunk<B, K>(bdata_t, bcols_t, x, y, nbr, ncols, I, j0, r0, r1);
    } else {
      bsr_tail<B, K - 1>(rem, bdata_t, bcols_t, x, y, nbr, ncols, I, j0, r0, r1);
    }
  }
}

// KC blocks of a block row sit in registers at a time (KC*B*B values); a
// wider block row is swept in chunks, each adding into Y. k >= 1.
template <typename T, int B, int KC>
__global__ void __launch_bounds__(BSR_THREADS)
bsr_spmm_t_kernel(const T* __restrict__ bdata_t, const int* __restrict__ bcols_t,
                  const T* __restrict__ x, T* __restrict__ y, int nbr, int k,
                  int ncols, int m, int rows_per_block) {
  const int I = blockIdx.x * BSR_THREADS + threadIdx.x;
  if (I >= nbr) return;
  const int r0 = blockIdx.y * rows_per_block;
  const int r1 = min(m, r0 + rows_per_block);
  int j0 = 0;
  for (; j0 + KC <= k; j0 += KC)
    bsr_chunk<B, KC>(bdata_t, bcols_t, x, y, (size_t)nbr, (size_t)ncols, (size_t)I, j0, r0, r1);
  bsr_tail<B, KC - 1>(k - j0, bdata_t, bcols_t, x, y, (size_t)nbr, (size_t)ncols, (size_t)I, j0,
                      r0, r1);
}

template <typename T, int B>
static void launch(dim3 grid, cudaStream_t s, const void* bdata_t, const void* bcols_t,
                   const void* x, void* y, int nbr, int k, int ncols, int m,
                   int rows_per_block) {
  bsr_spmm_t_kernel<T, B, BsrCfg<T, B>::KC><<<grid, BSR_THREADS, 0, s>>>(
      (const T*)bdata_t, (const int*)bcols_t, (const T*)x, (T*)y, nbr, k, ncols, m,
      rows_per_block);
}

extern "C" {

// value_bytes: 4 (float32 blocks, X and Y) or 8 (float64); b: block size,
// 2 or 4. Returns a cudaError_t as int.
int bsr_spmm_t_launch(int value_bytes, int b, const void* bdata_t, const void* bcols_t,
                      long long nbr, int k, long long ncols, const void* x, void* y, int m,
                      void* stream) {
  if ((b != 2 && b != 4) || nbr < 0 || nbr * b > 0x7fffffffLL || ncols < b ||
      ncols > 0x7fffffffLL || ncols % b || k < 0 || m < 1 ||
      (value_bytes != 4 && value_bytes != 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (nbr == 0) return (int)cudaGetLastError();
  if (k == 0) {  // no stored blocks: Y = 0
    cudaMemsetAsync(y, 0, (size_t)m * (size_t)nbr * b * value_bytes, s);
    return (int)cudaGetLastError();
  }
  const unsigned gx = (unsigned)((nbr + BSR_THREADS - 1) / BSR_THREADS);
  const unsigned target = BSR_TARGET_THREADS / BSR_THREADS;
  int split = (int)((target + gx - 1) / gx);
  split = split < 1 ? 1 : (split > m ? m : split);
  const int rpb = (m + split - 1) / split;
  const dim3 grid(gx, (unsigned)((m + rpb - 1) / rpb));
  const int nb = (int)nbr, nc = (int)ncols;
  if (value_bytes == 4) {
    if (b == 2) {
      launch<float, 2>(grid, s, bdata_t, bcols_t, x, y, nb, k, nc, m, rpb);
    } else {
      launch<float, 4>(grid, s, bdata_t, bcols_t, x, y, nb, k, nc, m, rpb);
    }
  } else if (b == 2) {
    launch<double, 2>(grid, s, bdata_t, bcols_t, x, y, nb, k, nc, m, rpb);
  } else {
    launch<double, 4>(grid, s, bdata_t, bcols_t, x, y, nb, k, nc, m, rpb);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
