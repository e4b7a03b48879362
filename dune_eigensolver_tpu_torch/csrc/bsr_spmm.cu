// Block-ELL (BSR) SpMM in the transposed layout, for Hopper (sm_90a).
//
// Replaces dune_eigensolver_tpu/kernels/gather_spmm.py:845 _blk_kernel
// (launched by windowed_spmm_t, gather_spmm.py:898). It computes what that
// kernel computes, not its machinery:
//
//     Y[r, b*I + a] = sum_j sum_c bdata[I, j, a, c] * X[r, b*bcols[I, j] + c]
//
// for square b x b blocks, b in {2, 4}, with X (m, ncols) and Y (m, n)
// contiguous row-major, f32 storage and f32 accumulation. The TPU kernel
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

template <int B> struct Vec;
template <> struct Vec<2> { using type = float2; };
template <> struct Vec<4> { using type = float4; };

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

// RR rows of Y from row r on: KC blocks in registers times their block
// columns of X, onto zero (first chunk) or onto what Y holds.
template <int B, int KC, int RR>
__device__ __forceinline__ void bsr_rows(const float* __restrict__ x, float* __restrict__ y,
                                         size_t ncols, size_t n, int r, size_t col0, bool first,
                                         const float (&a)[KC][B][B], const int (&c)[KC]) {
  float xv[RR][KC][B];
  float acc[RR][B];
#pragma unroll
  for (int q = 0; q < RR; ++q) {
    const float* xr = x + (size_t)(r + q) * ncols;
#pragma unroll
    for (int j = 0; j < KC; ++j) load_vec<B>(xr + c[j], xv[q][j]);
    if (first) {
#pragma unroll
      for (int p = 0; p < B; ++p) acc[q][p] = 0.f;
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
        for (int s = 0; s < B; ++s) acc[q][p] = fmaf(a[j][p][s], xv[q][j][s], acc[q][p]);
      }
    }
    store_vec<B>(y + (size_t)(r + q) * n + col0, acc[q]);
  }
}

// blocks j0 .. j0 + KC - 1 of block row I, over rows r0 .. r1 - 1
template <int B, int KC>
__device__ __forceinline__ void bsr_chunk(const float* __restrict__ bdata_t,
                                          const int* __restrict__ bcols_t,
                                          const float* __restrict__ x, float* __restrict__ y,
                                          size_t nbr, size_t ncols, size_t I, int j0, int r0,
                                          int r1) {
  float a[KC][B][B];
  int c[KC];
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    load_block<B>(bdata_t + ((size_t)(j0 + j) * nbr + I) * (B * B), a[j]);
    c[j] = B * __ldg(bcols_t + (size_t)(j0 + j) * nbr + I);
  }
  const size_t n = nbr * B, col0 = I * B;
  int r = r0;
  for (; r + BSR_ROWS <= r1; r += BSR_ROWS)
    bsr_rows<B, KC, BSR_ROWS>(x, y, ncols, n, r, col0, j0 == 0, a, c);
  for (; r < r1; ++r) bsr_rows<B, KC, 1>(x, y, ncols, n, r, col0, j0 == 0, a, c);
}

// the remainder of a block row: exactly ``rem`` blocks, 0 <= rem <= K
template <int B, int K>
__device__ __forceinline__ void bsr_tail(int rem, const float* __restrict__ bdata_t,
                                         const int* __restrict__ bcols_t,
                                         const float* __restrict__ x, float* __restrict__ y,
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

// KC blocks of a block row sit in registers at a time (KC*B*B floats); a
// wider block row is swept in chunks, each adding into Y. k >= 1.
template <int B, int KC>
__global__ void __launch_bounds__(BSR_THREADS)
bsr_spmm_t_kernel(const float* __restrict__ bdata_t, const int* __restrict__ bcols_t,
                  const float* __restrict__ x, float* __restrict__ y, int nbr, int k,
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

template <int B, int KC>
static void launch(dim3 grid, cudaStream_t s, const void* bdata_t, const void* bcols_t,
                   const void* x, void* y, int nbr, int k, int ncols, int m,
                   int rows_per_block) {
  bsr_spmm_t_kernel<B, KC><<<grid, BSR_THREADS, 0, s>>>(
      (const float*)bdata_t, (const int*)bcols_t, (const float*)x, (float*)y, nbr, k,
      ncols, m, rows_per_block);
}

extern "C" {

// b: block size, 2 or 4. Returns a cudaError_t as int.
int bsr_spmm_t_launch(int b, const void* bdata_t, const void* bcols_t, long long nbr,
                      int k, long long ncols, const void* x, void* y, int m,
                      void* stream) {
  if ((b != 2 && b != 4) || nbr < 0 || nbr * b > 0x7fffffffLL || ncols < b ||
      ncols > 0x7fffffffLL || ncols % b || k < 0 || m < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (nbr == 0) return (int)cudaGetLastError();
  if (k == 0) {  // no stored blocks: Y = 0
    cudaMemsetAsync(y, 0, (size_t)m * (size_t)nbr * b * sizeof(float), s);
    return (int)cudaGetLastError();
  }
  const unsigned gx = (unsigned)((nbr + BSR_THREADS - 1) / BSR_THREADS);
  const unsigned target = BSR_TARGET_THREADS / BSR_THREADS;
  int split = (int)((target + gx - 1) / gx);
  split = split < 1 ? 1 : (split > m ? m : split);
  const int rpb = (m + split - 1) / split;
  const dim3 grid(gx, (unsigned)((m + rpb - 1) / rpb));
  const int nb = (int)nbr, nc = (int)ncols;
  if (b == 2) {
    launch<2, BSR_KC>(grid, s, bdata_t, bcols_t, x, y, nb, k, nc, m, rpb);
  } else {
    launch<4, BSR_KC4>(grid, s, bdata_t, bcols_t, x, y, nb, k, nc, m, rpb);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
