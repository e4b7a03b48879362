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
// X, far below the card's ops-per-byte balance; the X reads are b-wide
// gathers at irregular block columns. What the design does about that:
// the blocks arrive as (k, nbr, b, b) streams (BSRMatrix.kernel_streams),
// so one thread per block row I loads its blocks as 16-byte vectors,
// adjacent across the warp, once, into registers, and reuses them for
// every row of X; each block column of X is one 8- or 16-byte load; the b
// outputs of a block row are one vector store, adjacent across the warp.
// The gathers of neighbouring block rows land near each other for a banded
// (RCM-ordered or mesh-ordered) operator and are left to L1/L2. When the
// operator is small the m rows are split over blockIdx.y so that the card
// still gets enough blocks. Shared-memory staging of X and TMA are left
// for later work.
//
// Interface: plain C, loaded with ctypes. The launch goes on the caller's
// stream and the function returns cudaGetLastError() so the wrapper can
// raise on a refused launch.

#include <cuda_runtime.h>

#define BSR_THREADS 256
#define BSR_TARGET_BLOCKS 528  // 4 blocks of 256 threads on each of 132 SMs

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

// KC blocks of a block row sit in registers at a time (KC*B*B floats); a
// wider block row is swept in chunks, each adding into Y.
template <int B, int KC>
__global__ void __launch_bounds__(BSR_THREADS)
bsr_spmm_t_kernel(const float* __restrict__ bdata_t, const int* __restrict__ bcols_t,
                  const float* __restrict__ x, float* __restrict__ y, int nbr, int k,
                  int ncols, int m, int rows_per_block) {
  const int I = blockIdx.x * BSR_THREADS + threadIdx.x;
  if (I >= nbr) return;
  const size_t n = (size_t)nbr * B;
  const int r0 = blockIdx.y * rows_per_block;
  const int r1 = min(m, r0 + rows_per_block);
  for (int j0 = 0; j0 < k; j0 += KC) {
    float a[KC][B][B];
    int c[KC];
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      c[j] = 0;
#pragma unroll
      for (int p = 0; p < B; ++p) {
#pragma unroll
        for (int q = 0; q < B; ++q) a[j][p][q] = 0.f;
      }
      if (j0 + j < k) {
        const float* blk = bdata_t + ((size_t)(j0 + j) * nbr + I) * (B * B);
#pragma unroll
        for (int p = 0; p < B; ++p) load_vec<B>(blk + p * B, a[j][p]);
        c[j] = B * __ldg(bcols_t + (size_t)(j0 + j) * nbr + I);
      }
    }
    for (int r = r0; r < r1; ++r) {
      const float* xr = x + (size_t)r * ncols;
      float* yr = y + (size_t)r * n + (size_t)I * B;
      float acc[B];
      if (j0) {
        load_vec<B>(yr, acc);
      } else {
#pragma unroll
        for (int p = 0; p < B; ++p) acc[p] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        if (j0 + j < k) {
          float xv[B];
          load_vec<B>(xr + c[j], xv);
#pragma unroll
          for (int p = 0; p < B; ++p) {
#pragma unroll
            for (int q = 0; q < B; ++q) acc[p] += a[j][p][q] * xv[q];
          }
        }
      }
      store_vec<B>(yr, acc);
    }
  }
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
  int split = (int)((BSR_TARGET_BLOCKS + gx - 1) / gx);
  split = split < 1 ? 1 : (split > m ? m : split);
  const int rpb = (m + split - 1) / split;
  const dim3 grid(gx, (unsigned)((m + rpb - 1) / rpb));
  const int nb = (int)nbr, nc = (int)ncols;
  if (b == 2) {
    if (k <= 4) {
      launch<2, 4>(grid, s, bdata_t, bcols_t, x, y, nb, k, nc, m, rpb);
    } else if (k <= 9) {
      launch<2, 9>(grid, s, bdata_t, bcols_t, x, y, nb, k, nc, m, rpb);
    } else {
      launch<2, 16>(grid, s, bdata_t, bcols_t, x, y, nb, k, nc, m, rpb);
    }
  } else {
    launch<4, 4>(grid, s, bdata_t, bcols_t, x, y, nb, k, nc, m, rpb);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
