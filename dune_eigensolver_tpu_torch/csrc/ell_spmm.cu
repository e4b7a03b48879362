// General-sparsity (ELL) SpMM in the transposed layout, for Hopper (sm_90a).
//
// Replaces dune_eigensolver_tpu/kernels/gather_spmm.py:792 _seg_kernel
// (launched by windowed_spmm_t, gather_spmm.py:898). It computes what that
// kernel computes, not its machinery:
//
//     Y[r, i] = sum_j data[i, j] * X[r, cols[i, j]]
//
// with X (m, ncols) and Y (m, n) contiguous row-major, f32 storage and f32
// accumulation. The TPU kernel's segments, 128-lane windows, COO tail and
// right-padded layout exist because tpu.dynamic_gather reads one 128-lane
// vreg; a CUDA thread gathers from device memory through L1/L2 directly,
// so the ELL container feeds the kernel as it is. Padding slots hold an
// in-bounds column and a zero coefficient, so no load is masked.
//
// What bounds it: device-memory traffic. Each stored entry is a 4-byte
// coefficient and a 4-byte index that serve 2 flops per row of X, and each
// of those flops gathers an X value from an irregular column. What the
// design does about that: the coefficients arrive as (k, n) streams
// (ELLMatrix.kernel_streams), so one thread per row i loads its k
// (coefficient, column) pairs coalesced across the warp, once, into
// registers, and reuses them for every row of X; the Y writes are
// coalesced across the warp (neighbouring threads, neighbouring columns of
// Y); the X gathers of neighbouring rows land near each other for a banded
// (RCM-ordered) operator and are left to L1/L2. When n is small the m rows
// are split over blockIdx.y so that the card still gets enough blocks.
// Shared-memory staging of X, wider loads and TMA are left for later work.
//
// Interface: plain C, loaded with ctypes. The launch goes on the caller's
// stream and the function returns cudaGetLastError() so the wrapper can
// raise on a refused launch.

#include <cuda_runtime.h>

#define ELL_THREADS 256
#define ELL_TARGET_BLOCKS 528  // 4 blocks of 256 threads on each of 132 SMs

// KC (column, coefficient) pairs of a row sit in registers at a time; a
// row wider than KC is swept in chunks, each adding into Y.
template <int KC>
__global__ void __launch_bounds__(ELL_THREADS)
ell_spmm_t_kernel(const float* __restrict__ data_t, const int* __restrict__ cols_t,
                  const float* __restrict__ x, float* __restrict__ y, int n, int k,
                  int ncols, int m, int rows_per_block) {
  const int i = blockIdx.x * ELL_THREADS + threadIdx.x;
  if (i >= n) return;
  const int r0 = blockIdx.y * rows_per_block;
  const int r1 = min(m, r0 + rows_per_block);
  for (int j0 = 0; j0 < k; j0 += KC) {
    float val[KC];
    int col[KC];
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      val[j] = 0.f;
      col[j] = 0;
      if (j0 + j < k) {
        val[j] = __ldg(data_t + (size_t)(j0 + j) * n + i);
        col[j] = __ldg(cols_t + (size_t)(j0 + j) * n + i);
      }
    }
    for (int r = r0; r < r1; ++r) {
      const float* xr = x + (size_t)r * ncols;
      float* yr = y + (size_t)r * n + i;
      float acc = j0 ? *yr : 0.f;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        if (j0 + j < k) acc += val[j] * __ldg(xr + col[j]);
      }
      *yr = acc;
    }
  }
}

extern "C" {

// Returns a cudaError_t as int.
int ell_spmm_t_launch(const void* data_t, const void* cols_t, long long n, int k,
                      long long ncols, const void* x, void* y, int m, void* stream) {
  if (n < 0 || n > 0x7fffffffLL || ncols < 1 || ncols > 0x7fffffffLL || k < 0 || m < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 0) return (int)cudaGetLastError();
  if (k == 0) {  // no stored entries: Y = 0
    cudaMemsetAsync(y, 0, (size_t)m * (size_t)n * sizeof(float), s);
    return (int)cudaGetLastError();
  }
  const unsigned gx = (unsigned)((n + ELL_THREADS - 1) / ELL_THREADS);
  int split = (int)((ELL_TARGET_BLOCKS + gx - 1) / gx);
  split = split < 1 ? 1 : (split > m ? m : split);
  const int rows_per_block = (m + split - 1) / split;
  const dim3 grid(gx, (unsigned)((m + rows_per_block - 1) / rows_per_block));
  const float* d = (const float*)data_t;
  const int* c = (const int*)cols_t;
  const float* xp = (const float*)x;
  float* yp = (float*)y;
  const int nn = (int)n, nc = (int)ncols;
  if (k <= 8) {
    ell_spmm_t_kernel<8><<<grid, ELL_THREADS, 0, s>>>(d, c, xp, yp, nn, k, nc, m, rows_per_block);
  } else if (k <= 16) {
    ell_spmm_t_kernel<16><<<grid, ELL_THREADS, 0, s>>>(d, c, xp, yp, nn, k, nc, m, rows_per_block);
  } else if (k <= 24) {
    ell_spmm_t_kernel<24><<<grid, ELL_THREADS, 0, s>>>(d, c, xp, yp, nn, k, nc, m, rows_per_block);
  } else {
    ell_spmm_t_kernel<32><<<grid, ELL_THREADS, 0, s>>>(d, c, xp, yp, nn, k, nc, m, rows_per_block);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
