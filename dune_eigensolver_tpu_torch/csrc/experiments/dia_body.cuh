// What the DIA staging variants (dia_variants.cu, dia_stage_c.cu,
// dia_stage_d.cu) share: the offsets struct, the cp.async staging (B's
// first version and the async routes of C and D), and the compute body of
// the staged variants, for Hopper (sm_90a).
//
// The body computes one output tile of
//
//     Y[r, i] = sum_d data[d, i] * X[r, i + off_d],   zero outside [0, n)
//
// from shared memory alone: a window of X (`where(p)` is the index in
// dv_smem of X[row0, tile0 + p], row r lying r * rstride further) and the
// tile's coefficients, staged with the window as an (ndiag, T) tile, so
// that they cross device memory once per tile per block and serve every
// row the block holds. It is K1's body (csrc/dia_spmm.cu) moved onto a
// staged window:
//   * V = 4 consecutive columns a thread, read as 16-byte shared-memory
//     loads where the offset is a multiple of 4; the +-1 neighbours come
//     from the adjacent lanes' centre vectors by warp shuffle, lanes 0 and
//     31 load theirs; Y is stored 16 bytes a thread. V = 1 (one column a
//     thread) takes any n and any offsets
//     (experiments/kernel_variants.py::stage_width chooses);
//   * two rows of X in flight a thread; the block's threads are dealt the
//     (row pair, column vector) items of the tile, so a block of more rows
//     than one thread holds still keeps every thread busy;
//   * one chain of fused multiply-adds per output, diagonals in offset
//     order, as K1: the window holds zeros outside [0, n), so a term whose
//     column lies outside adds coefficient * 0, and the result is K1's
//     bits on finite operands.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

#define DV_MAX_DIAG 16
#define DV_THREADS 256
#define DV_MAX_SLOTS 4
#define DV_D_RING 4  // tiles of X a block of variant D holds

struct DvOffsets {
  int count;
  int off[DV_MAX_DIAG];
};

extern __shared__ __align__(16) float dv_smem[];

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int bytes = valid ? 16 : 0;  // src-size 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(gmem), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most `pending` (0..DV_MAX_SLOTS - 1) commit groups are
// still in flight; the instruction takes its count as an immediate
__device__ __forceinline__ void cp_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// Start the copy of `rows` rows of `width` columns into dst (rows, width):
// row r comes from src + (row0 + r) * stride, columns g0 .. g0 + width - 1;
// a column outside [0, bound) or a row >= m is zero-filled. vec: 16-byte
// copies (g0, width, stride, bound multiples of 4, src 16-byte aligned).
__device__ __forceinline__ void stage(float* dst, const float* src, long long stride,
                                      long long bound, int row0, int rows, int m,
                                      long long g0, int width, bool vec) {
  if (vec) {
    const int w4 = width >> 2;
    for (int idx = threadIdx.x; idx < rows * w4; idx += DV_THREADS) {
      const int r = idx / w4, c = (idx - r * w4) << 2;
      const long long g = g0 + c;
      const bool ok = row0 + r < m && g >= 0 && g < bound;
      cp_async16(dst + r * width + c, ok ? src + (size_t)(row0 + r) * stride + g : src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * width; idx += DV_THREADS) {
      const int r = idx / width, c = idx - r * width;
      const long long g = g0 + c;
      const bool ok = row0 + r < m && g >= 0 && g < bound;
      cp_async4(dst + r * width + c, ok ? src + (size_t)(row0 + r) * stride + g : src, ok);
    }
  }
}

// `where` of a staged window that starts `base` floats into dv_smem and
// whose column 0 is column tile0 + lo of X
struct WindowAt {
  int base, lo;
  __device__ __forceinline__ int operator()(int p) const { return base + p - lo; }
};

// A barrier of the block's first `threads` threads alone (the compute
// threads; a producer warp beside them does not take part).
__device__ __forceinline__ void compute_sync(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// Zeros over the columns outside [a, b) of `nrows` rows of a window of
// width W (row stride W), by `nthreads` threads: bulk copies do not
// zero-fill, and the function reads X as zero outside [0, n).
__device__ __forceinline__ void zero_outside(float* win, int W, int nrows, int a, int b,
                                             int tid, int nthreads) {
  const int out = W - (b - a);
  for (int idx = tid; idx < nrows * out; idx += nthreads) {
    const int r = idx / out, c = idx - r * out;
    win[r * W + (c < a ? c : c - a + b)] = 0.f;
  }
}

// One output tile: columns tile0 .. tile0 + ncol - 1 of rows row0 ..
// row0 + nrows - 1 of Y, by THREADS threads (tid 0 .. THREADS - 1). `cs` is
// the tile's coefficients in shared memory, (ndiag, T). V = 4 needs T a
// multiple of 128 (a warp's 32 vectors lie in one row pair, so its
// shuffles are whole), n a multiple of 4, a stencil of ND = 5 or 7
// diagonals whose middle three are (-1, 0, 1) and whose others are
// multiples of 4, and `where` of a multiple of 4 on 16 bytes. A thread
// whose columns lie past ncol (a last tile cut short) reads the window
// where it lies and stores nothing, so its neighbours' shuffles stay
// whole. V = 1: ND is the number of slots, offs.count of them live.
template <int V, int ND, int THREADS, typename Where>
__device__ __forceinline__ void stage_tile(Where where, int rstride, const float* cs,
                                           float* __restrict__ y, int n, int T, long long tile0,
                                           int ncol, int row0, int nrows, const DvOffsets& offs,
                                           int tid) {
  const int pairs = (nrows + 1) >> 1;
  if constexpr (V == 4) {
    constexpr int C = ND / 2;
    const int NV = T >> 2;
    const int lane = tid & 31;
    for (int i = tid; i < NV * pairs; i += THREADS) {
      const int pr = i / NV, c = (i - pr * NV) << 2;
      const int r = 2 * pr;
      const bool two = r + 1 < nrows, live = c < ncol;
      float cf[ND][4];
      int at[ND];
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        const float4 t = *reinterpret_cast<const float4*>(cs + d * T + c);
        cf[d][0] = t.x; cf[d][1] = t.y; cf[d][2] = t.z; cf[d][3] = t.w;
        at[d] = where(c + offs.off[d]);
      }
      const int at_l = where(c - 1), at_r = where(c + 4);
      float xv[2][ND][4], xl[2], xr[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float* xs = dv_smem + (q == 0 || two ? r + q : r) * rstride;
#pragma unroll
        for (int d = 0; d < ND; ++d) {
          if (d == C - 1 || d == C + 1) continue;
          const float4 t = *reinterpret_cast<const float4*>(xs + at[d]);
          xv[q][d][0] = t.x; xv[q][d][1] = t.y; xv[q][d][2] = t.z; xv[q][d][3] = t.w;
        }
        xl[q] = lane == 0 ? xs[at_l] : 0.f;
        xr[q] = lane == 31 ? xs[at_r] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float up = __shfl_up_sync(0xffffffffu, xv[q][C][3], 1);
        const float down = __shfl_down_sync(0xffffffffu, xv[q][C][0], 1);
        xv[q][C - 1][0] = lane == 0 ? xl[q] : up;
        xv[q][C + 1][3] = lane == 31 ? xr[q] : down;
#pragma unroll
        for (int v = 1; v < 4; ++v) {
          xv[q][C - 1][v] = xv[q][C][v - 1];
          xv[q][C + 1][v - 1] = xv[q][C][v];
        }
        float acc[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          float a = 0.f;
#pragma unroll
          for (int d = 0; d < ND; ++d) a = fmaf(cf[d][v], xv[q][d][v], a);
          acc[v] = a;
        }
        if (live && (q == 0 || two))
          *reinterpret_cast<float4*>(y + (size_t)(row0 + r + q) * n + tile0 + c) =
              make_float4(acc[0], acc[1], acc[2], acc[3]);
      }
    }
  } else {
    static_assert(V == 1, "stage_tile: V is 4 or 1");
    for (int i = tid; i < T * pairs; i += THREADS) {
      const int pr = i / T, c = i - pr * T;
      if (c >= ncol) continue;
      const int r = 2 * pr;
      const bool two = r + 1 < nrows;
      float cf[ND];
      int at[ND];
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        const bool on = d < offs.count;
        cf[d] = on ? cs[d * T + c] : 0.f;
        at[d] = on ? where(c + offs.off[d]) : 0;
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (q == 1 && !two) break;
        const float* xs = dv_smem + (r + q) * rstride;
        float a = 0.f;
#pragma unroll
        for (int d = 0; d < ND; ++d)
          if (d < offs.count) a = fmaf(cf[d], xs[at[d]], a);
        y[(size_t)(row0 + r + q) * n + tile0 + c] = a;
      }
    }
  }
}

// side[chunk][which][r][c] = X[r, tile * T + c] (zero outside [0, n)) for
// tile = t0 - 1 (which = 0) and t1 (which = 1) of every chunk: variant D's
// in-place halos. One block a (chunk, which) and row.
static __global__ void __launch_bounds__(DV_THREADS)
dia_d_save_halo(const float* __restrict__ x, float* __restrict__ side, int n, int m,
                int T, int tpc, int ntiles) {
  const int chunk = blockIdx.x >> 1, which = blockIdx.x & 1;
  const int r = blockIdx.y;
  const int t0 = chunk * tpc;
  const long long tile = which ? min(t0 + tpc, ntiles) : t0 - 1;
  float* dst = side + ((size_t)(2 * chunk + which) * m + r) * T;
  for (int c = threadIdx.x; c < T; c += DV_THREADS) {
    const long long g = tile * T + c;
    dst[c] = (g >= 0 && g < n) ? x[(size_t)r * n + g] : 0.f;
  }
}

static inline bool dv_aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

static inline int dv_fill_offsets(DvOffsets* offs, int ndiag, const int* offsets) {
  if (ndiag < 1 || ndiag > DV_MAX_DIAG) return 1;
  offs->count = ndiag;
  for (int d = 0; d < DV_MAX_DIAG; ++d) offs->off[d] = d < ndiag ? offsets[d] : 0;
  return 0;
}

// Whether the offsets allow V = 4: a stencil of 5 or 7 diagonals around
// (-1, 0, 1) whose other offsets are multiples of 4 (the rule of
// experiments/kernel_variants.py::stage_width, checked again here)
static inline bool dv_stencil4(int ndiag, const int* offsets) {
  if (ndiag != 5 && ndiag != 7) return false;
  const int c = ndiag / 2;
  for (int d = 0; d < ndiag; ++d) {
    if (d >= c - 1 && d <= c + 1) {
      if (offsets[d] != d - c) return false;
    } else if (offsets[d] % 4) {
      return false;
    }
  }
  return true;
}

// Allow `bytes` of dynamic shared memory. A refusal (more than a block may
// have) is returned and cleared, so that it is not found again by the next
// launch's cudaGetLastError().
template <typename K>
static int dv_opt_in_shared(K kernel, size_t bytes) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

// The in-place pre-pass of variant D, on the caller's stream.
static inline int dv_save_halo(const void* x, void* side, long long n, int m, int T, int tpc,
                               int ntiles, int nchunks, cudaStream_t s) {
  dia_d_save_halo<<<dim3(2 * nchunks, m), DV_THREADS, 0, s>>>((const float*)x, (float*)side,
                                                              (int)n, m, T, tpc, ntiles);
  return (int)cudaGetLastError();
}
