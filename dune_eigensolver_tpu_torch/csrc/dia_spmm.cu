// Tall-skinny DIA SpMM in the transposed layout, for Hopper (sm_90a).
//
// Replaces dune_eigensolver_tpu/kernels/dia_spmm.py::_kernel (launched by
// padded_spmm). It computes what that kernel computes, not its tiling:
//
//     Y[r, i] = sum_d data[d, i] * X[r, i + off_d],   zero outside [0, n)
//
// with X and Y contiguous row-major (m, n), data (ndiag, n), f32 or bf16
// storage and f32 accumulation. The TPU kernel's rolling VMEM window and
// far-offset windows exist for Pallas BlockSpecs; here each thread masks
// its own out-of-range columns.
//
// What bounds it: device-memory bytes. Each coefficient (4 bytes in f32)
// serves 2 flops per row of X, far below the card's ops-per-byte balance,
// so the least time is (ndiag*n + 2*m*n) * itemsize over the HBM rate.
// What the design does about that: one thread per column i loads its
// ndiag coefficients once into registers and reuses them for all m rows,
// so the diagonals cross device memory once per call; the row loop reads
// X and writes Y coalesced across the warp (neighbouring threads,
// neighbouring columns), and the re-reads of the +-1, +-N and +-N^2
// neighbours of X are meant to hit in L2. Wider loads, shared-memory
// staging of the X slab and TMA are left for later work.
//
// Interface: plain C, loaded with ctypes. Offsets arrive by value in a
// small struct; the launch goes on the caller's stream and the function
// returns cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define DIA_MAX_DIAG 16
#define DIA_THREADS 256

struct DiaOffsets {
  int count;
  int off[DIA_MAX_DIAG];
};

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(DIA_THREADS)
dia_spmm_t_kernel(const T* __restrict__ data, const T* __restrict__ x,
                  T* __restrict__ y, int n, int m, DiaOffsets offs) {
  const int i = blockIdx.x * DIA_THREADS + threadIdx.x;
  if (i >= n) return;
  // coefficients of column i, in registers for the whole row loop; a column
  // outside [0, n) gets a zero coefficient and reads column i instead, so
  // every load stays in bounds
  float coef[DIA_MAX_DIAG];
  int col[DIA_MAX_DIAG];
#pragma unroll
  for (int d = 0; d < DIA_MAX_DIAG; ++d) {
    coef[d] = 0.f;
    col[d] = i;
    if (d < offs.count) {
      const long long j = (long long)i + offs.off[d];
      if (j >= 0 && j < n) {
        coef[d] = load_f32(data + (size_t)d * n + i);
        col[d] = (int)j;
      }
    }
  }
  for (int r = 0; r < m; ++r) {
    const T* xr = x + (size_t)r * n;
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < DIA_MAX_DIAG; ++d) {
      if (d < offs.count) acc += coef[d] * load_f32(xr + col[d]);
    }
    store_f32(y + (size_t)r * n + i, acc);
  }
}

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t as int.
int dia_spmm_t_launch(int dtype, const void* data, const void* x, void* y,
                      long long n, int m, int ndiag, const int* offsets,
                      void* stream) {
  if (ndiag < 1 || ndiag > DIA_MAX_DIAG || n < 1 || n > 0x7fffffffLL || m < 1)
    return (int)cudaErrorInvalidValue;
  DiaOffsets offs;
  offs.count = ndiag;
  for (int d = 0; d < DIA_MAX_DIAG; ++d) offs.off[d] = d < ndiag ? offsets[d] : 0;
  const unsigned grid = (unsigned)((n + DIA_THREADS - 1) / DIA_THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    dia_spmm_t_kernel<float><<<grid, DIA_THREADS, 0, s>>>(
        (const float*)data, (const float*)x, (float*)y, (int)n, m, offs);
  } else if (dtype == 1) {
    dia_spmm_t_kernel<__nv_bfloat16><<<grid, DIA_THREADS, 0, s>>>(
        (const __nv_bfloat16*)data, (const __nv_bfloat16*)x, (__nv_bfloat16*)y,
        (int)n, m, offs);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* dune_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
