// Copy-rate probe for Hopper (sm_90a): the yardstick the SpMM kernels'
// GB/s are put against.
//
// Replaces experiments/pipeline_probe.py::ident_kernel (launched by
// pallas_ident and, in place, by pallas_ident_alias) and ::identd_kernel
// (launched by pallas_identd). They compute, on X (rows, width) f32:
//
//     copy_add1          Y = X + 1
//     copy_add1_inplace  X = X + 1                 (the aliased launch of
//                                                   the same kernel)
//     copy_add_row       Y = X + d[0][None, :]     d is (nd, width)
//
// What bounds them: device-memory bytes, one read and one write of X (plus
// the coefficient stream); one add per 8 bytes is far below the card's
// balance. What the design does about that: every thread moves 16 bytes per
// load and store, neighbouring threads neighbouring addresses, and issues
// four loads before its first store. The reference's "tile" (the columns
// one grid step owns) is kept as a parameter: a block owns `tile` columns
// of all rows per step and strides over the tiles, so the tile sweep of
// the reference has a counterpart. Large tiles leave fewer blocks than the
// card has SMs; that is what the sweep shows.
//
// The coefficient stream: the TPU kernel is handed the whole (nd, tile)
// block of d by its BlockSpec though it adds row 0 only, and the probe's
// purpose is the cost of that stream beside X (the DIA SpMM reads ndiag
// such rows). Here rows 1..nd-1 are loaded with `asm volatile` loads whose
// results are discarded: a volatile asm statement is never removed by the
// compiler, so the loads are issued and their bytes cross device memory.
// The result is exactly X + d[0], and the bytes to count are all nd rows.
//
// Interface: plain C for ctypes; launches go on the caller's stream and
// return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#define CP_THREADS 256
#define CP_MAX_BLOCKS_PER_SM 8

__device__ __forceinline__ float4 add1(float4 v) {
  return make_float4(v.x + 1.f, v.y + 1.f, v.z + 1.f, v.w + 1.f);
}

// a 16-byte load the compiler must issue though nothing uses its result
__device__ __forceinline__ void touch16(const float* p) {
  float a, b, c, d;
  asm volatile("ld.global.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(a), "=f"(b), "=f"(c), "=f"(d)
               : "l"(p));
}
__device__ __forceinline__ void touch4(const float* p) {
  float a;
  asm volatile("ld.global.f32 %0, [%1];" : "=f"(a) : "l"(p));
}

// element offset of the idx-th float4 of a (rows, w4 * 4) tile at column c0
__device__ __forceinline__ size_t at4(int idx, int w4, long long width, long long c0) {
  const int r = idx / w4, c = idx - r * w4;
  return (size_t)r * width + c0 + 4 * (size_t)c;
}

#define CP_UNROLL 4  // 16-byte loads in flight per thread before the first store

// Y = X + 1 over tiles of `tile` columns. VEC: width, tile and both
// pointers are multiples of 4 floats, so every access is a float4. y may be
// x (in place: each element is read and written by the same thread), so
// the pointers are not `__restrict__`, and a thread issues all loads of a
// step before its first store itself: the compiler, which must assume that
// they overlap, would not.
template <bool VEC>
__global__ void __launch_bounds__(CP_THREADS)
copy_add1_kernel(const float* x, float* y, int rows, long long width, int tile) {
  const long long ntiles = (width + tile - 1) / tile;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long c0 = t * tile;
    const int w = (int)min((long long)tile, width - c0);
    if (VEC) {
      const int w4 = w >> 2;
      const int total = rows * w4;
      for (int base = threadIdx.x; base < total; base += CP_UNROLL * CP_THREADS) {
        float4 v[CP_UNROLL];
#pragma unroll
        for (int u = 0; u < CP_UNROLL; ++u) {
          const int idx = base + u * CP_THREADS;
          if (idx < total) v[u] = *reinterpret_cast<const float4*>(x + at4(idx, w4, width, c0));
        }
#pragma unroll
        for (int u = 0; u < CP_UNROLL; ++u) {
          const int idx = base + u * CP_THREADS;
          if (idx < total) *reinterpret_cast<float4*>(y + at4(idx, w4, width, c0)) = add1(v[u]);
        }
      }
    } else {
      const int total = rows * w;
      for (int idx = threadIdx.x; idx < total; idx += CP_THREADS) {
        const int r = idx / w, c = idx - r * w;
        const size_t at = (size_t)r * width + c0 + c;
        y[at] = x[at] + 1.f;
      }
    }
  }
}

// Y = X + d[0], with rows 1..nd-1 of d loaded and discarded (see the head
// of this file).
template <bool VEC>
__global__ void __launch_bounds__(CP_THREADS)
copy_add_row_kernel(const float* __restrict__ d, const float* __restrict__ x,
                    float* __restrict__ y, int rows, long long width, int nd,
                    int tile) {
  const long long ntiles = (width + tile - 1) / tile;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long c0 = t * tile;
    const int w = (int)min((long long)tile, width - c0);
    if (VEC) {
      const int w4 = w >> 2;
      // the coefficient stream beyond row 0: (nd - 1) rows of this tile
      const int extra = (nd - 1) * w4;
      for (int idx = threadIdx.x; idx < extra; idx += CP_THREADS) {
        const int k = idx / w4, c = idx - k * w4;
        touch16(d + (size_t)(k + 1) * width + c0 + 4 * (size_t)c);
      }
      const int total = rows * w4;
      for (int base = threadIdx.x; base < total; base += CP_UNROLL * CP_THREADS) {
        float4 v[CP_UNROLL], a[CP_UNROLL];
#pragma unroll
        for (int u = 0; u < CP_UNROLL; ++u) {
          const int idx = base + u * CP_THREADS;
          if (idx < total) {
            v[u] = *reinterpret_cast<const float4*>(x + at4(idx, w4, width, c0));
            a[u] = __ldg(reinterpret_cast<const float4*>(d + c0 + 4 * (size_t)(idx % w4)));
          }
        }
#pragma unroll
        for (int u = 0; u < CP_UNROLL; ++u) {
          const int idx = base + u * CP_THREADS;
          if (idx < total)
            *reinterpret_cast<float4*>(y + at4(idx, w4, width, c0)) = make_float4(
                v[u].x + a[u].x, v[u].y + a[u].y, v[u].z + a[u].z, v[u].w + a[u].w);
        }
      }
    } else {
      const int extra = (nd - 1) * w;
      for (int idx = threadIdx.x; idx < extra; idx += CP_THREADS) {
        const int k = idx / w, c = idx - k * w;
        touch4(d + (size_t)(k + 1) * width + c0 + c);
      }
      const int total = rows * w;
      for (int idx = threadIdx.x; idx < total; idx += CP_THREADS) {
        const int r = idx / w, c = idx - r * w;
        const size_t at = (size_t)r * width + c0 + c;
        y[at] = x[at] + __ldg(d + c0 + c);
      }
    }
  }
}

static int probe_grid(long long width, int tile, unsigned* grid) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long ntiles = (width + tile - 1) / tile;
  const long long cap = (long long)sms * CP_MAX_BLOCKS_PER_SM;
  *grid = (unsigned)(ntiles < cap ? ntiles : cap);
  return 0;
}

static bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

static bool bad_shape(int rows, long long width, int tile) {
  // rows * tile must fit the kernels' int index
  return rows < 1 || width < 1 || tile < 1 ||
         (long long)rows * tile > 0x7fffffffLL;
}

extern "C" {

int copy_add1_launch(const void* x, void* y, int rows, long long width,
                     int tile, void* stream) {
  if (bad_shape(rows, width, tile) || x == y) return (int)cudaErrorInvalidValue;
  unsigned grid;
  int e = probe_grid(width, tile, &grid);
  if (e) return e;
  cudaStream_t s = (cudaStream_t)stream;
  if (width % 4 == 0 && tile % 4 == 0 && aligned16(x) && aligned16(y))
    copy_add1_kernel<true><<<grid, CP_THREADS, 0, s>>>(
        (const float*)x, (float*)y, rows, width, tile);
  else
    copy_add1_kernel<false><<<grid, CP_THREADS, 0, s>>>(
        (const float*)x, (float*)y, rows, width, tile);
  return (int)cudaGetLastError();
}

int copy_add1_inplace_launch(void* x, int rows, long long width, int tile,
                             void* stream) {
  if (bad_shape(rows, width, tile)) return (int)cudaErrorInvalidValue;
  unsigned grid;
  int e = probe_grid(width, tile, &grid);
  if (e) return e;
  cudaStream_t s = (cudaStream_t)stream;
  if (width % 4 == 0 && tile % 4 == 0 && aligned16(x))
    copy_add1_kernel<true><<<grid, CP_THREADS, 0, s>>>(
        (const float*)x, (float*)x, rows, width, tile);
  else
    copy_add1_kernel<false><<<grid, CP_THREADS, 0, s>>>(
        (const float*)x, (float*)x, rows, width, tile);
  return (int)cudaGetLastError();
}

int copy_add_row_launch(const void* d, const void* x, void* y, int rows,
                        long long width, int nd, int tile, void* stream) {
  if (bad_shape(rows, width, tile) || nd < 1 || x == y ||
      (long long)nd * tile > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  unsigned grid;
  int e = probe_grid(width, tile, &grid);
  if (e) return e;
  cudaStream_t s = (cudaStream_t)stream;
  if (width % 4 == 0 && tile % 4 == 0 && aligned16(x) && aligned16(y) && aligned16(d))
    copy_add_row_kernel<true><<<grid, CP_THREADS, 0, s>>>(
        (const float*)d, (const float*)x, (float*)y, rows, width, nd, tile);
  else
    copy_add_row_kernel<false><<<grid, CP_THREADS, 0, s>>>(
        (const float*)d, (const float*)x, (float*)y, rows, width, nd, tile);
  return (int)cudaGetLastError();
}

}  // extern "C"
