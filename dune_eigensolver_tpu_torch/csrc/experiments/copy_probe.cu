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
// balance. The reference's "tile" (the columns one grid step owns) is kept
// as a parameter everywhere, so the tile sweep of the reference has a
// counterpart: in the first version and copy_add_row a block owns `tile`
// columns of all rows per step and strides over the tiles (large tiles
// leave fewer blocks than the card has SMs; that is what the sweep
// shows); the bulk body cuts each tile into chunks, in tile order.
//
// copy_add1 has two bodies, chosen by the launcher's `body` flag:
//   bulk  (copy_add1_bulk_kernel) each tile's rows x T block, taken
//         row-major, is cut into chunks of 16 KB, one block of the grid a
//         chunk, the grid sweeping the tiles in order. One producer thread
//         brings the chunk's row segments into shared memory with bulk
//         copies (cp.async.bulk, completed on an mbarrier), four consumer
//         warps add 1 there as float4s, fence the generic proxy against
//         the async one and arrive on a second barrier, and the producer
//         writes the chunk back with one bulk store a segment. The copy
//         engine computes the addresses, so no thread spends registers or
//         instructions on them; the twelve blocks resident on an SM (16 KB
//         each) overlap one block's store with the next blocks' loads.
//         Needs width, tile and both pointers on 16 bytes. In place, each
//         chunk's store follows its own load, so the same body serves
//         X = X + 1. (A persistent grid walking its chunks through a ring
//         of stages was no faster on the H100: PERF.md.)
//   first (copy_add1_kernel, float4 where aligned, else scalar) the first
//         version, kept to be timed in turns with the bulk body, and the
//         body off the 16-byte grid: every thread moves 16 bytes per load
//         and store and issues four loads before its first store.
//
// The coefficient stream: the TPU kernel is handed the whole (nd, tile)
// block of d by its BlockSpec though it adds row 0 only, and the probe's
// purpose is the cost of that stream beside X (the DIA SpMM reads ndiag
// such rows). Here rows 1..nd-1 are loaded and their bits folded by XOR
// into one register a thread, which is stored (to y[0]) only where it
// equals `never`, an argument whose high word the launcher sets: a 32-bit
// fold cannot equal it, but the compiler cannot know that, so every load
// stays. (The first version loaded those rows with `asm volatile` loads
// whose results nothing read: the front end kept the statements, but
// ptxas removed the loads as dead, so the kernel moved row 0 alone while
// its bytes were counted for all nd rows. The SASS check,
// experiments/pipeline_probe.py::coefficient_loads, counts the loads of
// each instantiation: the STREAM ones must have 4 more than those
// without.)
// The result is exactly X + d[0], and the bytes to count are all nd rows.
//
// Interface: plain C for ctypes; launches go on the caller's stream and
// return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

#define CP_THREADS 256
#define CP_MAX_BLOCKS_PER_SM 8

__device__ __forceinline__ float4 add1(float4 v) {
  return make_float4(v.x + 1.f, v.y + 1.f, v.z + 1.f, v.w + 1.f);
}

__device__ __forceinline__ unsigned bits4(float4 v) {
  return __float_as_uint(v.x) ^ __float_as_uint(v.y) ^ __float_as_uint(v.z) ^ __float_as_uint(v.w);
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

// Y = X + d[0]. STREAM (nd > 1): rows 1..nd-1 of the tile are loaded too,
// CP_UNROLL loads in flight a thread, streaming (they are read once), and
// folded into `seen` (see the head of this file).
template <bool VEC, bool STREAM>
__global__ void __launch_bounds__(CP_THREADS)
copy_add_row_kernel(const float* __restrict__ d, const float* __restrict__ x,
                    float* __restrict__ y, int rows, long long width, int nd,
                    int tile, unsigned long long never) {
  const long long ntiles = (width + tile - 1) / tile;
  unsigned seen = 0;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long c0 = t * tile;
    const int w = (int)min((long long)tile, width - c0);
    if (VEC) {
      const int w4 = w >> 2;
      if (STREAM) {  // the coefficient stream beyond row 0: (nd - 1) rows of this tile
        const int extra = (nd - 1) * w4;
        for (int base = threadIdx.x; base < extra; base += CP_UNROLL * CP_THREADS) {
          float4 v[CP_UNROLL];
#pragma unroll
          for (int u = 0; u < CP_UNROLL; ++u) {
            const int idx = base + u * CP_THREADS, k = idx / w4;
            if (idx < extra)
              v[u] = __ldcs(reinterpret_cast<const float4*>(
                  d + (size_t)(k + 1) * width + c0 + 4 * (size_t)(idx - k * w4)));
          }
#pragma unroll
          for (int u = 0; u < CP_UNROLL; ++u)
            if (base + u * CP_THREADS < extra) seen ^= bits4(v[u]);
        }
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
      if (STREAM) {
        const int extra = (nd - 1) * w;
        for (int base = threadIdx.x; base < extra; base += CP_UNROLL * CP_THREADS) {
          float v[CP_UNROLL];
#pragma unroll
          for (int u = 0; u < CP_UNROLL; ++u) {
            const int idx = base + u * CP_THREADS, k = idx / w;
            if (idx < extra) v[u] = __ldcs(d + (size_t)(k + 1) * width + c0 + (idx - k * w));
          }
#pragma unroll
          for (int u = 0; u < CP_UNROLL; ++u)
            if (base + u * CP_THREADS < extra) seen ^= __float_as_uint(v[u]);
        }
      }
      const int total = rows * w;
      for (int idx = threadIdx.x; idx < total; idx += CP_THREADS) {
        const int r = idx / w, c = idx - r * w;
        const size_t at = (size_t)r * width + c0 + c;
        y[at] = x[at] + __ldg(d + c0 + c);
      }
    }
  }
  if (STREAM && seen == never) y[0] = __uint_as_float(seen);  // never taken
}

// --- the bulk-copy body ----------------------------------------------------

#define ID_CHUNK_FLOATS 4096  // 16 KB a chunk
#define ID_CONSUMER_WARPS 4
#define ID_THREADS (32 * (1 + ID_CONSUMER_WARPS))

// chunks a tile: its rows x tile floats, row-major, in chunks of
// ID_CHUNK_FLOATS (the last tile, narrower, may fill fewer)
__host__ __device__ __forceinline__ long long id_chunks_per_tile(int rows, int tile) {
  return ((long long)rows * tile + ID_CHUNK_FLOATS - 1) / ID_CHUNK_FLOATS;
}

// the floats [lo, lo + n) of the rows x w block at column c0, global <->
// chunk: one bulk copy a row segment (one division a segment, none an
// element)
template <bool LOAD>
__device__ __forceinline__ void chunk_copy(float* g, long long width, long long c0, int w,
                                           int lo, int n, float* chunk, uint64_t* full) {
  if (LOAD) mbar_arrive_expect_tx(full, (uint32_t)n * 4);
  for (int f = lo; f < lo + n;) {
    const int r = f / w, c = f - r * w, seg = min(w - c, lo + n - f);
    float* at = g + (size_t)r * width + c0 + c;
    if (LOAD)
      bulk_load(chunk + (f - lo), at, (uint32_t)seg * 4, full);
    else
      bulk_store(at, chunk + (f - lo), (uint32_t)seg * 4);
    f += seg;
  }
}

// Y = X + 1 by bulk copies through shared memory (the head of this file),
// block g the chunk g % cpt of tile g / cpt; y may be x.
__global__ void __launch_bounds__(ID_THREADS)
copy_add1_bulk_kernel(const float* x, float* y, int rows, long long width, int tile) {
  __shared__ __align__(128) float chunk[ID_CHUNK_FLOATS];
  __shared__ uint64_t full, done;  // the loads landed; the consumers' +1 is in shared memory
  const long long cpt = id_chunks_per_tile(rows, tile);
  const long long t = blockIdx.x / cpt;
  const long long c0 = t * tile;
  const int w = (int)min((long long)tile, width - c0);
  const int lo = (int)(blockIdx.x - t * cpt) * ID_CHUNK_FLOATS;
  const int n = min(ID_CHUNK_FLOATS, rows * w - lo);
  if (n <= 0) return;  // a slot past the narrow last tile's chunks: the whole block
  if (threadIdx.x == 0) {
    mbar_init(&full, 1);
    mbar_init(&done, ID_CONSUMER_WARPS * 32);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x < 32) {  // the producer warp: one thread issues every copy
    if (threadIdx.x != 0) return;
    chunk_copy<true>(const_cast<float*>(x), width, c0, w, lo, n, chunk, &full);
    mbar_wait(&done, 0);
    chunk_copy<false>(y, width, c0, w, lo, n, chunk, nullptr);
    bulk_commit();
    bulk_wait<0>();  // the stores have landed before the block's memory goes
    return;
  }
  mbar_wait(&full, 0);
  float4* v = reinterpret_cast<float4*>(chunk);
  for (int i = threadIdx.x - 32; i < (n >> 2); i += ID_CONSUMER_WARPS * 32) v[i] = add1(v[i]);
  fence_proxy_async();
  mbar_arrive(&done);
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

// body: 0 the first version (float4 where width, tile and the pointers
// allow, else scalar), 1 bulk copies one chunk a block (refused off the
// 16-byte grid; the wrappers choose with pipeline_probe.copy_body)
static int launch_add1(int body, const void* x, void* y, int rows, long long width, int tile,
                       cudaStream_t s) {
  if (bad_shape(rows, width, tile) || body < 0 || body > 1) return (int)cudaErrorInvalidValue;
  const bool vec = width % 4 == 0 && tile % 4 == 0 && aligned16(x) && aligned16(y);
  unsigned grid;
  if (body == 1) {
    const long long slots = (width + tile - 1) / tile * id_chunks_per_tile(rows, tile);
    if (!vec || slots > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    copy_add1_bulk_kernel<<<(unsigned)slots, ID_THREADS, 0, s>>>((const float*)x, (float*)y,
                                                                  rows, width, tile);
    return (int)cudaGetLastError();
  }
  int e = probe_grid(width, tile, &grid);
  if (e) return e;
  if (vec)
    copy_add1_kernel<true><<<grid, CP_THREADS, 0, s>>>((const float*)x, (float*)y, rows, width,
                                                       tile);
  else
    copy_add1_kernel<false><<<grid, CP_THREADS, 0, s>>>((const float*)x, (float*)y, rows, width,
                                                        tile);
  return (int)cudaGetLastError();
}

int copy_add1_launch(int body, const void* x, void* y, int rows, long long width, int tile,
                     void* stream) {
  if (x == y) return (int)cudaErrorInvalidValue;
  return launch_add1(body, x, y, rows, width, tile, (cudaStream_t)stream);
}

int copy_add1_inplace_launch(int body, void* x, int rows, long long width, int tile,
                             void* stream) {
  return launch_add1(body, x, x, rows, width, tile, (cudaStream_t)stream);
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
  const float *dp = (const float*)d, *xp = (const float*)x;
  float* yp = (float*)y;
  const unsigned long long never = 1ULL << 32;  // no 32-bit fold equals it
  if (width % 4 == 0 && tile % 4 == 0 && aligned16(x) && aligned16(y) && aligned16(d)) {
    if (nd > 1)
      copy_add_row_kernel<true, true><<<grid, CP_THREADS, 0, s>>>(dp, xp, yp, rows, width, nd,
                                                                  tile, never);
    else
      copy_add_row_kernel<true, false><<<grid, CP_THREADS, 0, s>>>(dp, xp, yp, rows, width, nd,
                                                                   tile, never);
  } else if (nd > 1) {
    copy_add_row_kernel<false, true><<<grid, CP_THREADS, 0, s>>>(dp, xp, yp, rows, width, nd,
                                                                 tile, never);
  } else {
    copy_add_row_kernel<false, false><<<grid, CP_THREADS, 0, s>>>(dp, xp, yp, rows, width, nd,
                                                                  tile, never);
  }
  return (int)cudaGetLastError();
}

// the study library's copy of csrc/dia_spmm.cu's, read by utils/native.py::check
const char* dune_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
