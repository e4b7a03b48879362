// Variant D of the DIA staging study on the staged body, for Hopper (sm_90a).
//
// Replaces experiments/kernel_variants.py::_kernel_d (launched by spmm_d):
// a persistent block walks a contiguous chunk of tiles and keeps a rolling
// ring of DV_D_RING X tiles (left, centre, right and one in flight), so X
// crosses device memory once plus two warm-up tiles a chunk; max|off| <= T.
// With `alias` Y is written over X: a pre-pass (dia_d_save_halo) copies
// every chunk's two boundary tiles into `side` first, and the in-place
// kernel takes its halos from there, since the neighbouring block
// overwrites them. That ring is what variant D studies, and it stays. As
// for C (csrc/dia_stage_c.cu), what changes is what the first version
// (csrc/dia_variants.cu::dia_d_kernel, `spmm_d_first`) took from a port:
//   * the (ndiag, T) coefficient tile of each step is staged, two slots
//     deep, beside the ring (the reference pipelines it as a BlockSpec
//     input), and serves every row the block holds;
//   * the compute body is K1's (csrc/dia_body.cuh::stage_tile), so the
//     result is K1's bits;
//   * route 1 (n on the 16-byte grid): a producer warp, one elected lane,
//     fills ring slots and coefficient slots with bulk copies (one a row of
//     a tile, one a diagonal) on one `full` mbarrier a slot, and waits on
//     the slot's `empty` mbarrier, which each compute warp arrives on once
//     the tile is last read (tile j - 1 after step j; the coefficients of
//     step j after it): no block-wide barrier a tile. Bulk copies do not
//     zero-fill, so the compute threads store zeros over a tile's columns
//     outside [0, n) (a barrier of the compute threads alone, on such steps
//     only) and fence them to the async proxy before the slot's release;
//     the in-place halos come zero-filled from `side`. Route 2 (any other
//     n): the first version's cp.async ring, the coefficients of step j in
//     the commit group of tile j + 1, at one column a thread.
//
// What bounds it: device-memory bytes, (ndiag*n + 2*m*n) * 4 at least.
//
// Interface: plain C for ctypes; launches go on the caller's stream and
// return cudaGetLastError() (or the error of the shared-memory opt-in).

#include <cuda_runtime.h>
#include <stdint.h>

#include "dia_body.cuh"

// Block b: row group b % G, chunk b / G of tiles [t0, t1). Tile t of
// [t0 - 1, t1] is use u = t - t0 + 1 of the ring, in slot u % DV_D_RING;
// the coefficients of step j are use j - t0 of the two coefficient slots,
// which follow the ring.
template <int V, int ND, int THREADS>
__global__ void __launch_bounds__(THREADS + 32)
dia_d_bulk_kernel(const float* __restrict__ data, const float* x, float* y,
                  const float* __restrict__ side, int n, int m, int T, int rows, int G,
                  int tpc, int ntiles, int ndiag, DvOffsets offs, int alias) {
  constexpr int ring = DV_D_RING;
  __shared__ __align__(8) uint64_t xfull[ring], xempty[ring], cfull[2], cempty[2];
  const int row0 = (blockIdx.x % G) * rows;
  const int chunk = blockIdx.x / G;
  const int t0 = chunk * tpc;
  const int t1 = min(t0 + tpc, ntiles);
  const int nrows = min(rows, m - row0);
  const int slot = rows * T;
  float* const coef = dv_smem + ring * slot;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ring; ++s) {
      mbar_init(&xfull[s], 1);
      mbar_init(&xempty[s], THREADS / 32);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&cfull[s], 1);
      mbar_init(&cempty[s], THREADS / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();
  // tile t's halo comes from `side` (in place); else its columns [0, b)
  // come from x, b = 0 for a tile outside [0, n)
  auto from_side = [&](int t) { return alias && (t < t0 || t >= t1); };
  auto inside = [&](int t) {
    return t < 0 ? 0 : (int)max(0LL, min((long long)T, n - (long long)t * T));
  };

  if (threadIdx.x >= THREADS) {  // the producer warp: one lane issues every copy
    if (threadIdx.x == THREADS) {
      auto load_x = [&](int t) {
        const int u = t - t0 + 1, s = u % ring;
        if (u >= ring) mbar_wait(&xempty[s], (uint32_t)(u / ring - 1) & 1);
        float* dst = dv_smem + s * slot;
        if (from_side(t)) {
          const float* src = side + ((size_t)(2 * chunk + (t >= t1)) * m + row0) * T;
          const uint32_t bytes = (uint32_t)T * sizeof(float);
          mbar_arrive_expect_tx(&xfull[s], bytes * nrows);
          for (int r = 0; r < nrows; ++r)
            bulk_load(dst + r * T, src + (size_t)r * T, bytes, &xfull[s]);
          return;
        }
        const int b = inside(t);
        if (b == 0) {
          mbar_arrive(&xfull[s]);
          return;
        }
        const uint32_t bytes = (uint32_t)b * sizeof(float);
        const float* src = x + (size_t)row0 * n + (long long)t * T;
        mbar_arrive_expect_tx(&xfull[s], bytes * nrows);
        for (int r = 0; r < nrows; ++r)
          bulk_load(dst + r * T, src + (size_t)r * n, bytes, &xfull[s]);
      };
      auto load_coef = [&](int j) {
        const int v = j - t0, s = v & 1;
        if (v >= 2) mbar_wait(&cempty[s], (uint32_t)((v >> 1) - 1) & 1);
        const uint32_t bytes = (uint32_t)inside(j) * sizeof(float);
        mbar_arrive_expect_tx(&cfull[s], bytes * ndiag);
        for (int d = 0; d < ndiag; ++d)
          bulk_load(coef + (s * ndiag + d) * T, data + (size_t)d * n + (long long)j * T, bytes,
                    &cfull[s]);
      };
      // in the order the steps need them; each waits for its slot's release
      load_x(t0 - 1);
      load_x(t0);
      for (int j = t0; j < t1; ++j) {
        load_x(j + 1);
        load_coef(j);
      }
    }
    return;
  }
  const int tid = threadIdx.x;
  // wait for tile t; store zeros over its columns no copy filled; true if
  // it stored any
  auto arrive = [&](int t) {
    const int u = t - t0 + 1;
    mbar_wait(&xfull[u % ring], (uint32_t)(u / ring) & 1);
    const int b = inside(t);
    if (from_side(t) || b == T) return false;
    zero_outside(dv_smem + (u % ring) * slot, T, nrows, 0, b, tid, THREADS);
    return true;
  };
  for (int j = t0; j < t1; ++j) {
    bool zeros = false;
    if (j == t0) {
      zeros = arrive(t0 - 1);
      zeros = arrive(t0) || zeros;
    }
    zeros = arrive(j + 1) || zeros;  // uniform across the compute threads
    const int v = j - t0;
    mbar_wait(&cfull[v & 1], (uint32_t)(v >> 1) & 1);
    if (zeros) compute_sync(THREADS);
    // column p lies in [-T, 2T): the left, centre or right tile. Tile j of X
    // is in shared memory, so in place the store of Y's tile j is safe
    const int centre = (v + 1) % ring;
    const int left = (centre + ring - 1) % ring * slot, right = (centre + 1) % ring * slot;
    auto where = [&](int p) {
      return p < 0 ? left + p + T : (p >= T ? right + p - T : centre * slot + p);
    };
    stage_tile<V, ND, THREADS>(where, T, coef + (v & 1) * ndiag * T, y, n, T, (long long)j * T,
                               inside(j), row0, nrows, offs, tid);
    if (zeros) fence_proxy_async();  // the zeros before their slot's next bulk copy
    __syncwarp();
    if ((tid & 31) == 0) {
      mbar_arrive(&xempty[v % ring]);  // tile j - 1: read for the last time
      mbar_arrive(&cempty[v & 1]);
    }
  }
}

// Route 2: the first version's cp.async ring (one commit group a tile, the
// coefficients of step j with tile j + 1) and a block barrier a step.
template <int ND>
__global__ void __launch_bounds__(DV_THREADS)
dia_d_async_kernel(const float* __restrict__ data, const float* x, float* y,
                   const float* __restrict__ side, int n, int m, int T, int rows, int G,
                   int tpc, int ntiles, int ndiag, DvOffsets offs, int alias, int vec) {
  constexpr int ring = DV_D_RING;
  const int row0 = (blockIdx.x % G) * rows;
  const int chunk = blockIdx.x / G;
  const int t0 = chunk * tpc;
  const int t1 = min(t0 + tpc, ntiles);
  const int nrows = min(rows, m - row0);
  const int slot = rows * T;
  float* const coef = dv_smem + ring * slot;
  constexpr int ahead = ring - 3;

  // one commit group per tile, empty beyond the right halo t1
  auto load = [&](int t) {
    if (t <= t1) {
      float* dst = dv_smem + ((t - t0 + 1) % ring) * slot;
      if (alias && (t < t0 || t >= t1))
        stage(dst, side + (size_t)(2 * chunk + (t >= t1)) * m * T, T, T, row0, nrows, m, 0, T,
              true);
      else
        stage(dst, x, n, n, row0, nrows, m, (long long)t * T, T, vec);
      if (t - 1 >= t0)  // the coefficients of step t - 1
        stage(coef + ((t - 1 - t0) & 1) * ndiag * T, data, n, n, 0, ndiag, ndiag,
              (long long)(t - 1) * T, T, vec);
    }
    cp_commit();
  };

  for (int t = t0 - 1; t <= t0 + ahead; ++t) load(t);
  for (int j = t0; j < t1; ++j) {
    load(j + 1 + ahead);
    cp_wait(ahead);  // tiles up to j + 1 and the coefficients of step j have landed
    __syncthreads();
    const int centre = (j - t0 + 1) % ring;
    const int left = (centre + ring - 1) % ring * slot, right = (centre + 1) % ring * slot;
    auto where = [&](int p) {
      return p < 0 ? left + p + T : (p >= T ? right + p - T : centre * slot + p);
    };
    stage_tile<1, ND, DV_THREADS>(where, T, coef + ((j - t0) & 1) * ndiag * T, y, n, T,
                                  (long long)j * T, (int)min((long long)T, n - (long long)j * T),
                                  row0, nrows, offs, threadIdx.x);
    __syncthreads();  // before the slots of tile j - 1 and step j are refilled
  }
}

using DKernel = void (*)(const float*, const float*, float*, const float*, int, int, int, int,
                         int, int, int, int, DvOffsets, int);

template <int THREADS>
static DKernel d_bulk(int width, int ndiag) {
  if (width == 4)
    return ndiag == 5 ? &dia_d_bulk_kernel<4, 5, THREADS>
         : ndiag == 7 ? &dia_d_bulk_kernel<4, 7, THREADS> : nullptr;
  return width == 1 ? (ndiag <= 8 ? &dia_d_bulk_kernel<1, 8, THREADS>
                                  : &dia_d_bulk_kernel<1, DV_MAX_DIAG, THREADS>)
                    : nullptr;
}

static DKernel d_bulk_kernel(int width, int ndiag, int threads) {
  return threads == 512 ? d_bulk<512>(width, ndiag)
       : threads == 256 ? d_bulk<256>(width, ndiag) : nullptr;
}

static auto d_async_kernel(int ndiag) {
  return ndiag <= 8 ? &dia_d_async_kernel<8> : &dia_d_async_kernel<DV_MAX_DIAG>;
}

extern "C" {

const void* dia_d_stage_kernel(int route, int width, int ndiag, int threads) {
  if (route == 1) return (const void*)d_bulk_kernel(width, ndiag, threads);
  if (route == 2 && width == 1 && threads == DV_THREADS) return (const void*)d_async_kernel(ndiag);
  return nullptr;
}

// Variant D on the staged body. y == x asks for the in-place form and
// needs side, a buffer of ceil(ntiles / tpc) * 2 * m * T floats on 16
// bytes; T a multiple of 4 and >= max|off|. Route 1: bulk copies (n a
// multiple of 4; x, y and data on 16 bytes) with `threads` 256 or 512
// compute threads and `width` 4 (T a multiple of 128 and a stencil
// dv_stencil4 takes) or 1; route 2: cp.async, 256 threads, width 1, any n.
// Anything else is refused.
int dia_d_stage_launch(const void* data, const void* x, void* y, void* side, long long n,
                       int m, int ndiag, const int* offsets, int T, int rows, int tpc, int route,
                       int width, int threads, void* stream) {
  DvOffsets offs;
  if (dv_fill_offsets(&offs, ndiag, offsets) || n < 1 || n > 0x7fffffffLL || m < 1 ||
      T < 4 || T % 4 || rows < 1 || tpc < 1)
    return (int)cudaErrorInvalidValue;
  for (int d = 0; d < ndiag; ++d)
    if (offsets[d] > T || offsets[d] < -T) return (int)cudaErrorInvalidValue;
  const int alias = x == y;
  if (alias && (side == nullptr || !dv_aligned16(side))) return (int)cudaErrorInvalidValue;
  const int G = (m + rows - 1) / rows;
  const int ntiles = (int)((n + T - 1) / T);
  const int nchunks = (ntiles + tpc - 1) / tpc;
  const size_t bytes = ((size_t)DV_D_RING * rows * T + (size_t)2 * ndiag * T) * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 1) {
    if (n % 4 || !dv_aligned16(x) || !dv_aligned16(y) || !dv_aligned16(data) ||
        (width == 4 && (T % 128 || !dv_stencil4(ndiag, offsets))))
      return (int)cudaErrorInvalidValue;
    const DKernel kernel = d_bulk_kernel(width, ndiag, threads);
    if (kernel == nullptr) return (int)cudaErrorInvalidValue;
    int e = dv_opt_in_shared(kernel, bytes);
    if (e) return e;
    if (alias && (e = dv_save_halo(x, side, n, m, T, tpc, ntiles, nchunks, s))) return e;
    kernel<<<(unsigned)(G * nchunks), (unsigned)(threads + 32), bytes, s>>>(
        (const float*)data, (const float*)x, (float*)y, (const float*)side, (int)n, m, T, rows,
        G, tpc, ntiles, ndiag, offs, alias);
    return (int)cudaGetLastError();
  }
  if (route != 2 || width != 1 || threads != DV_THREADS) return (int)cudaErrorInvalidValue;
  auto kernel = d_async_kernel(ndiag);
  int e = dv_opt_in_shared(kernel, bytes);
  if (e) return e;
  if (alias && (e = dv_save_halo(x, side, n, m, T, tpc, ntiles, nchunks, s))) return e;
  const int vec = n % 4 == 0 && dv_aligned16(x) && dv_aligned16(data);
  kernel<<<(unsigned)(G * nchunks), DV_THREADS, bytes, s>>>(
      (const float*)data, (const float*)x, (float*)y, (const float*)side, (int)n, m, T, rows, G,
      tpc, ntiles, ndiag, offs, alias, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
