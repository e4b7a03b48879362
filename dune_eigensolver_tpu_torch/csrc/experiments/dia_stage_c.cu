// Variant C of the DIA staging study on the staged body, for Hopper (sm_90a).
//
// Replaces experiments/kernel_variants.py::_kernel_c (launched by spmm_c):
// a block stages the (rows, T + 2H) window of X around each of its tiles
// (H the halo, rounded up) into one of two slots, the next tile's window in
// flight while this one is consumed, so every tile re-reads its two halos.
// That re-read is what variant C studies, and it stays. What this source
// changes is everything else, which the first version (since
// deleted once this body had beaten it on the card) took from a port and
// not from the reference, whose _kernel_c applies the pipelined (ndiag, T)
// coefficient tile to all rows of the window at once:
//   * the tile's coefficients are staged with its window, into the same
//     slot, and serve every row the block holds (the first version read
//     them from device memory once per row group and per column batch,
//     a dependent round trip before the first product);
//   * the compute body is K1's (dia_body.cuh::stage_tile: 4 columns a
//     thread as 16-byte loads, +-1 neighbours by shuffle, two rows in
//     flight, one FMA chain in offset order), so the result is K1's bits;
//   * the staging is off the compute threads. Route 1 (n on the 16-byte
//     grid): a producer warp beside the compute threads, one elected lane,
//     fills each slot with one bulk copy a row of the window's part inside
//     [0, n) and one a diagonal, counted on the slot's `full` mbarrier; the
//     compute warps wait on its phase parity and each releases the slot by
//     one arrival on its `empty` mbarrier, which the producer waits on
//     before the slot's next copy: no block-wide barrier a tile. Bulk copies
//     do not zero-fill, so the compute threads store zeros over the window
//     columns outside [0, n) (a barrier of the compute threads alone, on
//     such windows only) and fence them to the async proxy before the
//     slot's release. Route 2 (any other n): the compute threads stage
//     window and coefficients with cp.async (zero-filling), as the first
//     version does, and the body runs at one column a thread.
//
// What bounds it: device-memory bytes, (ndiag*n + 2*m*n) * 4 at least; the
// window's halos (2H of every T columns) are meant to come from L2.
//
// Interface: plain C for ctypes; launches go on the caller's stream and
// return cudaGetLastError() (or the error of the shared-memory opt-in).

#include <cuda_runtime.h>
#include <stdint.h>

#include "dia_body.cuh"

// Block b: row group b % G, walker b / G over tiles walker, walker + nwalk,
// ...; its k-th tile in slot k % 2: the window (rows, W = T + 2H) and, after
// both windows, the coefficients (ndiag, T).
template <int V, int ND, int THREADS>
__global__ void __launch_bounds__(THREADS + 32)
dia_c_bulk_kernel(const float* __restrict__ data, const float* __restrict__ x,
                  float* __restrict__ y, int n, int m, int T, int H, int rows, int G,
                  int nwalk, int ntiles, int ndiag, DvOffsets offs) {
  __shared__ __align__(8) uint64_t full[2], empty[2];
  const int row0 = (blockIdx.x % G) * rows;
  const int walker = blockIdx.x / G;
  const int nrows = min(rows, m - row0);
  const int W = T + 2 * H;
  const int slot = rows * W;
  float* const coef = dv_smem + 2 * slot;
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], THREADS / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();
  // the columns [a, b) of tile t's window that lie inside [0, n)
  auto inside = [&](int t, int& a, int& b) {
    const long long g0 = (long long)t * T - H;
    a = (int)min(max(-g0, 0LL), (long long)W);
    b = (int)max(min((long long)n - g0, (long long)W), (long long)a);
  };
  auto columns = [&](int t) { return (int)min((long long)T, n - (long long)t * T); };

  if (threadIdx.x >= THREADS) {  // the producer warp: one lane issues every copy
    if (threadIdx.x == THREADS) {
      int k = 0;
      for (int t = walker; t < ntiles; t += nwalk, ++k) {
        const int s = k & 1;
        if (k >= 2) mbar_wait(&empty[s], (uint32_t)((k >> 1) - 1) & 1);
        int a, b;
        inside(t, a, b);
        const uint32_t wbytes = (uint32_t)(b - a) * sizeof(float);
        const uint32_t cbytes = (uint32_t)columns(t) * sizeof(float);
        mbar_arrive_expect_tx(&full[s], wbytes * nrows + cbytes * ndiag);
        const float* src = x + (size_t)row0 * n + ((long long)t * T - H + a);
        float* dst = dv_smem + s * slot + a;
        for (int r = 0; r < nrows; ++r)
          bulk_load(dst + r * W, src + (size_t)r * n, wbytes, &full[s]);
        for (int d = 0; d < ndiag; ++d)
          bulk_load(coef + (s * ndiag + d) * T, data + (size_t)d * n + (long long)t * T, cbytes,
                    &full[s]);
      }
    }
    return;
  }
  const int tid = threadIdx.x;
  int k = 0;
  for (int t = walker; t < ntiles; t += nwalk, ++k) {
    const int s = k & 1;
    mbar_wait(&full[s], (uint32_t)(k >> 1) & 1);
    int a, b;
    inside(t, a, b);
    const bool edge = a > 0 || b < W;  // uniform across the compute threads
    if (edge) {
      zero_outside(dv_smem + s * slot, W, nrows, a, b, tid, THREADS);
      compute_sync(THREADS);
    }
    stage_tile<V, ND, THREADS>(WindowAt{s * slot, -H}, W, coef + s * ndiag * T, y, n, T,
                               (long long)t * T, columns(t), row0, nrows, offs, tid);
    if (edge) fence_proxy_async();  // the zeros before the slot's next bulk copy
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(&empty[s]);
  }
}

// Route 2: the compute threads stage with cp.async into the same layout,
// one commit group a tile, and a block barrier releases each slot.
template <int ND>
__global__ void __launch_bounds__(DV_THREADS)
dia_c_async_kernel(const float* __restrict__ data, const float* __restrict__ x,
                   float* __restrict__ y, int n, int m, int T, int H, int rows, int G,
                   int nwalk, int ntiles, int ndiag, DvOffsets offs, int vec) {
  const int row0 = (blockIdx.x % G) * rows;
  const int walker = blockIdx.x / G;
  const int nrows = min(rows, m - row0);
  const int W = T + 2 * H;
  const int slot = rows * W;
  float* const coef = dv_smem + 2 * slot;
  auto load = [&](int t, int s) {
    stage(dv_smem + s * slot, x, n, n, row0, nrows, m, (long long)t * T - H, W, vec);
    stage(coef + s * ndiag * T, data, n, n, 0, ndiag, ndiag, (long long)t * T, T, vec);
  };
  if (walker < ntiles) load(walker, 0);
  cp_commit();
  int k = 0;
  for (int t = walker; t < ntiles; t += nwalk, ++k) {
    const int s = k & 1;
    if (t + nwalk < ntiles) load(t + nwalk, s ^ 1);
    cp_commit();  // an empty group when there is no next tile
    cp_wait(1);
    __syncthreads();
    stage_tile<1, ND, DV_THREADS>(WindowAt{s * slot, -H}, W, coef + s * ndiag * T, y, n, T,
                                  (long long)t * T, (int)min((long long)T, n - (long long)t * T),
                                  row0, nrows, offs, threadIdx.x);
    __syncthreads();  // before the next step's copy lands in this slot
  }
}

using CKernel = void (*)(const float*, const float*, float*, int, int, int, int, int, int, int,
                         int, int, DvOffsets);

template <int THREADS>
static CKernel c_bulk(int width, int ndiag) {
  if (width == 4)
    return ndiag == 5 ? &dia_c_bulk_kernel<4, 5, THREADS>
         : ndiag == 7 ? &dia_c_bulk_kernel<4, 7, THREADS> : nullptr;
  return width == 1 ? (ndiag <= 8 ? &dia_c_bulk_kernel<1, 8, THREADS>
                                  : &dia_c_bulk_kernel<1, DV_MAX_DIAG, THREADS>)
                    : nullptr;
}

static CKernel c_bulk_kernel(int width, int ndiag, int threads) {
  return threads == 512 ? c_bulk<512>(width, ndiag)
       : threads == 256 ? c_bulk<256>(width, ndiag) : nullptr;
}

static auto c_async_kernel(int ndiag) {
  return ndiag <= 8 ? &dia_c_async_kernel<8> : &dia_c_async_kernel<DV_MAX_DIAG>;
}

extern "C" {

const void* dia_c_stage_kernel(int route, int width, int ndiag, int threads) {
  if (route == 1) return (const void*)c_bulk_kernel(width, ndiag, threads);
  if (route == 2 && width == 1 && threads == DV_THREADS) return (const void*)c_async_kernel(ndiag);
  return nullptr;
}

// Variant C on the staged body. H: halo rounded up by the caller (>=
// max|off|, multiple of 4); rows: rows of X per block; nwalk: walkers per
// row group; route 1: bulk copies (n, T, H multiples of 4, x, y and data on
// 16 bytes) with `threads` 256 or 512 compute threads and `width` 4 (T a
// multiple of 128 and a stencil dv_stencil4 takes) or 1; route 2: cp.async,
// 256 threads, width 1, any n. Anything else is refused.
int dia_c_stage_launch(const void* data, const void* x, void* y, long long n, int m,
                       int ndiag, const int* offsets, int T, int H, int rows, int nwalk,
                       int route, int width, int threads, void* stream) {
  DvOffsets offs;
  if (dv_fill_offsets(&offs, ndiag, offsets) || n < 1 || n > 0x7fffffffLL || m < 1 ||
      T < 4 || T % 4 || H < 0 || H % 4 || rows < 1 || nwalk < 1 || x == y)
    return (int)cudaErrorInvalidValue;
  for (int d = 0; d < ndiag; ++d)
    if (offsets[d] > H || offsets[d] < -H) return (int)cudaErrorInvalidValue;
  const int G = (m + rows - 1) / rows;
  const int ntiles = (int)((n + T - 1) / T);
  const size_t bytes = ((size_t)2 * rows * (T + 2 * H) + (size_t)2 * ndiag * T) * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 1) {
    if (n % 4 || !dv_aligned16(x) || !dv_aligned16(y) || !dv_aligned16(data) ||
        (width == 4 && (T % 128 || !dv_stencil4(ndiag, offsets))))
      return (int)cudaErrorInvalidValue;
    const CKernel kernel = c_bulk_kernel(width, ndiag, threads);
    if (kernel == nullptr) return (int)cudaErrorInvalidValue;
    int e = dv_opt_in_shared(kernel, bytes);
    if (e) return e;
    kernel<<<(unsigned)(G * nwalk), (unsigned)(threads + 32), bytes, s>>>(
        (const float*)data, (const float*)x, (float*)y, (int)n, m, T, H, rows, G, nwalk, ntiles,
        ndiag, offs);
    return (int)cudaGetLastError();
  }
  if (route != 2 || width != 1 || threads != DV_THREADS) return (int)cudaErrorInvalidValue;
  auto kernel = c_async_kernel(ndiag);
  int e = dv_opt_in_shared(kernel, bytes);
  if (e) return e;
  const int vec = n % 4 == 0 && dv_aligned16(x) && dv_aligned16(data);
  kernel<<<(unsigned)(G * nwalk), DV_THREADS, bytes, s>>>(
      (const float*)data, (const float*)x, (float*)y, (int)n, m, T, H, rows, G, nwalk, ntiles,
      ndiag, offs, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
