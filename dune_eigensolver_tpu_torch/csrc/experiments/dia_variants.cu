// Variant B of the DIA staging study, for Hopper (sm_90a), and the
// occupancy queries of all three variants (dia_stage_c.cu, dia_stage_d.cu).
//
// Replaces experiments/kernel_variants.py::_kernel_b (launched by spmm_b),
// the experiment that chose the TPU kernel's design. It computes the
// function of csrc/dia_spmm.cu,
//
//     Y[r, i] = sum_d data[d, i] * X[r, i + off_d],   zero outside [0, n)
//
// on X and Y contiguous (m, n) f32 and data (ndiag, n) f32, staging X into
// shared memory through a ring of `nslots` windows of width T + span + 256
// starting at fl_base = floor(min offset / 128) * 128, with `depth` windows
// in flight; a persistent block walks consecutive tiles.
//
// The ring runs on Hopper's bulk copies (dia_b_kernel): the reference runs
// it on the DMA engine (make_async_copy and DMA semaphores), its
// counterpart here is the bulk copy (TMA without a tensor map,
// bulk_copy.cuh): one thread arms the slot's mbarrier with
// the window's bytes and issues one bulk copy per row of the window's part
// inside [0, n), and the coefficient tile of the next step beside it; the
// compute threads wait on the slot's phase parity and release the slot
// with a block barrier at the end of the step. Its compute body is the
// staged one C and D run (dia_body.cuh), so that the three
// staging schemes are compared on one body. Bulk copies do not zero-fill:
// in a window that reaches outside [0, n) the compute threads write zeros
// over those columns (the data of a DIA operand may be non-zero there, and
// the function reads X as zero), then fence them to the async proxy before
// the slot's next bulk copy. Bulk copies need 16-byte addresses and sizes,
// so the bulk body needs n % 4 == 0; off that grid the launcher takes the
// ring's first version (`body` 0, dia_b_first_kernel), whose every thread
// stages 16- or 4-byte pieces with cp.async (zero-filling) and whose
// compute body, compute_tile, reads each coefficient from device memory
// once per row group and column batch, one column a thread, with a block
// barrier a tile.
//
// What differs from the TPU kernels, and why. The TPU grid runs its tiles
// in order on one core; here blocks run concurrently, so the sequential
// grid becomes a loop inside a block and the tiles are dealt out to
// blocks. A TPU core's VMEM holds an (8, 32768 + 2*2048) window; a block
// has 227 KB of shared memory, so the m rows are split over blocks (`rows`
// per block, blocks of one tile range adjacent in the grid so that the
// coefficient tile they share is read from device memory once and from L2
// after that) and the tile is 2048 or a few times that, where the halo
// re-read is a multiple of the tile instead of 12%: those re-reads are
// meant to hit in L2. The tiles are dealt out to exactly as many blocks as
// the card holds at once (dia_variant_blocks_per_sm,
// dia_stage_blocks_per_sm), since a persistent block that waits for a
// second wave costs a whole share of the run. The pre-padded (m, n + 2H)
// buffer is gone: cp.async zero-fills columns outside [0, n), and the bulk
// bodies write those zeros themselves, so X stays a plain (m, n) tensor.
//
// What bounds it: device-memory bytes, (ndiag*n + 2*m*n) * 4 at least, as
// for csrc/dia_spmm.cu. Copies are 16 bytes per cp.async when n, the
// window starts and the pointers allow it, else 4 bytes (any n works); the
// bulk body moves a window row in one bulk copy.
//
// Interface: plain C for ctypes; launches go on the caller's stream and
// return cudaGetLastError() (or the error of the shared-memory opt-in).

#include <cuda_runtime.h>
#include <stdint.h>

#include "dia_body.cuh"

// One output tile: column tile0 + c of Y for every row of the block, by a
// block of THREADS threads.
// `where(p)` is the index in dv_smem of X[row0, tile0 + p], and
// row r of the block lies r * stride further. A thread takes COLS columns at
// a time, a block stride apart; for each it loads its coefficients (ND = 8
// or 16 registers a column) and works out where its neighbours lie before
// the first product, so that COLS * ndiag loads are in flight per thread and
// the row loop is one shared-memory load and one multiply-add per term. The
// coefficients come straight from device memory, once per row group.
template <int ND, int THREADS = DV_THREADS, typename Where>
__device__ __forceinline__ void compute_tile(Where where, int stride,
                                             const float* __restrict__ data, float* y,
                                             int n, int m, int row0, int rows,
                                             long long tile0, int T, const DvOffsets& offs) {
  constexpr int COLS = ND <= 8 ? 4 : 2;
  const int ncol = (int)min((long long)T, n - tile0);
  for (int c0 = threadIdx.x; c0 < ncol; c0 += COLS * THREADS) {
    float coef[COLS][ND];
    int at[COLS][ND];
#pragma unroll
    for (int u = 0; u < COLS; ++u) {
      const int c = c0 + u * THREADS;
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        const bool live = d < offs.count && c < ncol;
        coef[u][d] = live ? __ldg(data + (size_t)d * n + tile0 + c) : 0.f;
        at[u][d] = live ? where(c + offs.off[d]) : 0;
      }
    }
    for (int r = 0; r < rows && row0 + r < m; ++r) {
      const float* xr = dv_smem + r * stride;
#pragma unroll
      for (int u = 0; u < COLS; ++u) {
        const int c = c0 + u * THREADS;
        if (c < ncol) {
          float acc = 0.f;
#pragma unroll
          for (int d = 0; d < ND; ++d)
            if (d < offs.count) acc += coef[u][d] * xr[at[u][d]];
          y[(size_t)(row0 + r) * n + tile0 + c] = acc;
        }
      }
    }
  }
}

// --- variant B: ring of nslots windows fed by bulk copies, depth in flight ---
// Block b: row group b % G, chunk b / G of tpc consecutive tiles. Window k
// of the chunk holds columns g0 .. g0 + W - 1 of X, g0 = (t0 + k) * T + lo,
// in slot k % nslots, whose barrier completes its (k / nslots)-th phase when
// the window's bytes have landed; the coefficient tile of step k lands in
// coefficient slot k % 2, one step ahead, on a barrier of its own. Thread 0
// issues every copy; every thread computes with the staged body
// (dia_body.cuh), so where the ring's shared memory leaves one block
// an SM the block takes THREADS = 512, else 256
// (experiments/kernel_variants.py::ring_geometry chooses).
template <int V, int ND, int THREADS>
__global__ void __launch_bounds__(THREADS)
dia_b_kernel(const float* __restrict__ data, const float* __restrict__ x,
             float* __restrict__ y, int n, int m, int T, int lo, int W, int rows,
             int G, int tpc, int ntiles, int nslots, int depth, int ndiag, DvOffsets offs) {
  __shared__ __align__(8) uint64_t full[DV_MAX_SLOTS], cfull[2];
  const int row0 = (blockIdx.x % G) * rows;
  const int t0 = (blockIdx.x / G) * tpc;
  const int cnt = min(tpc, ntiles - t0);
  const int nrows = min(rows, m - row0);
  const int slot = rows * W;
  float* const coef = dv_smem + nslots * slot;  // two (ndiag, T) tiles after the ring
  if (threadIdx.x == 0) {
    for (int s = 0; s < nslots; ++s) mbar_init(&full[s], 1);
    for (int s = 0; s < 2; ++s) mbar_init(&cfull[s], 1);
    mbar_init_fence();
  }
  __syncthreads();
  // the columns [a, b) of window k that lie inside [0, n)
  auto inside = [&](int k, int& a, int& b) {
    const long long g0 = (long long)(t0 + k) * T + lo;
    a = (int)min(max(-g0, 0LL), (long long)W);
    b = (int)max(min((long long)n - g0, (long long)W), (long long)a);
  };
  auto columns = [&](int k) { return (int)min((long long)T, n - (long long)(t0 + k) * T); };
  // thread 0 alone: arm the slot's barrier, one bulk copy per row
  auto fill = [&](int k) {
    int a, b;
    inside(k, a, b);
    uint64_t* bar = &full[k % nslots];
    if (b > a) {
      const uint32_t bytes = (uint32_t)(b - a) * sizeof(float);
      const float* src = x + (size_t)row0 * n + ((long long)(t0 + k) * T + lo + a);
      float* dst = dv_smem + (k % nslots) * slot + a;
      mbar_arrive_expect_tx(bar, bytes * nrows);
      for (int r = 0; r < nrows; ++r) bulk_load(dst + r * W, src + (size_t)r * n, bytes, bar);
    } else {
      mbar_arrive(bar);
    }
  };
  // thread 0 alone: the coefficient tile of step k, one bulk copy per diagonal
  auto fill_coef = [&](int k) {
    const uint32_t bytes = (uint32_t)columns(k) * sizeof(float);
    uint64_t* bar = &cfull[k & 1];
    mbar_arrive_expect_tx(bar, bytes * ndiag);
    for (int d = 0; d < ndiag; ++d)
      bulk_load(coef + ((k & 1) * ndiag + d) * T, data + (size_t)d * n + (long long)(t0 + k) * T,
                bytes, bar);
  };
  if (threadIdx.x == 0) {
    for (int k = 0; k < depth && k < cnt; ++k) fill(k);
    if (cnt > 0) fill_coef(0);
  }
  for (int k = 0; k < cnt; ++k) {
    // depth < nslots: the slot filled here was last read in step
    // k + depth - nslots < k, released by that step's closing barrier; so
    // was coefficient slot (k + 1) % 2, read in step k - 1
    if (threadIdx.x == 0) {
      if (k + depth < cnt) fill(k + depth);
      if (k + 1 < cnt) fill_coef(k + 1);
    }
    mbar_wait(&full[k % nslots], (uint32_t)(k / nslots) & 1);
    mbar_wait(&cfull[k & 1], (uint32_t)(k >> 1) & 1);
    float* win = dv_smem + (k % nslots) * slot;
    int a, b;
    inside(k, a, b);
    const bool edge = a > 0 || b < W;  // uniform across the block
    if (edge) {
      zero_outside(win, W, nrows, a, b, threadIdx.x, THREADS);
      __syncthreads();
    }
    stage_tile<V, ND, THREADS>(WindowAt{(k % nslots) * slot, lo}, W, coef + (k & 1) * ndiag * T,
                               y, n, T, (long long)(t0 + k) * T, columns(k), row0, nrows, offs,
                               threadIdx.x);
    if (edge) fence_proxy_async();  // the zeros before the slot's next bulk copy
    __syncthreads();  // every thread has read the slots: they may be refilled
  }
}

// --- variant B, first version: every thread stages with cp.async ---
// Block b: row group b % G, chunk b / G of tpc consecutive tiles.
template <int ND>
__global__ void __launch_bounds__(DV_THREADS)
dia_b_first_kernel(const float* __restrict__ data, const float* __restrict__ x,
             float* __restrict__ y, int n, int m, int T, int lo, int W, int rows,
             int G, int tpc, int ntiles, int nslots, int depth, DvOffsets offs,
             int vec) {
  const int row0 = (blockIdx.x % G) * rows;
  const int t0 = (blockIdx.x / G) * tpc;
  const int cnt = min(tpc, ntiles - t0);
  const int slot = rows * W;
  for (int k = 0; k < depth; ++k) {
    if (k < cnt)
      stage(dv_smem + (k % nslots) * slot, x, n, n, row0, rows, m,
            (long long)(t0 + k) * T + lo, W, vec);
    cp_commit();
  }
  for (int k = 0; k < cnt; ++k) {
    if (k + depth < cnt)
      stage(dv_smem + ((k + depth) % nslots) * slot, x, n, n, row0, rows, m,
            (long long)(t0 + k + depth) * T + lo, W, vec);
    cp_commit();
    cp_wait(depth);  // depth + k + 1 groups committed: group k has landed
    __syncthreads();
    compute_tile<ND>(WindowAt{(k % nslots) * slot, lo}, W, data, y, n, m, row0, rows,
                     (long long)(t0 + k) * T, T, offs);
    __syncthreads();  // depth < nslots: the slot refilled next was read last step
  }
}

// B's first version for this many diagonals
static const void* first_kernel(int ndiag) {
  return ndiag <= 8 ? (const void*)dia_b_first_kernel<8>
                    : (const void*)dia_b_first_kernel<DV_MAX_DIAG>;
}

using BKernel = void (*)(const float*, const float*, float*, int, int, int, int, int, int,
                        int, int, int, int, int, int, DvOffsets);

template <int THREADS>
static BKernel b_kernel(int width, int ndiag) {
  if (width == 4)
    return ndiag == 5 ? &dia_b_kernel<4, 5, THREADS>
         : ndiag == 7 ? &dia_b_kernel<4, 7, THREADS> : nullptr;
  return width == 1 ? (ndiag <= 8 ? &dia_b_kernel<1, 8, THREADS>
                                  : &dia_b_kernel<1, DV_MAX_DIAG, THREADS>)
                    : nullptr;
}

extern "C" {

// The staged kernels of variants C and D (dia_stage_c.cu, dia_stage_d.cu):
// route 1 the bulk copies with a producer warp beside `threads` compute
// threads, route 2 the compute threads' cp.async (256 threads, width 1).
const void* dia_c_stage_kernel(int route, int width, int ndiag, int threads);
const void* dia_d_stage_kernel(int route, int width, int ndiag, int threads);

// How many blocks of B's first version one SM holds when a block stages
// `slots` windows of `rows` rows and `window` floats: its registers and
// shared memory decide. 0: the windows exceed a block's shared memory.
// Negative: a CUDA error code, negated. The callers deal the tiles out to
// exactly as many blocks as the card holds at once, so that no block waits
// for a second wave.
int dia_variant_blocks_per_sm(int ndiag, int slots, int rows, int window) {
  if (ndiag < 1 || ndiag > DV_MAX_DIAG || slots < 1 || rows < 1 || window < 1)
    return -(int)cudaErrorInvalidValue;
  const void* kernel = first_kernel(ndiag);
  const size_t bytes = (size_t)slots * rows * window * sizeof(float);
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  int blocks = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, DV_THREADS, bytes);
  return e == cudaSuccess ? blocks : -(int)e;
}

// The same for a staged kernel (variant 0 C, 1 B, 2 D; route 1 bulk
// copies, 2 cp.async; width 4 or 1; `threads` compute threads) whose block
// takes `bytes` of dynamic shared memory.
int dia_stage_blocks_per_sm(int variant, int route, int width, int ndiag, int threads,
                            long long bytes) {
  if (ndiag < 1 || ndiag > DV_MAX_DIAG || bytes < 1) return -(int)cudaErrorInvalidValue;
  const void* kernel =
      variant == 0 ? dia_c_stage_kernel(route, width, ndiag, threads)
      : variant == 2 ? dia_d_stage_kernel(route, width, ndiag, threads)
      : variant == 1 && route == 1
          ? (threads == 512 ? (const void*)b_kernel<512>(width, ndiag)
             : threads == 256 ? (const void*)b_kernel<256>(width, ndiag) : nullptr)
      : nullptr;
  if (kernel == nullptr) return -(int)cudaErrorInvalidValue;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  // C's and D's bulk kernels run a producer warp beside the compute threads
  const int block = variant != 1 && route == 1 ? threads + 32 : threads;
  int blocks = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, block, (size_t)bytes);
  return e == cudaSuccess ? blocks : -(int)e;
}

// Variant B. lo: window start relative to the tile (fl_base <= min offset);
// W: window width (>= T + max offset - lo); tpc: tiles per chunk; body: 1
// the bulk copies and the staged body (n, T, lo, W multiples of 4, x, y and
// data on 16 bytes, else refused) with `threads` 256 or 512 a block and
// `width` 4 (T a multiple of 128 and a stencil dv_stencil4 takes) or 1; 0
// the first version (cp.async, compute_tile, any n, 256 threads, width 1).
int dia_b_launch(const void* data, const void* x, void* y, long long n, int m,
                 int ndiag, const int* offsets, int T, int lo, int W, int rows,
                 int tpc, int nslots, int depth, int body, int threads, int width,
                 void* stream) {
  DvOffsets offs;
  if (dv_fill_offsets(&offs, ndiag, offsets) || n < 1 || n > 0x7fffffffLL || m < 1 ||
      T < 1 || W < 1 || rows < 1 || tpc < 1 || x == y || depth < 1 ||
      depth >= nslots || nslots > DV_MAX_SLOTS || (body != 0 && body != 1) ||
      !(threads == DV_THREADS || (body == 1 && threads == 512)) ||
      !(width == 1 || (body == 1 && width == 4)))
    return (int)cudaErrorInvalidValue;
  for (int d = 0; d < ndiag; ++d)
    if (offsets[d] < lo || T + offsets[d] - lo > W) return (int)cudaErrorInvalidValue;
  const int G = (m + rows - 1) / rows;
  const int ntiles = (int)((n + T - 1) / T);
  const int nchunks = (ntiles + tpc - 1) / tpc;
  size_t bytes = (size_t)nslots * rows * W * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  if (body == 1) {
    if (n % 4 || T % 4 || lo % 4 || W % 4 || !dv_aligned16(x) || !dv_aligned16(y) ||
        !dv_aligned16(data) || (width == 4 && (T % 128 || !dv_stencil4(ndiag, offsets))))
      return (int)cudaErrorInvalidValue;
    bytes += (size_t)2 * ndiag * T * sizeof(float);
    const BKernel kernel = threads == 512 ? b_kernel<512>(width, ndiag)
                                          : b_kernel<256>(width, ndiag);
    if (kernel == nullptr) return (int)cudaErrorInvalidValue;
    int e = dv_opt_in_shared(kernel, bytes);
    if (e) return e;
    kernel<<<(unsigned)(G * nchunks), (unsigned)threads, bytes, s>>>(
        (const float*)data, (const float*)x, (float*)y, (int)n, m, T, lo, W, rows, G, tpc,
        ntiles, nslots, depth, ndiag, offs);
    return (int)cudaGetLastError();
  }
  auto kernel = ndiag <= 8 ? dia_b_first_kernel<8> : dia_b_first_kernel<DV_MAX_DIAG>;
  int e = dv_opt_in_shared(kernel, bytes);
  if (e) return e;
  const int vec = n % 4 == 0 && T % 4 == 0 && lo % 4 == 0 && W % 4 == 0 && dv_aligned16(x);
  kernel<<<(unsigned)(G * nchunks), DV_THREADS, bytes, s>>>(
      (const float*)data, (const float*)x, (float*)y, (int)n, m, T, lo, W, rows, G,
      tpc, ntiles, nslots, depth, offs, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
