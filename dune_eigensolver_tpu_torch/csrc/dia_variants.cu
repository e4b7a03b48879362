// Three ways of staging X for the tall-skinny DIA SpMM, for Hopper (sm_90a).
//
// Replace experiments/kernel_variants.py::_kernel_c (launched by spmm_c),
// ::_kernel_b (spmm_b) and ::_kernel_d (spmm_d): the experiment that chose
// the TPU kernel's design. All three compute the function of
// csrc/dia_spmm.cu,
//
//     Y[r, i] = sum_d data[d, i] * X[r, i + off_d],   zero outside [0, n)
//
// on X and Y contiguous (m, n) f32 and data (ndiag, n) f32, and differ only
// in how a block brings X into shared memory:
//
//   C  a block stages the (rows, T + 2H) window of one tile (H = the halo,
//      rounded up) into one of two slots with cp.async; the next tile's
//      window is in flight while this one is consumed. Every tile re-reads
//      its two halos.
//   B  the same through a ring of `nslots` windows of width T + span + 256
//      starting at fl_base = floor(min offset / 128) * 128, with `depth`
//      copies in flight (cp.async commit groups; wait_group(depth) hands
//      over the oldest). A persistent block walks consecutive tiles.
//   D  a persistent block walks a contiguous chunk of tiles and keeps a
//      rolling cache of X tiles (left, centre, right, and those being
//      fetched ahead): each step asks for one new right-hand tile, so X
//      crosses device memory once plus two warm-up tiles per chunk. Needs
//      max|off| <= T. With `alias` Y is written over X.
//
// What differs from the TPU kernels, and why. The TPU grid runs its tiles
// in order on one core; here blocks run concurrently, so the sequential
// grid becomes a loop inside a block and the tiles are dealt out to
// blocks. A TPU core's VMEM holds an (8, 32768 + 2*2048) window; a block
// has 227 KB of shared memory, so the m rows are split over blocks (`rows`
// per block, blocks of one tile range adjacent in the grid so that the
// coefficient tile they share is read from device memory once and from L2
// after that) and T is 2048, where the halo re-read of C and B is a
// multiple of the tile instead of 12%: those re-reads are meant to hit in
// L2. The tiles are dealt out to exactly as many blocks as the card holds
// at once (dia_variant_blocks_per_sm), since a persistent block that waits
// for a second wave costs a whole share of the run. The pre-padded (m, n + 2H) buffer is gone: cp.async zero-fills
// columns outside [0, n), so X stays a plain (m, n) tensor. In place (D):
// on the TPU tile j-1 is written after tile j was read because the grid is
// sequential; here the tile next to a chunk is overwritten by the
// neighbouring block while this one still needs its old values, so a
// pre-pass (dia_d_save_halo) copies every chunk's two boundary tiles into a
// side buffer and the in-place kernel takes its halos from there.
//
// What bounds them: device-memory bytes, (ndiag*n + 2*m*n) * 4 at least,
// as for csrc/dia_spmm.cu. Copies are 16 bytes per cp.async when n, the
// window starts and the pointers allow it, else 4 bytes (any n works).
//
// Interface: plain C for ctypes; launches go on the caller's stream and
// return cudaGetLastError() (or the error of the shared-memory opt-in).

#include <cuda_runtime.h>
#include <stdint.h>

#define DV_MAX_DIAG 16
#define DV_THREADS 256
#define DV_MAX_SLOTS 4
#define DV_D_RING 4  // tiles of X a block of variant D holds

struct DvOffsets {
  int count;
  int off[DV_MAX_DIAG];
};

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

extern __shared__ __align__(16) float dv_smem[];

// One output tile: column tile0 + c of Y for every row of the block.
// `where(c, off)` is the index in dv_smem of X[row0, tile0 + c + off], and
// row r of the block lies r * stride further. A thread takes COLS columns at
// a time, a block stride apart; for each it loads its coefficients (ND = 8
// or 16 registers a column) and works out where its neighbours lie before
// the first product, so that COLS * ndiag loads are in flight per thread and
// the row loop is one shared-memory load and one multiply-add per term. The
// coefficients come straight from device memory, once per row group.
template <int ND, typename Where>
__device__ __forceinline__ void compute_tile(Where where, int stride,
                                             const float* __restrict__ data, float* y,
                                             int n, int m, int row0, int rows,
                                             long long tile0, int T, const DvOffsets& offs) {
  constexpr int COLS = ND <= 8 ? 4 : 2;
  const int ncol = (int)min((long long)T, n - tile0);
  for (int c0 = threadIdx.x; c0 < ncol; c0 += COLS * DV_THREADS) {
    float coef[COLS][ND];
    int at[COLS][ND];
#pragma unroll
    for (int u = 0; u < COLS; ++u) {
      const int c = c0 + u * DV_THREADS;
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        const bool live = d < offs.count && c < ncol;
        coef[u][d] = live ? __ldg(data + (size_t)d * n + tile0 + c) : 0.f;
        at[u][d] = live ? where(c, offs.off[d]) : 0;
      }
    }
    for (int r = 0; r < rows && row0 + r < m; ++r) {
      const float* xr = dv_smem + r * stride;
#pragma unroll
      for (int u = 0; u < COLS; ++u) {
        const int c = c0 + u * DV_THREADS;
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

// `where` of a staged window of width W that starts `base` floats into
// dv_smem and whose column 0 is column tile0 + lo of X
struct WindowAt {
  int base, lo;
  __device__ __forceinline__ int operator()(int c, int off) const {
    return base + c + off - lo;
  }
};

// --- variant C: two slots, the window T + 2H re-read for every tile ---
// Block b: row group b % G, walker b / G over tiles walker, walker + nwalk, ...
template <int ND>
__global__ void __launch_bounds__(DV_THREADS)
dia_c_kernel(const float* __restrict__ data, const float* __restrict__ x,
             float* __restrict__ y, int n, int m, int T, int H, int rows, int G,
             int nwalk, int ntiles, DvOffsets offs, int vec) {
  const int row0 = (blockIdx.x % G) * rows;
  const int walker = blockIdx.x / G;
  const int W = T + 2 * H;
  const int slot = rows * W;
  if (walker < ntiles)
    stage(dv_smem, x, n, n, row0, rows, m, (long long)walker * T - H, W, vec);
  cp_commit();
  int k = 0;
  for (int t = walker; t < ntiles; t += nwalk, ++k) {
    const int next = t + nwalk;
    if (next < ntiles)
      stage(dv_smem + ((k + 1) & 1) * slot, x, n, n, row0, rows, m,
            (long long)next * T - H, W, vec);
    cp_commit();  // an empty group when there is no next tile
    cp_wait(1);
    __syncthreads();
    compute_tile<ND>(WindowAt{(k & 1) * slot, -H}, W, data, y, n, m, row0, rows,
                     (long long)t * T, T, offs);
    __syncthreads();  // before the next step's copy lands in this slot
  }
}

// --- variant B: ring of nslots windows, depth copies in flight ---
// Block b: row group b % G, chunk b / G of tpc consecutive tiles.
template <int ND>
__global__ void __launch_bounds__(DV_THREADS)
dia_b_kernel(const float* __restrict__ data, const float* __restrict__ x,
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

// --- variant D: rolling cache of X tiles, optionally in place ---
// Tile t of chunk [t0, t1) lives in ring slot (t - t0 + 1) % DV_D_RING. Step
// j reads tiles j - 1, j, j + 1 and asks for tile j + 2, which takes the slot
// of tile j - 2: one tile is in flight ahead of the three in use. (Rings of 6
// and 8 tiles were timed on the H100: 6 ties with 4, 8 leaves one block per
// SM and loses.)
// x and y may be one buffer (alias): then the halos t0 - 1 and t1 come from
// `side`, (nchunks, 2, m, T), filled by dia_d_save_halo before this kernel.
template <int ND>
__global__ void __launch_bounds__(DV_THREADS)
dia_d_kernel(const float* __restrict__ data, const float* x, float* y,
             const float* __restrict__ side, int n, int m, int T, int rows, int G,
             int tpc, int ntiles, DvOffsets offs, int alias, int vec) {
  constexpr int ring = DV_D_RING;
  const int row0 = (blockIdx.x % G) * rows;
  const int chunk = blockIdx.x / G;
  const int t0 = chunk * tpc;
  const int t1 = min(t0 + tpc, ntiles);
  const int slot = rows * T;
  constexpr int ahead = ring - 3;

  // one commit group per tile, empty beyond the right halo t1
  auto load = [&](int t) {
    if (t <= t1) {
      float* dst = dv_smem + ((t - t0 + 1) % ring) * slot;
      if (alias && (t < t0 || t >= t1))
        stage(dst, side + (size_t)(2 * chunk + (t >= t1)) * m * T, T, T, row0, rows,
              m, 0, T, true);
      else
        stage(dst, x, n, n, row0, rows, m, (long long)t * T, T, vec);
    }
    cp_commit();
  };

  for (int t = t0 - 1; t <= t0 + ahead; ++t) load(t);
  for (int j = t0; j < t1; ++j) {
    load(j + 1 + ahead);
    cp_wait(ahead);  // tiles up to j + 1 have landed
    __syncthreads();
    // column c + off lies in [-T, 2T): the left, centre or right tile. Tile
    // j of X is in shared memory, so in place the store of Y's tile j is safe
    const int centre = (j - t0 + 1) % ring;
    const int left = (centre + ring - 1) % ring * slot, right = (centre + 1) % ring * slot;
    auto where = [&](int c, int off) {
      const int p = c + off;
      return p < 0 ? left + p + T : (p >= T ? right + p - T : centre * slot + p);
    };
    compute_tile<ND>(where, T, data, y, n, m, row0, rows, (long long)j * T, T, offs);
    __syncthreads();  // before the slot of tile j - 1 is refilled
  }
}

// side[chunk][which][r][c] = X[r, tile * T + c] (zero outside [0, n)) for
// tile = t0 - 1 (which = 0) and t1 (which = 1) of every chunk.
__global__ void __launch_bounds__(DV_THREADS)
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

static bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

static int fill_offsets(DvOffsets* offs, int ndiag, const int* offsets) {
  if (ndiag < 1 || ndiag > DV_MAX_DIAG) return 1;
  offs->count = ndiag;
  for (int d = 0; d < DV_MAX_DIAG; ++d) offs->off[d] = d < ndiag ? offsets[d] : 0;
  return 0;
}

// Allow `bytes` of dynamic shared memory. A refusal (more than a block may
// have) is returned and cleared, so that it is not found again by the next
// launch's cudaGetLastError().
template <typename K>
static int opt_in_shared(K kernel, size_t bytes) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

// the kernel of variant 0 (C), 1 (B) or 2 (D) for this many diagonals
static const void* variant_kernel(int variant, int ndiag) {
  const bool small = ndiag <= 8;
  switch (variant) {
    case 0: return small ? (const void*)dia_c_kernel<8> : (const void*)dia_c_kernel<DV_MAX_DIAG>;
    case 1: return small ? (const void*)dia_b_kernel<8> : (const void*)dia_b_kernel<DV_MAX_DIAG>;
    case 2: return small ? (const void*)dia_d_kernel<8> : (const void*)dia_d_kernel<DV_MAX_DIAG>;
    default: return nullptr;
  }
}

extern "C" {

// How many blocks of a variant one SM holds when a block stages `slots`
// windows of `rows` rows and `window` floats: its registers and shared
// memory decide. 0: the windows exceed a block's shared memory. Negative: a
// CUDA error code, negated. The callers deal the tiles out to exactly as
// many blocks as the card holds at once, so that no block waits for a
// second wave.
int dia_variant_blocks_per_sm(int variant, int ndiag, int slots, int rows, int window) {
  const void* kernel = variant_kernel(variant, ndiag);
  if (kernel == nullptr || ndiag < 1 || ndiag > DV_MAX_DIAG || slots < 1 || rows < 1 ||
      window < 1)
    return -(int)cudaErrorInvalidValue;
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

// Variant C. H: halo rounded up by the caller (>= max|off|, multiple of 4);
// rows: rows of X per block; nwalk: walkers per row group.
int dia_c_launch(const void* data, const void* x, void* y, long long n, int m,
                 int ndiag, const int* offsets, int T, int H, int rows, int nwalk,
                 void* stream) {
  DvOffsets offs;
  if (fill_offsets(&offs, ndiag, offsets) || n < 1 || n > 0x7fffffffLL || m < 1 ||
      T < 1 || H < 0 || rows < 1 || nwalk < 1 || x == y)
    return (int)cudaErrorInvalidValue;
  for (int d = 0; d < ndiag; ++d)
    if (offsets[d] > H || offsets[d] < -H) return (int)cudaErrorInvalidValue;
  const int G = (m + rows - 1) / rows;
  const int ntiles = (int)((n + T - 1) / T);
  const size_t bytes = (size_t)2 * rows * (T + 2 * H) * sizeof(float);
  auto kernel = ndiag <= 8 ? dia_c_kernel<8> : dia_c_kernel<DV_MAX_DIAG>;
  int e = opt_in_shared(kernel, bytes);
  if (e) return e;
  const int vec = n % 4 == 0 && T % 4 == 0 && H % 4 == 0 && aligned16(x);
  kernel<<<(unsigned)(G * nwalk), DV_THREADS, bytes, (cudaStream_t)stream>>>(
      (const float*)data, (const float*)x, (float*)y, (int)n, m, T, H, rows, G,
      nwalk, ntiles, offs, vec);
  return (int)cudaGetLastError();
}

// Variant B. lo: window start relative to the tile (fl_base <= min offset);
// W: window width (>= T + max offset - lo); tpc: tiles per chunk.
int dia_b_launch(const void* data, const void* x, void* y, long long n, int m,
                 int ndiag, const int* offsets, int T, int lo, int W, int rows,
                 int tpc, int nslots, int depth, void* stream) {
  DvOffsets offs;
  if (fill_offsets(&offs, ndiag, offsets) || n < 1 || n > 0x7fffffffLL || m < 1 ||
      T < 1 || W < 1 || rows < 1 || tpc < 1 || x == y || depth < 1 ||
      depth >= nslots || nslots > DV_MAX_SLOTS)
    return (int)cudaErrorInvalidValue;
  for (int d = 0; d < ndiag; ++d)
    if (offsets[d] < lo || T + offsets[d] - lo > W) return (int)cudaErrorInvalidValue;
  const int G = (m + rows - 1) / rows;
  const int ntiles = (int)((n + T - 1) / T);
  const int nchunks = (ntiles + tpc - 1) / tpc;
  const size_t bytes = (size_t)nslots * rows * W * sizeof(float);
  auto kernel = ndiag <= 8 ? dia_b_kernel<8> : dia_b_kernel<DV_MAX_DIAG>;
  int e = opt_in_shared(kernel, bytes);
  if (e) return e;
  const int vec = n % 4 == 0 && T % 4 == 0 && lo % 4 == 0 && W % 4 == 0 && aligned16(x);
  kernel<<<(unsigned)(G * nchunks), DV_THREADS, bytes, (cudaStream_t)stream>>>(
      (const float*)data, (const float*)x, (float*)y, (int)n, m, T, lo, W, rows, G,
      tpc, ntiles, nslots, depth, offs, vec);
  return (int)cudaGetLastError();
}

// Variant D. y == x asks for the in-place form and needs side, a buffer of
// ceil(ntiles / tpc) * 2 * m * T floats, 16-byte aligned; T a multiple of 4
// and >= max|off|.
int dia_d_launch(const void* data, const void* x, void* y, void* side, long long n,
                 int m, int ndiag, const int* offsets, int T, int rows, int tpc,
                 void* stream) {
  DvOffsets offs;
  if (fill_offsets(&offs, ndiag, offsets) || n < 1 || n > 0x7fffffffLL || m < 1 ||
      T < 4 || T % 4 || rows < 1 || tpc < 1)
    return (int)cudaErrorInvalidValue;
  for (int d = 0; d < ndiag; ++d)
    if (offsets[d] > T || offsets[d] < -T) return (int)cudaErrorInvalidValue;
  const int alias = x == y;
  if (alias && (side == nullptr || !aligned16(side))) return (int)cudaErrorInvalidValue;
  const int G = (m + rows - 1) / rows;
  const int ntiles = (int)((n + T - 1) / T);
  const int nchunks = (ntiles + tpc - 1) / tpc;
  const size_t bytes = (size_t)DV_D_RING * rows * T * sizeof(float);
  auto kernel = ndiag <= 8 ? dia_d_kernel<8> : dia_d_kernel<DV_MAX_DIAG>;
  int e = opt_in_shared(kernel, bytes);
  if (e) return e;
  cudaStream_t s = (cudaStream_t)stream;
  if (alias) {
    dia_d_save_halo<<<dim3(2 * nchunks, m), DV_THREADS, 0, s>>>(
        (const float*)x, (float*)side, (int)n, m, T, tpc, ntiles);
    e = (int)cudaGetLastError();
    if (e) return e;
  }
  const int vec = n % 4 == 0 && aligned16(x);
  kernel<<<(unsigned)(G * nchunks), DV_THREADS, bytes, s>>>(
      (const float*)data, (const float*)x, (float*)y, (const float*)side, (int)n, m,
      T, rows, G, tpc, ntiles, offs, alias, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
