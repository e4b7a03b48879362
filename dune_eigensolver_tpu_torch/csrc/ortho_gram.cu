// The blocked orthonormalization's tall-skinny products C = Y X^T in one
// launch, for Hopper (sm_90a): ops/ortho.py's Grams and projections.
//
// Replaces no TPU kernel: the JAX package's ops/ortho.py leaves these
// products to XLA at Precision.HIGHEST. Added because cuBLAS gives an output
// of (8, 8) to (48, 24) one or a few tiles and splits the long K = n axis
// over too few blocks: at (8, 8) and (16, 8), n = 522,242, a product took
// ~135-150 us against 11-17 us of bytes at the copy rate.
//
// Y is (a, n) and X is (b, n), each row contiguous along n at any row stride
// (the block sweep's slices bufp[:k] and Xt[k:k+b]), float32. C is (a, b),
// contiguous, float32. Products of other types (the f64 Gram of
// ortho_block='full', f64 rows) stay with cuBLAS: no cell takes them.
//
// What bounds it: bytes. Each column of Y and X is read once, (a + b) values,
// for a * b FMAs: at (48, 24) 1,152 FMAs against 288 bytes a column, ~0.35 ms
// of f32 FMA against ~0.97 ms of bytes at n = 10,077,696; the smaller shapes
// have fewer FMAs still. The design keeps the card's copy engines busy and
// puts every thread on the output:
//
//   one persistent launch, as many blocks as fit on the card (at most
//   max_blocks), each walking chunks of C columns, chunk k, k + gridDim.x,
//   ...; a chunk of all a + b rows is staged in shared memory by cp.async
//   (8 or 16 bytes a copy where n, the row strides and the pointers allow it,
//   else 4; the last chunk's columns past n are zero-filled), STAGES deep, so
//   the loads of the next chunks overlap the FMAs on this one;
//
//   the output split in R x S = 8 x 8 register tiles, one warp a tile, and
//   G warps a tile where the tiles are few (G = 16 at (8, 8)), each lane one
//   column of the chunk in turn: R + S shared-memory loads for R S FMAs, the
//   lanes of a warp on adjacent columns of one row, so no bank conflicts. Rows past a or b (a partial tile) read
//   the last row again and are never stored.
//
// Arithmetic: f32 FMAs, no TF32, no tensor cores. The sums have a fixed
// order: each thread its columns in turn; the warp's lanes
// by a reduce-scatter of shuffles (at each offset a lane keeps half its
// values and adds its partner's other half: 62 shuffles for an 8 x 8 tile,
// where a butterfly a value takes 320); the G warps of a tile in order; then
// the blocks' partial sums, after a __threadfence and an atomic ticket (as in
// cg_step.cu), by the last block to finish: a warp an output, lane-strided
// and by a butterfly, where the outputs are few (at most 8 a warp: (8, 8),
// (16, 8)), else in two levels, the last block of each group of ``group``
// blocks (the caller's) adding its group's in block order and the last of
// those the groups' in group order (one block adding ~130-260 partial sums of up to 1,152
// outputs took ~40-55 us). No float atomics, so the bits repeat from run to
// run on a card (the grid is the card's own: its number of SMs and the
// blocks an SM holds).
//
// Interface: plain C, loaded with ctypes. The launch goes on the caller's
// stream and returns cudaGetLastError(). The scratch (the partial sums and
// the tickets) is the caller's, one a stream; the tickets are zero before a
// launch and the last blocks set them back to zero.

#include <cuda_runtime.h>

#include <mutex>
#include <vector>

#define OG_STAGES 3                    // chunks staged at once
#define OG_STAGE_BYTES (32 * 1024)     // the staged bytes a chunk aims at
#define OG_TILE 8                      // R = S: the side of a warp's register tile
#define OG_TARGET_WARPS 16             // a block's warps where the tiles allow it
#define OG_MAX_THREADS 640             // 8 x 8 float tiles: <= 102 registers
#define OG_ONE_LEVEL_OUTPUTS_A_WARP 8  // the most outputs a warp adds in a one-level sum

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// BYTES from gmem into smem, or zeros where !valid (src-size 0)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, bool valid) {
  const int src = valid ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(smem)),
                 "l"(gmem), "r"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(smem_u32(smem)),
                 "l"(gmem), "n"(BYTES), "r"(src)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The warp's sums of the N values v[0..N) of each lane, scattered: at offset
// O (16, 8, ..., 1) a lane keeps one half of its values and adds its
// partner's other half (one shuffle a value kept, N - N/32 shuffles in all,
// against 5 N for a butterfly a value). Returns the index of the first of
// the sums the lane holds, in v[0..max(N/32, 1)); the order of every sum is
// fixed. Unrolled at compile time, so v stays in registers.
template <int N, int O>
__device__ __forceinline__ int scatter_sum(float* v, int lane) {
  if constexpr (N > 1) {
    constexpr int H = N / 2;
    const bool up = lane & O;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = up ? v[i] : v[i + H];
      const float keep = up ? v[i + H] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    const int base = up ? H : 0;
    if constexpr (O > 1) {
      return base + scatter_sum<H, O / 2>(v, lane);
    } else {
      return base;
    }
  } else {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
    if constexpr (O > 1) {
      return scatter_sum<1, O / 2>(v, lane);
    } else {
      return 0;
    }
  }
}

struct Geom {
  const void* y;
  const void* x;
  long long ys, xs;  // row strides, elements
  long long n;
  int a, b;
  int tb;      // tiles along b
  int tiles;   // tiles of the output
  int groups;  // warps a tile (G)
  int cols;    // columns a chunk (C), a multiple of 32 G
  int levels;  // of the blocks' sum: 1 (one warp an output), or 2 (in groups)
  int group;   // blocks a group of the two-level sum
};

// Stage chunk ``k``'s columns of every row into ``sm`` (rows a + b, C
// columns): V values a copy, zeros past n. Thread t copies q = t, t +
// blockDim.x, ... of the chunk's (row, vector) pairs; its first pair and the
// step between its pairs come from the caller (no division here).
template <int V>
__device__ __forceinline__ void stage(const Geom& g, float* sm, long long k, int row, int vc,
                                      int drow, int dvc) {
  const int per_row = g.cols / V;
  const int rows = g.a + g.b;
  const long long c0 = k * g.cols;
  for (; row < rows; row += drow, vc += dvc) {
    if (vc >= per_row) {
      vc -= per_row;
      ++row;
      if (row >= rows) break;
    }
    const long long col = c0 + (long long)vc * V;
    const float* src =
        row < g.a ? (const float*)g.y + row * g.ys : (const float*)g.x + (row - g.a) * g.xs;
    const bool valid = col < g.n;  // n % V == 0: a copy lies wholly inside or past the row
    cp_async<V * 4>(sm + row * g.cols + vc * V, valid ? src + col : (const float*)g.y, valid);
  }
}

// Sums of ``ab`` values over the blocks [b0, b1) of ``src`` ([block][ab]),
// in block order, into dst[e]; the block's threads take the values in turn.
__device__ __forceinline__ void sum_blocks(const float* src, int b0, int b1, int ab, float* dst) {
  for (int e = threadIdx.x; e < ab; e += blockDim.x) {
    float v = 0;
#pragma unroll 8
    for (int b = b0; b < b1; ++b) v += __ldcg(src + (long long)b * ab + e);
    dst[e] = v;
  }
}

// Whether this block is the last of ``total`` to take a ticket from *t; the
// last sets it back to zero. Every block's writes before the call are then
// seen by the last.
__device__ __forceinline__ bool last_of(unsigned* t, unsigned total) {
  __shared__ bool last;
  __threadfence();  // this block's sums before its ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(t, 1u) == total - 1;
    if (last) {
      *t = 0;
      __threadfence();  // the other blocks' sums after their tickets
    }
  }
  __syncthreads();
  return last;
}

template <int V>
__global__ void __launch_bounds__(OG_MAX_THREADS)
ortho_gram_kernel(Geom g, float* __restrict__ out, float* __restrict__ part,
                  unsigned* __restrict__ ctl) {
  constexpr int R = OG_TILE, S = OG_TILE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = warp % g.tiles, grp = warp / g.tiles;
  const int i0 = (tile / g.tb) * R, j0 = (tile % g.tb) * S;
  const int stage_elems = (g.a + g.b) * g.cols;
  // this thread's first (row, vector) of a chunk's copies, and its step
  const int per_row = g.cols / V;
  const int row0 = threadIdx.x / per_row, vc0 = threadIdx.x % per_row;
  const int drow = blockDim.x / per_row, dvc = blockDim.x % per_row;

  float acc[R * S];
#pragma unroll
  for (int k = 0; k < R * S; ++k) acc[k] = 0;

  const long long nchunks = (g.n + g.cols - 1) / g.cols;
  const long long mine =
      blockIdx.x < nchunks ? (nchunks - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
#pragma unroll
  for (int p = 0; p < OG_STAGES - 1; ++p) {
    if (p < mine)
      stage<V>(g, sm + p * stage_elems, blockIdx.x + (long long)p * gridDim.x, row0, vc0, drow,
               dvc);
    cp_commit();
  }
  for (long long i = 0; i < mine; ++i) {
    cp_wait<OG_STAGES - 2>();  // this thread's copies of chunk i have landed
    __syncthreads();           // everyone's have, and chunk i - 1 is done with
    const long long nxt = i + OG_STAGES - 1;
    if (nxt < mine)
      stage<V>(g, sm + (int)(nxt % OG_STAGES) * stage_elems, blockIdx.x + nxt * gridDim.x, row0,
               vc0, drow, dvc);
    cp_commit();
    const float* cur = sm + (int)(i % OG_STAGES) * stage_elems;
    // a lane's columns in turn; rows past a or b read the last row again
    // (never stored)
    for (int c = grp * 32 + lane; c < g.cols; c += g.groups * 32) {
      float xv[S];
#pragma unroll
      for (int s = 0; s < S; ++s) xv[s] = cur[(g.a + min(j0 + s, g.b - 1)) * g.cols + c];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float y = cur[min(i0 + r, g.a - 1) * g.cols + c];
#pragma unroll
        for (int s = 0; s < S; ++s) acc[r * S + s] = __fmaf_rn(y, xv[s], acc[r * S + s]);
      }
    }
  }
  cp_wait<0>();
  __syncthreads();  // the stages are free: reused for the warps' sums

  // each warp's sums, then the tile's G warps in order, into part[block]
  float* red = reinterpret_cast<float*>(smem_raw);  // [warp][R * S]
  {
    const int base = scatter_sum<R * S, 16>(acc, lane);
    constexpr int kept = R * S >= 32 ? R * S / 32 : 1;
#pragma unroll
    for (int k = 0; k < kept; ++k) red[warp * (R * S) + base + k] = acc[k];
  }
  __syncthreads();
  const int ab = g.a * g.b;
  for (int e = threadIdx.x; e < ab; e += blockDim.x) {
    const int row = e / g.b, col = e - row * g.b;
    const int t = (row / R) * g.tb + col / S, k = (row % R) * S + col % S;
    float v = red[t * (R * S) + k];
    for (int w = 1; w < g.groups; ++w) v += red[(w * g.tiles + t) * (R * S) + k];
    part[(long long)blockIdx.x * ab + e] = v;
  }

  const int nb = gridDim.x;
  if (g.levels == 1) {
    // the last block to finish adds the blocks' sums, a warp an output:
    // each lane every 32nd block in turn, then a butterfly
    if (!last_of(ctl, nb)) return;
    const int warps = blockDim.x >> 5;
    for (int e = warp; e < ab; e += warps) {
      float v = 0;
#pragma unroll 4
      for (int b = lane; b < nb; b += 32) v += __ldcg(part + (long long)b * ab + e);
      v = warp_sum(v);
      if (lane == 0) out[e] = v;
    }
    return;
  }
  // two levels: the last block of each group of g.group adds its
  // group's, then the last group's adder adds the groups'
  const int group = blockIdx.x / g.group;
  const int ngroups = (nb + g.group - 1) / g.group;
  const int b0 = group * g.group, b1 = min(b0 + g.group, nb);
  if (!last_of(ctl + 1 + group, b1 - b0)) return;
  float* gsum = part + (long long)nb * ab;  // [group][ab]
  sum_blocks(part, b0, b1, ab, gsum + (long long)group * ab);
  if (!last_of(ctl, ngroups)) return;
  sum_blocks(gsum, 0, ngroups, ab, out);
}

// What a launch takes at (a, b, n): false where it refuses the shape.
struct Plan {
  int tiles, tb, groups, threads, cols, smem, blocks, levels;
};

static bool plan_of(int a, int b, long long n, int max_blocks, Plan* p) {
  if (a < 1 || b < 1 || n < 1 || max_blocks < 1) return false;
  const int ta = (a + OG_TILE - 1) / OG_TILE;
  p->tb = (b + OG_TILE - 1) / OG_TILE;
  p->tiles = ta * p->tb;
  if (p->tiles > OG_MAX_THREADS / 32) return false;
  p->groups = p->tiles >= OG_TARGET_WARPS ? 1 : OG_TARGET_WARPS / p->tiles;
  p->threads = 32 * p->tiles * p->groups;
  const int rows = a + b;
  const int per_col = 32 * p->groups;  // columns a pass of the block's lanes
  int passes = (OG_STAGE_BYTES / (rows * 4) + per_col / 2) / per_col;
  if (passes < 1) passes = 1;
  p->cols = per_col * passes;
  const long long staged = (long long)OG_STAGES * rows * p->cols * 4;
  const long long sums = (long long)(p->threads / 32) * OG_TILE * OG_TILE * 4;
  p->smem = (int)(staged > sums ? staged : sums);
  const long long chunks = (n + p->cols - 1) / p->cols;
  p->blocks = (int)(chunks < max_blocks ? chunks : max_blocks);
  // one level while a warp has few outputs to add (~1.5 us); two for more
  // (each level ~2 us: a fence, a ticket and one round of loads)
  p->levels = a * b <= OG_ONE_LEVEL_OUTPUTS_A_WARP * (p->threads / 32) ? 1 : 2;
  return true;
}

// The widest V (floats a copy, 16 bytes at most) that n, both row strides
// and both pointers allow.
static int pick_v(const void* y, long long ys, const void* x, long long xs, long long n) {
  for (int v = 4; v > 1; v /= 2) {
    const size_t align = (size_t)v * 4;
    if (n % v == 0 && ys % v == 0 && xs % v == 0 && (size_t)y % align == 0 &&
        (size_t)x % align == 0)
      return v;
  }
  return 1;
}

static const void* kernel_of(int v) {
  return v == 4 ? (const void*)ortho_gram_kernel<4>
                : v == 2 ? (const void*)ortho_gram_kernel<2> : (const void*)ortho_gram_kernel<1>;
}

// The kernel's shared memory opted in, and the blocks cut to those the card
// holds at once (the grid is persistent). The answer is kept for each
// (device, kernel, threads, shared memory), so the CUDA runtime is asked once.
struct Fit {
  int dev;
  const void* kern;
  int threads, smem, blocks;  // blocks: per SM times SMs
};

static cudaError_t fit_blocks(const void* kern, Plan* p) {
  static std::mutex lock;
  static std::vector<Fit> known;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  {
    std::lock_guard<std::mutex> hold(lock);
    for (const Fit& f : known)
      if (f.dev == dev && f.kern == kern && f.threads == p->threads && f.smem == p->smem) {
        if (p->blocks > f.blocks) p->blocks = f.blocks;
        return cudaSuccess;
      }
  }
  // the kernel opts in to all the dynamic shared memory a block may have
  // beside its static shared memory, so a later launch with less needs no
  // call (the attribute is the kernel's, not the launch's)
  int optin = 0, sms = 0, per_sm = 0;
  cudaFuncAttributes fa{};
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kern);
  if (e != cudaSuccess) return e;
  const int room = optin - (int)fa.sharedSizeBytes;
  if (p->smem > room) return cudaErrorInvalidValue;
  // a refused attribute leaves its error for the next cudaGetLastError; it
  // is cleared here, and only where no error was pending before the call
  const bool pending = cudaPeekAtLastError() != cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, room);
  if (e != cudaSuccess) {
    if (!pending) cudaGetLastError();
    return e;
  }
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, p->threads, p->smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  {
    std::lock_guard<std::mutex> hold(lock);
    known.push_back(Fit{dev, kern, p->threads, p->smem, per_sm * sms});
  }
  if (p->blocks > per_sm * sms) p->blocks = per_sm * sms;
  return cudaSuccess;
}

extern "C" {

// C (a, b) = Y X^T: Y (a, n) and X (b, n) float32, rows contiguous at row
// strides ys, xs (elements); out (a, b) contiguous float32; part holds
// a * b * (max_blocks + ceil(max_blocks / group)) floats, ctl 1 +
// ceil(max_blocks / group) uint32, zero. Returns a cudaError_t as int.
int ortho_gram_launch(const void* y, long long ys, const void* x, long long xs, int a, int b,
                      long long n, void* out, void* part, void* ctl, int max_blocks, int group,
                      void* stream) {
  Plan p;
  if (!plan_of(a, b, n, max_blocks, &p) || group < 1 || !y || !x || !out || !part || !ctl ||
      ys < n || xs < n)
    return (int)cudaErrorInvalidValue;
  const int v = pick_v(y, ys, x, xs, n);
  const cudaError_t e = fit_blocks(kernel_of(v), &p);
  if (e != cudaSuccess) return (int)e;
  const Geom g{y, x, ys, xs, n, a, b, p.tb, p.tiles, p.groups, p.cols, p.levels, group};
  cudaStream_t s = (cudaStream_t)stream;
  float *o = (float*)out, *pt = (float*)part;
  unsigned* c = (unsigned*)ctl;
  if (v == 4) ortho_gram_kernel<4><<<p.blocks, p.threads, p.smem, s>>>(g, o, pt, c);
  else if (v == 2) ortho_gram_kernel<2><<<p.blocks, p.threads, p.smem, s>>>(g, o, pt, c);
  else ortho_gram_kernel<1><<<p.blocks, p.threads, p.smem, s>>>(g, o, pt, c);
  return (int)cudaGetLastError();
}

}  // extern "C"
