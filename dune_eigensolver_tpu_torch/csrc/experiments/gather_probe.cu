// Gather and run-time indexing probes for Hopper (sm_90a): the forms a
// redesign of the ELL and BSR SpMMs (csrc/ell_spmm.cu, csrc/bsr_spmm.cu)
// can choose from.
//
// Replaces the eleven probes of experiments/mosaic_gather_probe.py, which
// ask the TPU toolchain which in-kernel gathers and dynamic indexings it
// lowers at all. Here every one of them is expressible; the probes check
// that each form is right and the timing table says what each costs
// against a copy. Same functions, same shapes, in the form a GPU kernel
// would use:
//
//   gather_lanes   out[r, c] = x[r, seg(c) + idx[r, c]], idx in [0, seg)
//                  a gather along the row within segments of `seg` columns
//                  (seg = 128 is the TPU's one-vreg gather). Three forms:
//                  SMEM   a block stages its columns in shared memory and
//                         reads smem[idx];
//                  SHFL   seg = 128 only: a warp holds a segment in four
//                         registers a lane and answers with four
//                         __shfl_sync rounds an output;
//                  GLOBAL each thread reads x through L1/L2 directly (what
//                         the shipped kernels do).
//                  With int8 indices (widened in registers) it is the
//                  probe int8_gather_idx.
//                  (probes gather_1vreg_8x128, gather_2sublane_16x128,
//                  gather_2lane_8x256, int8_gather_idx)
//   block_select   out = block p of x, p read from device memory by the
//                  kernel (__ldg): either through a shared-memory scratch
//                  (dyn_scratch_load_3d), or straight from device memory at
//                  the run-time offset (dyn_input_load_3d,
//                  dyn_lane_slice_aligned, vmem_scalar_index: the strides
//                  say which). The scratch form stages block p alone: the
//                  TPU kernel stages all nb blocks only because its
//                  BlockSpec fixes at trace time which block lands in VMEM,
//                  while Hopper's bulk copy takes a source address computed
//                  at run time, so the index lives in the copy itself
//                  (block_select_bulk_kernel: a persistent grid sized by
//                  occupancy that sweeps the output in chunks of 16 KB,
//                  each block's chunks moved through a ring of BS_STAGES
//                  stages by one thread: bulk loads of block p's row
//                  segments completed on the stage's mbarrier, one bulk
//                  store a stage, a stage refilled once its store has read
//                  it, so one stage's store overlaps the next stages'
//                  loads). Off the 16-byte grid the wrapper takes the
//                  straight form's row copy instead. The straight form is
//                  a copy of `rows` runs of bw floats: one block of the
//                  grid a (chunk of a row, row), float4 moves where the
//                  addresses and strides allow, four moves in flight a
//                  thread (slice_rows_launch).
//   roll_lanes     out[r, c] = x[r, seg(c) + (c + s) mod seg], s read from
//                  device memory; through shared memory (dyn_roll_lane).
//   gather_axis0   out[r, c] = x[idx[r, c], c]: a gather across rows
//                  (gather_sublane_axis0). Where every row segment lies on
//                  16 bytes (gather_axis0_bulk_kernel), a block owns a chunk
//                  of GA_TILE columns of all rows, as the TPU probe's
//                  (8, 128) block holds all rows of its lanes: one thread
//                  brings x's rows x GA_TILE block into shared memory with
//                  one bulk copy a row segment, completed on an mbarrier,
//                  while every thread reads its indices as int4s; then each
//                  gathers four columns of a row from shared memory and
//                  writes them with one 16-byte store. So x crosses device
//                  memory once, where the first version (one float a thread
//                  through L1/L2, gather_axis0_kernel, kept for shapes off
//                  the grid) reads a row of x in each of the up to `rows`
//                  rows a warp's indices name and finds it evicted from L2
//                  when the next output row comes back to the same columns.
//   int8_widen     out = x + float(i8): char4 loads widened in registers
//                  (int8_widen).
//
// Indices are clamped into range, so no access leaves its tensor. `seg` is
// a power of two. What bounds them: device-memory bytes (every input read
// once, the output written once); none does arithmetic worth counting.
//
// Interface: plain C for ctypes; launches go on the caller's stream and
// return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

#define GP_THREADS 256
#define GP_CHUNK 2048        // columns a block of the shared-memory forms stages
#define GP_MAX_BLOCKS 4224   // 32 blocks on each of 132 SMs, for grid-stride kernels
#define SR_UNROLL 4          // vectors a thread of slice_rows_kernel moves

__device__ __forceinline__ int clampi(int v, int hi) { return min(max(v, 0), hi); }

// --- gather along the row, within segments ---------------------------------

template <typename IDX>
__global__ void __launch_bounds__(GP_THREADS)
gather_lanes_smem_kernel(const float* __restrict__ x, const IDX* __restrict__ idx,
                         float* __restrict__ out, long long width, int seg, int chunk) {
  extern __shared__ float sm[];
  const size_t at0 = (size_t)blockIdx.y * width + (size_t)blockIdx.x * chunk;
  const int w = (int)min((long long)chunk, width - (long long)blockIdx.x * chunk);
  for (int c = threadIdx.x; c < w; c += GP_THREADS) sm[c] = x[at0 + c];
  __syncthreads();
  for (int c = threadIdx.x; c < w; c += GP_THREADS) {
    const int j = clampi((int)idx[at0 + c], seg - 1);  // int8 widens here
    out[at0 + c] = sm[(c & ~(seg - 1)) + j];
  }
}

// one warp per 128-column segment; (rows, width) is contiguous and width a
// multiple of 128, so segment s is the flat range [128 s, 128 s + 128)
__global__ void __launch_bounds__(GP_THREADS)
gather_lanes_shfl_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                         float* __restrict__ out, long long nseg) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (GP_THREADS / 32);
  for (long long s = (long long)blockIdx.x * (GP_THREADS / 32) + (threadIdx.x >> 5); s < nseg;
       s += warps) {
    const size_t base = (size_t)s * 128;
    float v[4];
    int j[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      v[g] = x[base + 32 * g + lane];
      j[g] = clampi(idx[base + 32 * g + lane], 127);
    }
#pragma unroll
    for (int go = 0; go < 4; ++go) {
      float o = 0.f;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float t = __shfl_sync(0xffffffffu, v[g], j[go] & 31);
        if ((j[go] >> 5) == g) o = t;
      }
      out[base + 32 * go + lane] = o;
    }
  }
}

template <typename IDX>
__global__ void __launch_bounds__(GP_THREADS)
gather_lanes_global_kernel(const float* __restrict__ x, const IDX* __restrict__ idx,
                           float* __restrict__ out, long long total, int seg) {
  const long long stride = (long long)gridDim.x * GP_THREADS;
  for (long long f = (long long)blockIdx.x * GP_THREADS + threadIdx.x; f < total; f += stride) {
    const int j = clampi((int)idx[f], seg - 1);
    out[f] = __ldg(x + (f & ~(long long)(seg - 1)) + j);
  }
}

// --- a block chosen by an index the kernel reads from device memory --------

#define BS_STAGES 8
#define BS_STAGE_FLOATS 4096  // 16 KB a stage
#define BS_SMEM (BS_STAGES * (BS_STAGE_FLOATS * 4 + 8))

// Block p of x (rows, nb * bw) by bulk copies (the head of this file). The
// flat output, total = rows * bw floats, is cut into chunks of
// BS_STAGE_FLOATS; block b of the persistent grid moves chunks b,
// b + gridDim.x, ..., so the grid sweeps the output in order, each chunk
// loaded as the row segments of block p it covers (one bulk load each) and
// stored as one run. bw and x on 16 bytes (the launcher checks it), so
// every segment starts and ends on 16 bytes.
__global__ void __launch_bounds__(32)
block_select_bulk_kernel(const float* __restrict__ x, const int* __restrict__ p_ptr,
                         float* __restrict__ out, int bw, int nb, long long total) {
  extern __shared__ __align__(128) unsigned char ring_smem[];
  if (threadIdx.x != 0) return;
  float* stages = reinterpret_cast<float*>(ring_smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring_smem + BS_STAGES * BS_STAGE_FLOATS * 4);
  for (int s = 0; s < BS_STAGES; ++s) mbar_init(full + s, 1);
  mbar_init_fence();
  const float* src = x + (size_t)clampi(__ldg(p_ptr), nb - 1) * bw;
  const long long nch = (total + BS_STAGE_FLOATS - 1) / BS_STAGE_FLOATS;
  const int nk = (int)((nch - blockIdx.x + gridDim.x - 1) / gridDim.x);  // this block's chunks
  // the output offset and the length of this block's k-th chunk
  auto chunk = [&](int k, long long* f0) {
    *f0 = (blockIdx.x + (long long)k * gridDim.x) * BS_STAGE_FLOATS;
    return (int)min((long long)BS_STAGE_FLOATS, total - *f0);
  };
  auto load = [&](int k, int s) {
    long long f0;
    const int n = chunk(k, &f0);
    float* stage = stages + s * BS_STAGE_FLOATS;
    mbar_arrive_expect_tx(full + s, (uint32_t)n * 4);
    for (long long f = f0; f < f0 + n;) {
      const long long r = f / bw;
      const int c = (int)(f - r * bw), seg = (int)min((long long)(bw - c), f0 + n - f);
      bulk_load(stage + (f - f0), src + (size_t)r * nb * bw + c, (uint32_t)seg * 4, full + s);
      f += seg;
    }
  };
  for (int k = 0; k < nk && k < BS_STAGES; ++k) load(k, k);
  for (int k = 0; k < nk; ++k) {
    const int s = k % BS_STAGES;
    mbar_wait(full + s, (k / BS_STAGES) & 1);
    long long f0;
    const int n = chunk(k, &f0);
    bulk_store(out + f0, stages + s * BS_STAGE_FLOATS, (uint32_t)n * 4);
    bulk_commit();
    // refill the stage stored one step ago once its store has read it;
    // this step's store may still be reading
    if (k > 0 && k - 1 + BS_STAGES < nk) {
      bulk_wait_read<1>();
      load(k - 1 + BS_STAGES, (k - 1) % BS_STAGES);
    }
  }
  bulk_wait<0>();  // the stores have landed before the block's memory goes
}

template <int V> struct vec_of;
template <> struct vec_of<1> { typedef float T; };
template <> struct vec_of<4> { typedef float4 T; };

// The same function as a copy of runs: block (bx, r) moves the
// GP_THREADS * SR_UNROLL vectors of V floats from vector bx * GP_THREADS *
// SR_UNROLL on of row r, neighbouring threads on neighbouring vectors. All
// SR_UNROLL loads of a thread are issued before its first store: with V = 4,
// 64 bytes a thread in flight, which covers HBM's latency at far below full
// occupancy. Bound by bytes (one block in, one out); the launcher checks
// that V = 4 finds every row of source and destination on 16 bytes.
template <int V>
__global__ void __launch_bounds__(GP_THREADS)
slice_rows_kernel(const float* __restrict__ x, const int* __restrict__ p_ptr,
                  float* __restrict__ out, int bw, int nb, long long row_stride,
                  long long block_stride) {
  typedef typename vec_of<V>::T vec;
  const int p = clampi(__ldg(p_ptr), nb - 1);
  const vec* src = reinterpret_cast<const vec*>(x + (size_t)p * block_stride +
                                                (size_t)blockIdx.y * row_stride);
  vec* dst = reinterpret_cast<vec*>(out + (size_t)blockIdx.y * bw);
  const long long nvec = bw / V;
  const long long v0 = (long long)blockIdx.x * (GP_THREADS * SR_UNROLL) + threadIdx.x;
  vec v[SR_UNROLL];
#pragma unroll
  for (int u = 0; u < SR_UNROLL; ++u)
    if (v0 + u * GP_THREADS < nvec) v[u] = __ldg(src + v0 + u * GP_THREADS);
#pragma unroll
  for (int u = 0; u < SR_UNROLL; ++u)
    if (v0 + u * GP_THREADS < nvec) dst[v0 + u * GP_THREADS] = v[u];
}

// --- roll by a shift read from device memory -------------------------------

__global__ void __launch_bounds__(GP_THREADS)
roll_lanes_smem_kernel(const float* __restrict__ x, const int* __restrict__ s_ptr,
                       float* __restrict__ out, long long width, int seg, int chunk) {
  extern __shared__ float sm[];
  const size_t at0 = (size_t)blockIdx.y * width + (size_t)blockIdx.x * chunk;
  const int w = (int)min((long long)chunk, width - (long long)blockIdx.x * chunk);
  for (int c = threadIdx.x; c < w; c += GP_THREADS) sm[c] = x[at0 + c];
  __syncthreads();
  const int s = __ldg(s_ptr) & (seg - 1);  // two's complement: right for s < 0 too
  for (int c = threadIdx.x; c < w; c += GP_THREADS)
    out[at0 + c] = sm[(c & ~(seg - 1)) + ((c + s) & (seg - 1))];
}

// --- gather across rows ----------------------------------------------------

// the first version: one float a thread over the flat output, a 64-bit
// modulo an element, x read through L1/L2
__global__ void __launch_bounds__(GP_THREADS)
gather_axis0_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                    float* __restrict__ out, int rows, long long width) {
  const long long total = (long long)rows * width;
  const long long stride = (long long)gridDim.x * GP_THREADS;
  for (long long f = (long long)blockIdx.x * GP_THREADS + threadIdx.x; f < total; f += stride) {
    const long long c = f % width;
    out[f] = __ldg(x + (size_t)clampi(idx[f], rows - 1) * width + c);
  }
}

#define GA_TILE 512                  // columns a block owns: 2 KB a row
#define GA_QUADS (GA_TILE / 4)       // float4 columns of a chunk
#define GA_ROWSTEP (GP_THREADS / GA_QUADS)  // rows the block's threads cover at once
#define GA_UNROLL 4                  // int4 index loads in flight a thread
#define GA_BAR 16                    // the mbarrier, ahead of the block in shared memory
#define GA_MAX_SMEM (227 * 1024)     // a block's shared memory on the H100
#define GA_MAX_ROWS ((GA_MAX_SMEM - GA_BAR) / (GA_TILE * 4))

// Block b gathers columns [b * GA_TILE, + w) of all rows (the head of this
// file). Thread t owns float4 column q = t % GA_QUADS of rows t / GA_QUADS,
// + GA_ROWSTEP, ...: a warp reads 512 contiguous bytes of idx and writes 512
// of out. Bank conflicts do not bound it: GA_TILE is a multiple of 32, so
// smem[row * GA_TILE + c] lies in bank c mod 32 whatever the row, and the
// four scalar reads of a thread's float4 are at worst 4-way conflicted,
// which leaves some 32 useful bytes a clock an SM against the ~5 the copy
// rate asks of it. x, idx and out on 16 bytes and width % 4 == 0 (the
// launcher checks), so every segment and vector is aligned.
__global__ void __launch_bounds__(GP_THREADS)
gather_axis0_bulk_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                         float* __restrict__ out, int rows, long long width) {
  extern __shared__ __align__(128) unsigned char ga_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(ga_smem);
  const float* sm = reinterpret_cast<const float*>(ga_smem + GA_BAR);
  const long long c0 = (long long)blockIdx.x * GA_TILE;
  const int w = (int)min((long long)GA_TILE, width - c0);
  if (threadIdx.x == 0) {
    mbar_init(full, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // x's rows x w block, one bulk copy a row
    mbar_arrive_expect_tx(full, (uint32_t)rows * w * 4);
    for (int r = 0; r < rows; ++r)
      bulk_load(ga_smem + GA_BAR + (size_t)r * GA_TILE * 4, x + (size_t)r * width + c0,
                (uint32_t)w * 4, full);
  }
  const int q = threadIdx.x % GA_QUADS;
  if (4 * q >= w) return;  // past a narrow last chunk (never thread 0, which waits)
  bool landed = false;
  for (int r0 = threadIdx.x / GA_QUADS; r0 < rows; r0 += GA_ROWSTEP * GA_UNROLL) {
    int4 j[GA_UNROLL];
#pragma unroll
    for (int u = 0; u < GA_UNROLL; ++u) {
      const int r = r0 + u * GA_ROWSTEP;
      if (r < rows)
        j[u] = __ldcs(reinterpret_cast<const int4*>(idx + (size_t)r * width + c0 + 4 * q));
    }
    if (!landed) {  // the indices are in flight: now wait for x's block
      mbar_wait(full, 0);
      landed = true;
    }
#pragma unroll
    for (int u = 0; u < GA_UNROLL; ++u) {
      const int r = r0 + u * GA_ROWSTEP;
      if (r < rows) {
        const float* col = sm + 4 * q;
        const float4 o = make_float4(col[clampi(j[u].x, rows - 1) * GA_TILE],
                                     col[clampi(j[u].y, rows - 1) * GA_TILE + 1],
                                     col[clampi(j[u].z, rows - 1) * GA_TILE + 2],
                                     col[clampi(j[u].w, rows - 1) * GA_TILE + 3]);
        __stcs(reinterpret_cast<float4*>(out + (size_t)r * width + c0 + 4 * q), o);
      }
    }
  }
}

// --- int8 widened in registers ---------------------------------------------

template <bool VEC>
__global__ void __launch_bounds__(GP_THREADS)
int8_widen_kernel(const float* __restrict__ x, const signed char* __restrict__ i8,
                  float* __restrict__ out, long long total) {
  const long long stride = (long long)gridDim.x * GP_THREADS;
  const long long t0 = (long long)blockIdx.x * GP_THREADS + threadIdx.x;
  if (VEC) {
    for (long long q = t0; q < total / 4; q += stride) {
      const float4 v = reinterpret_cast<const float4*>(x)[q];
      const char4 b = reinterpret_cast<const char4*>(i8)[q];
      reinterpret_cast<float4*>(out)[q] =
          make_float4(v.x + (float)b.x, v.y + (float)b.y, v.z + (float)b.z, v.w + (float)b.w);
    }
  } else {
    for (long long f = t0; f < total; f += stride) out[f] = x[f] + (float)i8[f];
  }
}

namespace {

unsigned stride_grid(long long work_items) {
  const long long blocks = (work_items + GP_THREADS - 1) / GP_THREADS;
  return (unsigned)(blocks < 1 ? 1 : (blocks > GP_MAX_BLOCKS ? GP_MAX_BLOCKS : blocks));
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// columns a block stages: a multiple of seg, GP_CHUNK unless seg is larger
int chunk_for(int seg) { return seg > GP_CHUNK ? seg : GP_CHUNK; }

// the bulk selection's grid: as many blocks as fit on the card at once
// (occupancy with BS_SMEM of shared memory), at most one a chunk
int bulk_select_grid(long long total, unsigned* grid) {
  static int dev_seen = -1, per_sm = 0, sms = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev != dev_seen) {
    e = cudaFuncSetAttribute(block_select_bulk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, BS_SMEM);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, block_select_bulk_kernel, 32,
                                                        BS_SMEM);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    dev_seen = dev;
  }
  const long long chunks = (total + BS_STAGE_FLOATS - 1) / BS_STAGE_FLOATS;
  const long long cap = (long long)sms * per_sm;
  *grid = (unsigned)(chunks < cap ? chunks : cap);
  return 0;
}

}  // namespace

extern "C" {

// form: 0 shared memory, 1 warp shuffles (seg = 128, int32 indices), 2
// global; idx_bytes: 4 (int32) or 1 (int8)
int gather_lanes_launch(int form, int idx_bytes, const void* x, const void* idx, void* out,
                        int rows, long long width, int seg, void* stream) {
  if (rows < 1 || rows > 65535 || width < 1 || !pow2(seg) || width % seg ||
      (idx_bytes != 4 && idx_bytes != 1) || form < 0 || form > 2 ||
      (form == 1 && (seg != 128 || idx_bytes != 4)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* xp = (const float*)x;
  float* op = (float*)out;
  const long long total = (long long)rows * width;
  if (form == 0) {
    const int chunk = chunk_for(seg);
    const size_t smem = (size_t)chunk * sizeof(float);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)((width + chunk - 1) / chunk), (unsigned)rows);
    if (idx_bytes == 4)
      gather_lanes_smem_kernel<int><<<grid, GP_THREADS, smem, s>>>(
          xp, (const int*)idx, op, width, seg, chunk);
    else
      gather_lanes_smem_kernel<signed char><<<grid, GP_THREADS, smem, s>>>(
          xp, (const signed char*)idx, op, width, seg, chunk);
  } else if (form == 1) {
    const long long nseg = total / 128;
    gather_lanes_shfl_kernel<<<stride_grid(nseg * 32), GP_THREADS, 0, s>>>(
        xp, (const int*)idx, op, nseg);
  } else if (idx_bytes == 4) {
    gather_lanes_global_kernel<int><<<stride_grid(total), GP_THREADS, 0, s>>>(
        xp, (const int*)idx, op, total, seg);
  } else {
    gather_lanes_global_kernel<signed char><<<stride_grid(total), GP_THREADS, 0, s>>>(
        xp, (const signed char*)idx, op, total, seg);
  }
  return (int)cudaGetLastError();
}

// Block p of x (rows, nb * bw) by bulk copies, p read from p_ptr[0];
// refused unless bw is a multiple of 4 and x and out lie on 16 bytes (the
// wrapper chooses it with gather_probe.scratch_body, and slice_rows_launch
// elsewhere).
int block_select_launch(const void* x, const void* p_ptr, void* out, int rows, int bw, int nb,
                        void* stream) {
  if (rows < 1 || rows > 65535 || bw < 1 || nb < 1 || bw % 4 || !aligned16(x) ||
      !aligned16(out))
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)rows * bw;
  unsigned grid;
  int e = bulk_select_grid(total, &grid);
  if (e) return e;
  block_select_bulk_kernel<<<grid, 32, BS_SMEM, (cudaStream_t)stream>>>(
      (const float*)x, (const int*)p_ptr, (float*)out, bw, nb, total);
  return (int)cudaGetLastError();
}

// block p of x, at p * block_stride, its rows row_stride apart, p read from
// p_ptr[0]; vec: 4 (float4 moves: x and out on 16 bytes, bw and both
// strides multiples of 4) or 1
int slice_rows_launch(int vec, const void* x, const void* p_ptr, void* out, int rows, int bw,
                      int nb, long long row_stride, long long block_stride, void* stream) {
  if (rows < 1 || rows > 65535 || bw < 1 || nb < 1 || (vec != 1 && vec != 4) ||
      (vec == 4 && (bw % 4 || row_stride % 4 || block_stride % 4 || !aligned16(x) ||
                    !aligned16(out))))
    return (int)cudaErrorInvalidValue;
  const long long per_block = (long long)GP_THREADS * SR_UNROLL * vec;
  const dim3 grid((unsigned)((bw + per_block - 1) / per_block), (unsigned)rows);
  cudaStream_t s = (cudaStream_t)stream;
  if (vec == 4)
    slice_rows_kernel<4><<<grid, GP_THREADS, 0, s>>>(
        (const float*)x, (const int*)p_ptr, (float*)out, bw, nb, row_stride, block_stride);
  else
    slice_rows_kernel<1><<<grid, GP_THREADS, 0, s>>>(
        (const float*)x, (const int*)p_ptr, (float*)out, bw, nb, row_stride, block_stride);
  return (int)cudaGetLastError();
}

int roll_lanes_launch(const void* x, const void* s_ptr, void* out, int rows, long long width,
                      int seg, void* stream) {
  if (rows < 1 || rows > 65535 || width < 1 || !pow2(seg) || width % seg)
    return (int)cudaErrorInvalidValue;
  const int chunk = chunk_for(seg);
  const size_t smem = (size_t)chunk * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((width + chunk - 1) / chunk), (unsigned)rows);
  roll_lanes_smem_kernel<<<grid, GP_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const int*)s_ptr, (float*)out, width, seg, chunk);
  return (int)cudaGetLastError();
}

// body: 0 the first version (any shape), 1 bulk copies one chunk of
// GA_TILE columns a block (refused unless width % 4 == 0, x, idx and out lie
// on 16 bytes and rows <= GA_MAX_ROWS; the wrapper chooses it with
// gather_probe.axis0_body)
int gather_axis0_launch(int body, const void* x, const void* idx, void* out, int rows,
                        long long width, void* stream) {
  if (rows < 1 || width < 1 || body < 0 || body > 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (body == 1) {
    if (width % 4 || rows > GA_MAX_ROWS || !aligned16(x) || !aligned16(idx) || !aligned16(out))
      return (int)cudaErrorInvalidValue;
    const int smem = GA_BAR + rows * GA_TILE * 4;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(gather_axis0_bulk_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
    const long long chunks = (width + GA_TILE - 1) / GA_TILE;
    if (chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    gather_axis0_bulk_kernel<<<(unsigned)chunks, GP_THREADS, smem, s>>>(
        (const float*)x, (const int*)idx, (float*)out, rows, width);
  } else {
    gather_axis0_kernel<<<stride_grid((long long)rows * width), GP_THREADS, 0, s>>>(
        (const float*)x, (const int*)idx, (float*)out, rows, width);
  }
  return (int)cudaGetLastError();
}

int int8_widen_launch(const void* x, const void* i8, void* out, long long total, void* stream) {
  if (total < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (total % 4 == 0 && aligned16(x) && aligned16(out) && ((uintptr_t)i8 & 3) == 0)
    int8_widen_kernel<true><<<stride_grid(total / 4), GP_THREADS, 0, s>>>(
        (const float*)x, (const signed char*)i8, (float*)out, total);
  else
    int8_widen_kernel<false><<<stride_grid(total), GP_THREADS, 0, s>>>(
        (const float*)x, (const signed char*)i8, (float*)out, total);
  return (int)cudaGetLastError();
}

}  // extern "C"
