// Tall-skinny DIA SpMM in the transposed layout, for Hopper (sm_90a).
//
// Replaces dune_eigensolver_tpu/kernels/dia_spmm.py::_kernel (launched by
// padded_spmm). It computes what that kernel computes, not its tiling:
//
//     Y[r, i] = sum_d data[d, i] * X[r, i + off_d],   zero outside [0, n)
//
// with X and Y contiguous row-major (m, n), data (ndiag, n), f32 or bf16
// storage with f32 accumulation, or f64 storage with f64 accumulation (the
// TPU has no f64; the card does, and the f64 solves and the f64 Rayleigh-Ritz
// refinement need this product). The TPU kernel's rolling VMEM window and
// far-offset windows exist for Pallas BlockSpecs; here each thread masks
// its own out-of-range columns.
//
// What bounds it: device-memory bytes. Each coefficient (4 bytes in f32)
// serves 2 flops per row of X, far below the card's ops-per-byte balance,
// so the least time is (ndiag*n + 2*m*n) * itemsize over the HBM rate.
// What held the first version (one column a thread, one 4- or 2-byte load
// per multiply-add, a row loop that could not unroll) at 40% of that was
// not bytes but the number of load requests and how few were in flight:
// bf16 moved half the bytes in 0.9 of the time, and with every re-read of X
// adjacent (L1-resident) it still took twice the bound.
//
// What the design does about that:
//   * a thread owns V consecutive columns (V = 4, 2 or 1, chosen by
//     kernels/dia_spmm.py::dia_vector_width from n and the offsets) and
//     moves them with one request: 16 bytes in f32 at V = 4. A diagonal
//     whose offset is a multiple of V is one aligned vector load per row
//     of X for V multiply-adds. The vector kernels are built for the
//     stencils of 5 and 7 diagonals whose middle three are (-1, 0, 1). With n a multiple of V such a vector is
//     either wholly inside [0, n) or wholly outside, so the first version's
//     rule (zero coefficient, in-bounds address) holds vector by vector and
//     no block needs a scalar body;
//   * the +-1 neighbours of a stencil come from the thread's own centre
//     vector and one value of each neighbouring lane by warp shuffle; lanes
//     0 and 31 load theirs (one 4-byte request each). Every lane of a warp
//     that owns a column takes part: a lane past n works on the last V
//     columns again and stores nothing. Where a neighbour lies outside
//     [0, n) its coefficient is zero and the thread's own column stands in
//     for it, as in the first version;
//   * the row loop is unrolled by DIA_ROWS rows, so DIA_ROWS x (ndiag - 2)
//     vector loads are in flight per thread, and the diagonal count is a
//     template constant, so no slot is predicated;
//   * the V * ndiag coefficients stay in registers for all m rows, so the
//     diagonals cross device memory once per call;
//   * one chain of fused multiply-adds per output, diagonals in offset
//     order, exactly as the first version: every width gives the same bits.
// V = 1 (odd n, or offsets that fit no vector) is the first version's body
// with the diagonal count as a template constant. f64 always takes V = 1
// (kernels/dia_spmm.py::dia_vector_width): one 8-byte load per multiply-add,
// coalesced across the warp, accumulated in f64 (Acc<double>); a simple,
// correct body first, its time beside its bound in PERF.md section 6.
// X is not staged in shared memory. On a compute body as good as this one
// (csrc/dia_body.cuh: the same bits, 4 columns a thread, the coefficients
// staged once per tile for every row a block holds), the staging variants
// C and D (csrc/dia_stage_c.cu, dia_stage_d.cu) come within 6-14% of this
// kernel at 2D N=2048 m=8, and neither beats it: not D's rolling ring,
// which reads X from device memory once, nor C's window, which re-reads
// its halos through L2 (B's ring, dia_variants.cu, stays 1.9x behind). L1/L2 serve
// this kernel's re-reads of X as well as a staged window does on this card
// (PERF.md section 6).
// Registers (ptxas, sm_90a): see PERF.md section 6; the build log prints
// them.
//
// Interface: plain C, loaded with ctypes. Offsets arrive by value in a
// small struct; the launch goes on the caller's stream and the function
// returns cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define DIA_MAX_DIAG 16
#define DIA_SCALAR_THREADS 256
#define DIA_THREADS 128   // of the vector kernels
#define DIA_MIN_BLOCKS 4  // resident blocks an SM the vector kernels are held to
#define DIA_ROWS 2        // rows of X a thread has in flight

struct DiaOffsets {
  int count;
  int off[DIA_MAX_DIAG];
};

// the accumulator of a storage type: f32 for f32 and bf16, f64 for f64
template <typename T> struct Acc { using type = float; };
template <> struct Acc<double> { using type = double; };

__device__ __forceinline__ float load_acc(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_acc(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ double load_acc(const double* p) { return __ldg(p); }
__device__ __forceinline__ void store_acc(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_acc(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store_acc(double* p, double v) { *p = v; }
__device__ __forceinline__ float fma_acc(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_acc(double a, double b, double c) { return fma(a, b, c); }

// ---------------------------------------------------------------------------
// V = 1: one column a thread. ND > 0 is the diagonal count; ND == 0 takes
// the count from the struct and predicates DIA_MAX_DIAG slots.
// ---------------------------------------------------------------------------

template <typename T, int ND>
__global__ void __launch_bounds__(DIA_SCALAR_THREADS)
dia_spmm_t_scalar_kernel(const T* __restrict__ data, const T* __restrict__ x,
                         T* __restrict__ y, int n, int m, DiaOffsets offs) {
  using A = typename Acc<T>::type;
  constexpr int SLOTS = ND ? ND : DIA_MAX_DIAG;
  const int count = ND ? ND : offs.count;
  const int i = blockIdx.x * DIA_SCALAR_THREADS + threadIdx.x;
  if (i >= n) return;
  // coefficients of column i, in registers for the whole row loop; a column
  // outside [0, n) gets a zero coefficient and reads column i instead, so
  // every load stays in bounds
  A coef[SLOTS];
  int col[SLOTS];
#pragma unroll
  for (int d = 0; d < SLOTS; ++d) {
    coef[d] = A(0);
    col[d] = i;
    if (d < count) {
      const long long j = (long long)i + offs.off[d];
      if (j >= 0 && j < n) {
        coef[d] = load_acc(data + (size_t)d * n + i);
        col[d] = (int)j;
      }
    }
  }
  for (int r = 0; r < m; ++r) {
    const T* xr = x + (size_t)r * n;
    A acc = A(0);
#pragma unroll
    for (int d = 0; d < SLOTS; ++d) {
      if (d < count) acc = fma_acc(coef[d], load_acc(xr + col[d]), acc);
    }
    store_acc(y + (size_t)r * n + i, acc);
  }
}

// ---------------------------------------------------------------------------
// V = 2, 4: V columns a thread, moved as one vector.
// ---------------------------------------------------------------------------

template <typename T, int V> struct Vec;
template <> struct Vec<float, 4> { using type = float4; };
template <> struct Vec<float, 2> { using type = float2; };
template <> struct Vec<__nv_bfloat16, 4> { using type = uint2; };
template <> struct Vec<__nv_bfloat16, 2> { using type = unsigned; };

// bf16 -> f32 is exact: the 16 bits become the upper half of the word
__device__ __forceinline__ float bf16_lo(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(unsigned u) { return __uint_as_float(u & 0xffff0000u); }
__device__ __forceinline__ unsigned bf16_pack(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // rounds as __float2bfloat16
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ void unpack(float4 t, float (&v)[4]) {
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void unpack(float2 t, float (&v)[2]) { v[0] = t.x; v[1] = t.y; }
__device__ __forceinline__ void unpack(uint2 t, float (&v)[4]) {
  v[0] = bf16_lo(t.x); v[1] = bf16_hi(t.x); v[2] = bf16_lo(t.y); v[3] = bf16_hi(t.y);
}
__device__ __forceinline__ void unpack(unsigned t, float (&v)[2]) {
  v[0] = bf16_lo(t); v[1] = bf16_hi(t);
}

__device__ __forceinline__ void pack(const float (&v)[4], float4& t) {
  t = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void pack(const float (&v)[2], float2& t) { t = make_float2(v[0], v[1]); }
__device__ __forceinline__ void pack(const float (&v)[4], uint2& t) {
  t = make_uint2(bf16_pack(v[0], v[1]), bf16_pack(v[2], v[3]));
}
__device__ __forceinline__ void pack(const float (&v)[2], unsigned& t) { t = bf16_pack(v[0], v[1]); }

// p must be aligned to V elements
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[V]) {
  unpack(__ldg(reinterpret_cast<const typename Vec<T, V>::type*>(p)), v);
}
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[V]) {
  typename Vec<T, V>::type t;
  pack(v, t);
  *reinterpret_cast<typename Vec<T, V>::type*>(p) = t;
}

// RR rows of Y from row r on. The diagonals C - 1, C, C + 1 (C = ND / 2)
// have the offsets -1, 0, 1 and the other offsets are multiples of V.
// ``left``/``right``: the in-bounds columns lane 0 and lane 31 read for the
// neighbour a shuffle cannot give them; ``edge_l``/``edge_r``: column
// i0 - 1 or i0 + V lies outside [0, n), and the thread's own column stands
// in for it under its zero coefficient.
template <typename T, int V, int ND, int RR>
__device__ __forceinline__ void dia_rows(const T* __restrict__ x, T* __restrict__ y, size_t n,
                                         int r, int i0, bool live, int lane,
                                         const float (&coef)[ND][V], const int (&col)[ND],
                                         int left, int right, bool edge_l, bool edge_r) {
  constexpr int C = ND / 2;
  float xv[RR][ND][V];
  float xl[RR], xr[RR];
#pragma unroll
  for (int q = 0; q < RR; ++q) {
    const T* xq = x + (size_t)(r + q) * n;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      if (d == C - 1 || d == C + 1) continue;
      load_vec<T, V>(xq + col[d], xv[q][d]);
    }
    xl[q] = 0.f;
    xr[q] = 0.f;
    if (lane == 0) xl[q] = load_acc(xq + left);
    if (lane == 31) xr[q] = load_acc(xq + right);
  }
#pragma unroll
  for (int q = 0; q < RR; ++q) {
    const float up = __shfl_up_sync(0xffffffffu, xv[q][C][V - 1], 1);
    const float down = __shfl_down_sync(0xffffffffu, xv[q][C][0], 1);
    xv[q][C - 1][0] = edge_l ? xv[q][C][0] : lane == 0 ? xl[q] : up;
    xv[q][C + 1][V - 1] = edge_r ? xv[q][C][V - 1] : lane == 31 ? xr[q] : down;
#pragma unroll
    for (int v = 1; v < V; ++v) {
      xv[q][C - 1][v] = xv[q][C][v - 1];
      xv[q][C + 1][v - 1] = xv[q][C][v];
    }
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float a = 0.f;
#pragma unroll
      for (int d = 0; d < ND; ++d) a = fmaf(coef[d][v], xv[q][d][v], a);
      acc[v] = a;
    }
    if (live) store_vec<T, V>(y + (size_t)(r + q) * n + i0, acc);
  }
}

template <typename T, int V, int ND>
__global__ void __launch_bounds__(DIA_THREADS, DIA_MIN_BLOCKS)
dia_spmm_t_vec_kernel(const T* __restrict__ data, const T* __restrict__ x, T* __restrict__ y,
                      int n, int m, DiaOffsets offs) {
  constexpr int C = ND / 2;
  const int lane = threadIdx.x & 31;
  const long long first = ((long long)blockIdx.x * DIA_THREADS + threadIdx.x) * V;
  if (first - (long long)lane * V >= n) return;  // the whole warp is past n
  // a lane past n keeps its warp's shuffles whole: it works on the last V
  // columns again and stores nothing
  const bool live = first < n;
  const int i0 = live ? (int)first : n - V;
  // i0, n and the far offsets are multiples of V, so a far vector lies
  // wholly inside [0, n) or wholly outside: zero coefficients and the
  // thread's own columns for one outside
  float coef[ND][V];
  int col[ND];
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    load_vec<T, V>(data + (size_t)d * n + i0, coef[d]);
    col[d] = i0;
    if (d == C - 1 || d == C + 1) continue;
    const long long j = (long long)i0 + offs.off[d];
    if (j >= 0 && j < n) {
      col[d] = (int)j;
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) coef[d][v] = 0.f;
    }
  }
  const bool edge_l = i0 == 0, edge_r = i0 + V == n;
  if (edge_l) coef[C - 1][0] = 0.f;
  if (edge_r) coef[C + 1][V - 1] = 0.f;
  const int left = edge_l ? 0 : i0 - 1;
  const int right = edge_r ? n - 1 : i0 + V;
  int r = 0;
  for (; r + DIA_ROWS <= m; r += DIA_ROWS)
    dia_rows<T, V, ND, DIA_ROWS>(x, y, (size_t)n, r, i0, live, lane, coef, col, left, right,
                                 edge_l, edge_r);
  for (; r < m; ++r)
    dia_rows<T, V, ND, 1>(x, y, (size_t)n, r, i0, live, lane, coef, col, left, right, edge_l,
                          edge_r);
}

// The vector kernels that exist: the stencils of 5 and 7 diagonals around
// (-1, 0, 1). kernels/dia_spmm.py::dia_vector_width knows the same list.
template <typename T, int V>
static bool launch_vec(int ndiag, unsigned grid, cudaStream_t s, const T* data, const T* x, T* y,
                       int n, int m, const DiaOffsets& offs) {
  if (ndiag == 5) {
    dia_spmm_t_vec_kernel<T, V, 5><<<grid, DIA_THREADS, 0, s>>>(data, x, y, n, m, offs);
  } else if (ndiag == 7) {
    dia_spmm_t_vec_kernel<T, V, 7><<<grid, DIA_THREADS, 0, s>>>(data, x, y, n, m, offs);
  } else {
    return false;
  }
  return true;
}

template <typename T>
static int launch(const void* data_, const void* x_, void* y_, long long n_, int m, int ndiag,
                  const DiaOffsets& offs, int width, cudaStream_t s) {
  const T* data = (const T*)data_;
  const T* x = (const T*)x_;
  T* y = (T*)y_;
  const int n = (int)n_;
  if (width == 1) {
    const unsigned grid = (unsigned)((n_ + DIA_SCALAR_THREADS - 1) / DIA_SCALAR_THREADS);
    if (ndiag == 5) {
      dia_spmm_t_scalar_kernel<T, 5><<<grid, DIA_SCALAR_THREADS, 0, s>>>(data, x, y, n, m, offs);
    } else if (ndiag == 7) {
      dia_spmm_t_scalar_kernel<T, 7><<<grid, DIA_SCALAR_THREADS, 0, s>>>(data, x, y, n, m, offs);
    } else {
      dia_spmm_t_scalar_kernel<T, 0><<<grid, DIA_SCALAR_THREADS, 0, s>>>(data, x, y, n, m, offs);
    }
    return (int)cudaGetLastError();
  }
  if constexpr (sizeof(T) == 8) {
    return (int)cudaErrorInvalidValue;  // no vector kernel for 8-byte items
  } else {
    // the vector kernels' conditions, checked again here: a misaligned vector
    // load would fault only at run time
    if ((width != 2 && width != 4) || n_ % width) return (int)cudaErrorInvalidValue;
    const size_t align = (size_t)width * sizeof(T);
    if ((size_t)data % align || (size_t)x % align || (size_t)y % align)
      return (int)cudaErrorMisalignedAddress;
    const int c = ndiag / 2;
    for (int d = 0; d < ndiag; ++d) {
      if (d >= c - 1 && d <= c + 1) {
        if (offs.off[d] != d - c) return (int)cudaErrorInvalidValue;
      } else if (offs.off[d] % width) {
        return (int)cudaErrorInvalidValue;
      }
    }
    const long long threads = n_ / width;
    const unsigned grid = (unsigned)((threads + DIA_THREADS - 1) / DIA_THREADS);
    const bool found = width == 4 ? launch_vec<T, 4>(ndiag, grid, s, data, x, y, n, m, offs)
                                  : launch_vec<T, 2>(ndiag, grid, s, data, x, y, n, m, offs);
    return found ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
  }
}

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float64. width: columns a thread
// owns (1, 2, 4); 2 and 4 need a stencil the vector kernels are built for
// and a 4- or 2-byte type (float64 takes 1). Returns a cudaError_t as int.
int dia_spmm_t_launch(int dtype, const void* data, const void* x, void* y,
                      long long n, int m, int ndiag, const int* offsets,
                      int width, void* stream) {
  if (ndiag < 1 || ndiag > DIA_MAX_DIAG || n < 1 || n > 0x7fffffffLL || m < 1)
    return (int)cudaErrorInvalidValue;
  DiaOffsets offs;
  offs.count = ndiag;
  for (int d = 0; d < DIA_MAX_DIAG; ++d) offs.off[d] = d < ndiag ? offsets[d] : 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(data, x, y, n, m, ndiag, offs, width, s);
  if (dtype == 1) return launch<__nv_bfloat16>(data, x, y, n, m, ndiag, offs, width, s);
  if (dtype == 2) return launch<double>(data, x, y, n, m, ndiag, offs, width, s);
  return (int)cudaErrorInvalidValue;
}

const char* dune_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
