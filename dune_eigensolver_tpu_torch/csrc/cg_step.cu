// The Jacobi-CG step's vector algebra on the transposed (m, n) multivector,
// for Hopper (sm_90a): factorize/cg.py's fused path.
//
// Replaces no TPU kernel: the JAX package's factorize/cg.py runs this loop as
// a lax.while_loop of XLA operations. Added because the CG applies hold most
// of the card's time in a GenEO solve, and most of that was PyTorch's
// elementwise passes around the SpMM: some 28 launches a step, each
// temporary (P * alpha, AP * alpha, Z, U * V) written to device memory and
// read back, and the step lengths computed by a handful of tiny operations.
//
// Four kernels do one apply's algebra, with the operator's SpMM (AP = A P,
// the caller's) between the second and the third of a step:
//
//   cg_setup:     R = B (a copy; B is never written), X = 0, P = Z = R d;
//                 rz = R.Z, bnorm = |B|, target = rtol (bnorm > 0 ? bnorm : 1),
//                 flag = any(|R| > target)
//   cg_pap:       pap = P.AP; alpha = pap > 0 ? rz / pap : 0
//   cg_update:    X += alpha P, R -= alpha AP, Z = R d in registers;
//                 beta = rz > 0 ? R.Z / rz : 0, rz = R.Z, flag = any(|R| > target)
//   cg_direction: P = Z + beta P, Z = R d again in registers
//
// d is the reciprocal diagonal (Jacobi), or none (Z = R). Every dot is per
// row of the multivector, in the iterate's type.
//
// What bounds them: device-memory bytes (a few flops a value). The design
// keeps everything but the iterates out of device memory: Z and the scaled
// temporaries live in registers, and the m-vectors rz, alpha, beta and the
// stop flag stay on the card, in a small state array, so the host reads one
// 4-byte flag a step and launches nothing to compute a step length. At
// (8, 522,242) f32 a step moves ~190 MB here (P, AP; X, P, AP, R, d, X, R;
// R, P, d, P) against ~470 MB before.
//
// Layout: each block walks a chunk of columns for up to CG_ROWS rows
// (blockIdx.y takes the next CG_ROWS), so loads coalesce along n and each d
// value is loaded once for the block's rows; V adjacent columns a thread,
// one vector load, where n and every address allow it. Four rows, not all m:
// at (8, 522,242) f32 eight rows a block took more registers (47-64 against
// 40 in cg_update), fewer blocks an SM, and a step ~8 us longer; a d value
// loaded again by the next four rows comes from L2. cg_update streams X and
// AP (evict first), which no later kernel of the step reads, so L2 keeps R
// and P for cg_direction and the SpMM.
//
// Arithmetic: each elementwise operation is the plain version's, rounded on
// its own (__fmul_rn etc.: never contracted into an FMA), so the iterates
// differ from factorize/cg.py's _cg_loop only through the summation order of
// the dots. A dot is summed in a fixed order: each thread its columns in
// turn, a butterfly over the warp, the warps in order, then the blocks'
// partial sums, which the last block to finish (a __threadfence and an atomic
// ticket) adds up lane-strided and by a butterfly. No float atomics, so the
// bits repeat from run to run.
//
// Interface: plain C, loaded with ctypes. The launches go on the caller's
// stream; each function returns cudaGetLastError() so the wrapper can raise
// on a refused launch.

#include <cuda_runtime.h>

#include <initializer_list>

#define CG_THREADS 256
#define CG_WARPS (CG_THREADS / 32)
#define CG_ROWS 4            // rows of the multivector a block holds
#define CG_MAX_BLOCKS 1024   // blocks along n; the partial sums' room per row

// rows of the state array (6 * m values of the iterate's type; S_SUM and the
// row after it hold sums: kernels/cg_step.py's SLOTS)
enum { S_RZ = 0, S_ALPHA = 1, S_BETA = 2, S_TARGET = 3, S_SUM = 4 };
// the control array (two int32): the stop flag the host reads, the ticket
enum { C_FLAG = 0, C_TICKET = 1 };

template <typename T, int V> struct alignas(sizeof(T) * V) Pack { T v[V]; };

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// a (m, n) array given by element strides: the caller's B and AP
struct View {
  const void* p;
  long long sr, sc;
};

template <typename T, int V> struct Native;
template <> struct Native<float, 1> { using type = float; };
template <> struct Native<float, 2> { using type = float2; };
template <> struct Native<float, 4> { using type = float4; };
template <> struct Native<double, 1> { using type = double; };
template <> struct Native<double, 2> { using type = double2; };

// V values at base + off; STREAM: evict first (ld.global.cs), for an array no
// later kernel of the step reads, so the caches keep the ones it does
template <typename T, int V, bool STREAM = false>
__device__ __forceinline__ Pack<T, V> load(const T* base, long long off) {
  if constexpr (STREAM) {
    using N = typename Native<T, V>::type;
    const N v = __ldcs(reinterpret_cast<const N*>(base + off));
    return *reinterpret_cast<const Pack<T, V>*>(&v);
  } else {
    return *reinterpret_cast<const Pack<T, V>*>(base + off);
  }
}

// V columns of row ``row`` of an array with element strides (sr, sc): one
// vector load, where sc == 1 (V > 1 only then)
template <typename T, int V, bool STREAM = false>
__device__ __forceinline__ Pack<T, V> load_strided(const T* __restrict__ a, long long sr,
                                                   long long sc, int row, long long col) {
  if constexpr (V == 1) {
    return load<T, 1, STREAM>(a, row * sr + col * sc);
  } else {
    return load<T, V, STREAM>(a, row * sr + col);
  }
}

template <typename T, int V, bool STREAM = false>
__device__ __forceinline__ void store(T* base, long long off, const Pack<T, V>& v) {
  if constexpr (STREAM) {
    using N = typename Native<T, V>::type;
    __stcs(reinterpret_cast<N*>(base + off), *reinterpret_cast<const N*>(&v));
  } else {
    *reinterpret_cast<Pack<T, V>*>(base + off) = v;
  }
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = add_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The block's sums of acc[q][r] over its threads, in a fixed order, stored at
// part[(q * m + row0 + r) * gridDim.x + blockIdx.x] for r < rows.
template <typename T, int NQ>
__device__ __forceinline__ void block_partials(T (&acc)[NQ][CG_ROWS], T* __restrict__ part,
                                               int m, int row0, int rows) {
  __shared__ T sh[CG_WARPS][NQ * CG_ROWS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
#pragma unroll
    for (int r = 0; r < CG_ROWS; ++r) {
      const T v = warp_sum(acc[q][r]);
      if (lane == 0) sh[warp][q * CG_ROWS + r] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x < NQ * CG_ROWS) {
    const int q = threadIdx.x / CG_ROWS, r = threadIdx.x % CG_ROWS;
    if (r < rows) {
      T s = sh[0][threadIdx.x];
#pragma unroll
      for (int w = 1; w < CG_WARPS; ++w) s = add_rn(s, sh[w][threadIdx.x]);
      part[((long long)q * m + row0 + r) * gridDim.x + blockIdx.x] = s;
    }
  }
}

// Whether this block is the grid's last to finish; the last one then sees
// every block's partial sums, and sets the ticket back to 0 for the next
// launch.
__device__ __forceinline__ bool last_block(int* ctl) {
  __shared__ bool last;
  __threadfence();  // this block's partial sums before its ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned total = gridDim.x * gridDim.y;
    const unsigned t = atomicAdd(reinterpret_cast<unsigned*>(ctl + C_TICKET), 1u);
    last = t == total - 1;
    if (last) {
      ctl[C_TICKET] = 0;
      __threadfence();  // the other blocks' sums after their tickets
    }
  }
  __syncthreads();
  return last;
}

// In the last block: the grid's sum of each of the nqm rows of part, each
// lane adding every 32nd block in turn (eight loads in flight), then a
// butterfly; into sums[i]. The block's threads see sums after the call.
template <typename T>
__device__ __forceinline__ void combine(const T* part, int nqm, T* sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nbx = gridDim.x;
  for (int i = warp; i < nqm; i += CG_WARPS) {
    const T* row = part + (long long)i * nbx;
    T v = 0;
    for (int b0 = lane; b0 < nbx; b0 += 32 * 8) {
      T t[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) t[u] = b0 + 32 * u < nbx ? __ldcg(row + b0 + 32 * u) : T(0);
#pragma unroll
      for (int u = 0; u < 8; ++u) v = add_rn(v, t[u]);
    }
    v = warp_sum(v);
    if (lane == 0) sums[i] = v;
  }
  __syncthreads();
}

// the block's rows and its first column pack
#define CG_BLOCK_PROLOGUE                                              \
  const int row0 = blockIdx.y * CG_ROWS;                               \
  const int rows = min(CG_ROWS, m - row0);                             \
  const long long npk = n / V;                                         \
  const long long stride = (long long)gridDim.x * CG_THREADS;          \
  const long long c0 = (long long)blockIdx.x * CG_THREADS + threadIdx.x;

template <typename T, int V>
__global__ void __launch_bounds__(CG_THREADS)
cg_setup_kernel(const T* __restrict__ b, long long b_sr, long long b_sc,
                const T* __restrict__ d, T* __restrict__ x, T* __restrict__ r,
                T* __restrict__ p, T* __restrict__ state, T* __restrict__ part, int* ctl,
                long long n, int m, T rtol) {
  CG_BLOCK_PROLOGUE
  T acc[2][CG_ROWS];
#pragma unroll
  for (int i = 0; i < CG_ROWS; ++i) acc[0][i] = acc[1][i] = 0;
  for (long long c = c0; c < npk; c += stride) {
    Pack<T, V> dv{};
    if (d) dv = load<T, V>(d, c * V);
#pragma unroll
    for (int i = 0; i < CG_ROWS; ++i) {
      if (i < rows) {
        const long long off = (long long)(row0 + i) * n + c * V;
        const Pack<T, V> bv = load_strided<T, V>(b, b_sr, b_sc, row0 + i, c * V);
        Pack<T, V> zero, z;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          zero.v[e] = 0;
          z.v[e] = d ? mul_rn(bv.v[e], dv.v[e]) : bv.v[e];
          acc[0][i] = add_rn(acc[0][i], mul_rn(bv.v[e], z.v[e]));
          acc[1][i] = add_rn(acc[1][i], mul_rn(bv.v[e], bv.v[e]));
        }
        store<T, V>(r, off, bv);
        store<T, V>(x, off, zero);
        store<T, V>(p, off, z);
      }
    }
  }
  block_partials<T, 2>(acc, part, m, row0, rows);
  if (!last_block(ctl)) return;
  T* sums = state + S_SUM * m;  // rz, then |B|^2
  combine<T>(part, 2 * m, sums);
  int going = 0;
  for (int i = threadIdx.x; i < m; i += CG_THREADS) {
    const T bnorm = sqrt(sums[m + i]);
    const T target = rtol * (bnorm > 0 ? bnorm : T(1));
    state[S_RZ * m + i] = sums[i];
    state[S_TARGET * m + i] = target;
    going |= bnorm > target;  // |R| with R = B
  }
  going = __syncthreads_or(going);
  if (threadIdx.x == 0) ctl[C_FLAG] = going;
}

template <typename T, int V>
__global__ void __launch_bounds__(CG_THREADS)
cg_pap_kernel(const T* __restrict__ p, const T* __restrict__ ap, long long ap_sr,
              long long ap_sc, T* __restrict__ state, T* __restrict__ part,
              int* ctl, long long n, int m) {
  CG_BLOCK_PROLOGUE
  T acc[1][CG_ROWS];
#pragma unroll
  for (int i = 0; i < CG_ROWS; ++i) acc[0][i] = 0;
  for (long long c = c0; c < npk; c += stride) {
#pragma unroll
    for (int i = 0; i < CG_ROWS; ++i) {
      if (i < rows) {
        const Pack<T, V> pv = load<T, V>(p, (long long)(row0 + i) * n + c * V);
        const Pack<T, V> av = load_strided<T, V>(ap, ap_sr, ap_sc, row0 + i, c * V);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[0][i] = add_rn(acc[0][i], mul_rn(pv.v[e], av.v[e]));
      }
    }
  }
  block_partials<T, 1>(acc, part, m, row0, rows);
  if (!last_block(ctl)) return;
  T* sums = state + S_SUM * m;
  combine<T>(part, m, sums);
  for (int i = threadIdx.x; i < m; i += CG_THREADS) {
    const T pap = sums[i];
    state[S_ALPHA * m + i] = pap > 0 ? state[S_RZ * m + i] / pap : T(0);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(CG_THREADS)
cg_update_kernel(T* __restrict__ x, T* __restrict__ r, const T* __restrict__ p,
                 const T* __restrict__ ap, long long ap_sr, long long ap_sc,
                 const T* __restrict__ d, T* __restrict__ state, T* __restrict__ part, int* ctl,
                 long long n, int m) {
  CG_BLOCK_PROLOGUE
  T alpha[CG_ROWS];
  T acc[2][CG_ROWS];
#pragma unroll
  for (int i = 0; i < CG_ROWS; ++i) {
    alpha[i] = i < rows ? state[S_ALPHA * m + row0 + i] : T(0);
    acc[0][i] = acc[1][i] = 0;
  }
  for (long long c = c0; c < npk; c += stride) {
    Pack<T, V> dv{};
    if (d) dv = load<T, V>(d, c * V);
#pragma unroll
    for (int i = 0; i < CG_ROWS; ++i) {
      if (i < rows) {
        const long long off = (long long)(row0 + i) * n + c * V;
        // X and AP are read by no later kernel of the step: streamed
        Pack<T, V> xv = load<T, V, true>(x, off), rv = load<T, V>(r, off);
        const Pack<T, V> pv = load<T, V>(p, off);
        const Pack<T, V> av = load_strided<T, V, true>(ap, ap_sr, ap_sc, row0 + i, c * V);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          xv.v[e] = add_rn(xv.v[e], mul_rn(pv.v[e], alpha[i]));
          rv.v[e] = sub_rn(rv.v[e], mul_rn(av.v[e], alpha[i]));
          const T z = d ? mul_rn(rv.v[e], dv.v[e]) : rv.v[e];
          acc[0][i] = add_rn(acc[0][i], mul_rn(rv.v[e], z));
          acc[1][i] = add_rn(acc[1][i], mul_rn(rv.v[e], rv.v[e]));
        }
        store<T, V, true>(x, off, xv);
        store<T, V>(r, off, rv);
      }
    }
  }
  block_partials<T, 2>(acc, part, m, row0, rows);
  if (!last_block(ctl)) return;
  T* sums = state + S_SUM * m;  // R.Z, then |R|^2
  combine<T>(part, 2 * m, sums);
  int going = 0;
  for (int i = threadIdx.x; i < m; i += CG_THREADS) {
    const T rz = state[S_RZ * m + i], rz_new = sums[i];
    state[S_BETA * m + i] = rz > 0 ? rz_new / rz : T(0);
    state[S_RZ * m + i] = rz_new;
    going |= sqrt(sums[m + i]) > state[S_TARGET * m + i];
  }
  going = __syncthreads_or(going);
  if (threadIdx.x == 0) ctl[C_FLAG] = going;
}

template <typename T, int V>
__global__ void __launch_bounds__(CG_THREADS)
cg_direction_kernel(const T* __restrict__ r, T* __restrict__ p, const T* __restrict__ d,
                    const T* __restrict__ state, long long n, int m) {
  CG_BLOCK_PROLOGUE
  T beta[CG_ROWS];
#pragma unroll
  for (int i = 0; i < CG_ROWS; ++i) beta[i] = i < rows ? state[S_BETA * m + row0 + i] : T(0);
  for (long long c = c0; c < npk; c += stride) {
    Pack<T, V> dv{};
    if (d) dv = load<T, V>(d, c * V);
#pragma unroll
    for (int i = 0; i < CG_ROWS; ++i) {
      if (i < rows) {
        const long long off = (long long)(row0 + i) * n + c * V;
        const Pack<T, V> rv = load<T, V>(r, off);
        Pack<T, V> pv = load<T, V>(p, off);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const T z = d ? mul_rn(rv.v[e], dv.v[e]) : rv.v[e];
          pv.v[e] = add_rn(z, mul_rn(pv.v[e], beta[i]));
        }
        store<T, V>(p, off, pv);
      }
    }
  }
}

// The widest V (columns a thread) that n, every own pointer and the views
// allow: 16 bytes at most.
template <typename T>
static int pick_v(long long n, std::initializer_list<const void*> ptrs,
                  std::initializer_list<const View*> views) {
  for (int v = 16 / (int)sizeof(T); v > 1; v /= 2) {
    const size_t align = (size_t)v * sizeof(T);
    bool ok = n % v == 0;
    for (const void* q : ptrs) ok = ok && (size_t)q % align == 0;
    for (const View* a : views)
      ok = ok && a->sc == 1 && a->sr % v == 0 && (size_t)a->p % align == 0;
    if (ok) return v;
  }
  return 1;
}

static dim3 grid_of(long long n, int v, int m) {
  const long long packs = n / v;
  long long gx = (packs + CG_THREADS - 1) / CG_THREADS;
  if (gx > CG_MAX_BLOCKS) gx = CG_MAX_BLOCKS;
  return dim3((unsigned)gx, (unsigned)((m + CG_ROWS - 1) / CG_ROWS));
}

// Launches kernel K<T, V> for the V that pick_v chose.
#define CG_DISPATCH(K, v, grid, s, ...)                                               \
  do {                                                                                \
    if (v == 4) {                                                                     \
      if constexpr (sizeof(T) == 4) K<T, 4><<<grid, CG_THREADS, 0, s>>>(__VA_ARGS__); \
    } else if (v == 2) {                                                              \
      K<T, 2><<<grid, CG_THREADS, 0, s>>>(__VA_ARGS__);                               \
    } else {                                                                          \
      K<T, 1><<<grid, CG_THREADS, 0, s>>>(__VA_ARGS__);                               \
    }                                                                                 \
  } while (0)

template <typename T>
static int setup(View b, const void* d, void* x, void* r, void* p, void* state, void* part,
                 int* ctl, long long n, int m, double rtol, cudaStream_t s) {
  const int v = pick_v<T>(n, {d, x, r, p}, {&b});
  const dim3 grid = grid_of(n, v, m);
  cudaMemsetAsync(ctl, 0, 2 * sizeof(int), s);
  CG_DISPATCH(cg_setup_kernel, v, grid, s, (const T*)b.p, b.sr, b.sc, (const T*)d, (T*)x,
              (T*)r, (T*)p, (T*)state, (T*)part, ctl, n, m, (T)rtol);
  return (int)cudaGetLastError();
}

template <typename T>
static int pap(const void* p, View ap, void* state, void* part, int* ctl, long long n, int m,
               cudaStream_t s) {
  const int v = pick_v<T>(n, {p}, {&ap});
  CG_DISPATCH(cg_pap_kernel, v, grid_of(n, v, m), s, (const T*)p, (const T*)ap.p, ap.sr, ap.sc,
              (T*)state, (T*)part, ctl, n, m);
  return (int)cudaGetLastError();
}

template <typename T>
static int update(void* x, void* r, const void* p, View ap, const void* d, void* state,
                  void* part, int* ctl, long long n, int m, cudaStream_t s) {
  const int v = pick_v<T>(n, {x, r, p, d}, {&ap});
  CG_DISPATCH(cg_update_kernel, v, grid_of(n, v, m), s, (T*)x, (T*)r, (const T*)p,
              (const T*)ap.p, ap.sr, ap.sc, (const T*)d, (T*)state, (T*)part, ctl, n, m);
  return (int)cudaGetLastError();
}

template <typename T>
static int direction(const void* r, void* p, const void* d, const void* state, long long n,
                     int m, cudaStream_t s) {
  const int v = pick_v<T>(n, {r, p, d}, {});
  CG_DISPATCH(cg_direction_kernel, v, grid_of(n, v, m), s, (const T*)r, (T*)p, (const T*)d,
              (const T*)state, n, m);
  return (int)cudaGetLastError();
}

static bool bad(int value_bytes, long long n, int m) {
  return (value_bytes != 4 && value_bytes != 8) || n < 1 || m < 1 || m > 65535 * CG_ROWS;
}

extern "C" {

// value_bytes: 4 (float32) or 8 (float64), for every array but ctl (int32).
// B and AP are (m, n) with element strides (sr, sc); X, R, P are contiguous
// (m, n); d is n values or null (no preconditioner); state holds 6 * m
// values, part 2 * m * CG_MAX_BLOCKS, ctl two int32 (zeroed here). Each
// returns a cudaError_t as int.
int cg_setup_launch(int value_bytes, const void* b, long long b_sr, long long b_sc,
                    const void* d, void* x, void* r, void* p, void* state, void* part, void* ctl,
                    long long n, int m, double rtol, void* stream) {
  if (bad(value_bytes, n, m)) return (int)cudaErrorInvalidValue;
  const View bv{b, b_sr, b_sc};
  cudaStream_t s = (cudaStream_t)stream;
  return value_bytes == 4
             ? setup<float>(bv, d, x, r, p, state, part, (int*)ctl, n, m, rtol, s)
             : setup<double>(bv, d, x, r, p, state, part, (int*)ctl, n, m, rtol, s);
}

int cg_pap_launch(int value_bytes, const void* p, const void* ap, long long ap_sr,
                  long long ap_sc, void* state, void* part, void* ctl, long long n, int m,
                  void* stream) {
  if (bad(value_bytes, n, m)) return (int)cudaErrorInvalidValue;
  const View av{ap, ap_sr, ap_sc};
  cudaStream_t s = (cudaStream_t)stream;
  return value_bytes == 4 ? pap<float>(p, av, state, part, (int*)ctl, n, m, s)
                          : pap<double>(p, av, state, part, (int*)ctl, n, m, s);
}

int cg_update_launch(int value_bytes, void* x, void* r, const void* p, const void* ap,
                     long long ap_sr, long long ap_sc, const void* d, void* state, void* part,
                     void* ctl, long long n, int m, void* stream) {
  if (bad(value_bytes, n, m)) return (int)cudaErrorInvalidValue;
  const View av{ap, ap_sr, ap_sc};
  cudaStream_t s = (cudaStream_t)stream;
  return value_bytes == 4 ? update<float>(x, r, p, av, d, state, part, (int*)ctl, n, m, s)
                          : update<double>(x, r, p, av, d, state, part, (int*)ctl, n, m, s);
}

int cg_direction_launch(int value_bytes, const void* r, void* p, const void* d,
                        const void* state, long long n, int m, void* stream) {
  if (bad(value_bytes, n, m)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return value_bytes == 4 ? direction<float>(r, p, d, state, n, m, s)
                          : direction<double>(r, p, d, state, n, m, s);
}

// the partial sums' room a row of the multivector: part's length is
// 2 * m * cg_max_blocks()
int cg_max_blocks() { return CG_MAX_BLOCKS; }

}  // extern "C"
