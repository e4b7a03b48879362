// The geometric multigrid V-cycle's coarse tail in one launch, for Hopper
// (sm_90a): factorize/multigrid.py's _vcycle_coarse from the first level whose
// working set fits one block's shared memory down to the coarsest CG and back.
//
// Replaces no TPU kernel: the JAX package's factorize/multigrid.py runs these
// levels as XLA operations fused by its compiler. Added because the eager
// recursion launches ~2,400 PyTorch operations a V-cycle on a few megabytes
// (the 48-step CG at the coarsest grid alone ~40 a step: the stencil through
// zeros_like and torch.cat, two dots, the step lengths, four axpys), each
// ~1.4 us of device time, so the tail cost ~3.5 ms a V-cycle against a bound
// of tens of microseconds.
//
// What bounds it: neither bytes (under 2 MB in and out at the north star's
// (24, 27^3) bf16 entry, ~1 us at 3.35 TB/s) nor flops, but the chain of
// dependent steps: the levels' sweeps, each a block barrier, and the coarsest
// CG's steps, each with two reductions. The design keeps the whole tail of
// one row of the (m, *dims) block in one thread block's shared memory (opted
// in above 48 KB; the wrapper's fit rule, kernels/mg_tail.py::tail_bytes,
// computes the same layout), so a sweep is a barrier and not a launch:
//
//   per level above the coarsest, three arrays of the level's type: b, x and
//   a temporary (the Jacobi sweep's new x, then the residual); at the
//   coarsest, b in the level type and the CG's x, r, p, Ap in f32, and two
//   rows of the CG's per-warp partial sums.
//
// Stencils, restriction and prolongation are index maps between those arrays
// (Dirichlet zero outside: a neighbour past the edge reads 0), with no zero
// tensors or concatenations; 1,024 threads walk a level's points without a
// division. The coarsest CG runs on as many warps as hold one point a thread
// (7 at 6^3): a step is three block barriers, its dots a butterfly of
// shuffles a warp and one over the warps' sums.
//
// Arithmetic: each elementwise operation is the eager path's, in its order,
// rounded on its own to the level's type (bf16 levels compute in f32 and round
// each result to bf16, as PyTorch's bf16 kernels do; __fmul_rn etc.: never
// contracted into an FMA). Restriction and prolongation are separable in the
// eager path, one axis at a time from the slowest, each pass rounded; here a
// point composes the three passes from the values it needs, rounding at the
// same places. The per-level coefficients are computed from the 0-d device
// tensors as the eager path computes them (a_l = a 4^-l, c0_l = sigma - 2
// sum(a_l), inv_c = c0_l^-1 omega in f32, then cast), so there is no host read.
// Only the coarsest CG's dots are summed in another order (each thread its
// points in turn, each warp's butterfly, then a butterfly over the warps'
// sums): a fixed
// order, so the bits repeat from run to run, and where every dot has one term
// the result is the eager path's bit for bit.
//
// Interface: plain C, loaded with ctypes; the launch goes on the caller's
// stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define TAIL_THREADS 1024
#define TAIL_WARPS (TAIL_THREADS / 32)
#define TAIL_MAX_LEVELS 16  // kernels/mg_tail.py::MAX_LEVELS

struct TailGeom {
  int nlev;    // levels of the tail, the coarsest last
  int nd;      // grid axes, 2 or 3
  int level0;  // the tail's first level in the V-cycle: its couplings scale by 4^-level0
  int dims[TAIL_MAX_LEVELS][3];  // (nz, ny, nx) a level, nz = 1 in 2D
};

// The level type T, its arithmetic type F, and the rounding between them.
template <typename T> struct Num;
template <> struct Num<__nv_bfloat16> {
  using F = float;
  static __device__ __forceinline__ float up(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 down(float v) { return __float2bfloat16_rn(v); }
  // the coarsest CG's f32 from a level value, and back (b.to(float32), x.to(b.dtype))
  static __device__ __forceinline__ float to_cg(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 from_cg(float v) { return __float2bfloat16_rn(v); }
};
template <> struct Num<float> {
  using F = float;
  static __device__ __forceinline__ float up(float v) { return v; }
  static __device__ __forceinline__ float down(float v) { return v; }
  static __device__ __forceinline__ float to_cg(float v) { return v; }
  static __device__ __forceinline__ float from_cg(float v) { return v; }
};
template <> struct Num<double> {
  using F = double;
  static __device__ __forceinline__ double up(double v) { return v; }
  static __device__ __forceinline__ double down(double v) { return v; }
  static __device__ __forceinline__ float to_cg(double v) { return __double2float_rn(v); }
  static __device__ __forceinline__ double from_cg(float v) { return (double)v; }
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// one PyTorch operation of the level type: computed in F, rounded to T
template <typename T> struct Op {
  using F = typename Num<T>::F;
  static __device__ __forceinline__ F rnd(F v) { return Num<T>::up(Num<T>::down(v)); }
  static __device__ __forceinline__ F mul(F a, F b) { return rnd(mul_rn(a, b)); }
  static __device__ __forceinline__ F add(F a, F b) { return rnd(add_rn(a, b)); }
  static __device__ __forceinline__ F sub(F a, F b) { return rnd(sub_rn(a, b)); }
};

// A level's stencil in the level type, and its f32 values for the CG.
template <typename F> struct Coef {
  F c0, a[3], inv_c;
};

// _vcycle_coarse's coefficients at level ``level``, in f32 as PyTorch computes
// them on the 0-d tensors: a_l = a * 0.25**level, c0_l = sigma - 2.0 * sum(a_l)
// (Python's sum: 0 + a_l[0] + ...), inv_c = omega / c0_l = c0_l.reciprocal() * omega
__device__ __forceinline__ Coef<float> coef_f32(const float* const* a, const float* sigma,
                                                int nd, int level, float omega) {
  Coef<float> k;
  const float s = ldexpf(1.0f, -2 * level);
  float sum = 0.0f;
  for (int ax = 0; ax < 3; ++ax) {
    k.a[ax] = ax < nd ? __fmul_rn(*a[ax], s) : 0.0f;
    if (ax < nd) sum = __fadd_rn(sum, k.a[ax]);
  }
  k.c0 = __fsub_rn(*sigma, __fmul_rn(sum, 2.0f));
  k.inv_c = __fmul_rn(__fdiv_rn(1.0f, k.c0), omega);
  return k;
}

// the same cast to the level type (a_l.to(dt), c0_l.to(dt), inv_c.to(dt))
template <typename T>
__device__ __forceinline__ Coef<typename Num<T>::F> coef_level(const Coef<float>& k) {
  Coef<typename Num<T>::F> c;
  c.c0 = Num<T>::up(Num<T>::down(k.c0));
  for (int ax = 0; ax < 3; ++ax) c.a[ax] = Num<T>::up(Num<T>::down(k.a[ax]));
  c.inv_c = Num<T>::up(Num<T>::down(k.inv_c));
  return c;
}

// _stencil_apply at one point of X (dims nz, ny, nx): c0 x, then for each axis
// from the fastest, + a (x[+1] + x[-1]), a neighbour past the edge 0
template <typename T>
__device__ __forceinline__ typename Num<T>::F stencil(const T* X, int z, int y, int x, int nz,
                                                      int ny, int nx, int nd,
                                                      const Coef<typename Num<T>::F>& c) {
  using O = Op<T>;
  using F = typename Num<T>::F;
  const int p = (z * ny + y) * nx + x;
  const F zero = F(0);
  F v = O::mul(c.c0, Num<T>::up(X[p]));
  F s = O::add(x + 1 < nx ? Num<T>::up(X[p + 1]) : zero, x > 0 ? Num<T>::up(X[p - 1]) : zero);
  v = O::add(v, O::mul(c.a[0], s));
  s = O::add(y + 1 < ny ? Num<T>::up(X[p + nx]) : zero, y > 0 ? Num<T>::up(X[p - nx]) : zero);
  v = O::add(v, O::mul(c.a[1], s));
  if (nd == 3) {
    const int pl = nx * ny;
    s = O::add(z + 1 < nz ? Num<T>::up(X[p + pl]) : zero, z > 0 ? Num<T>::up(X[p - pl]) : zero);
    v = O::add(v, O::mul(c.a[2], s));
  }
  return v;
}

// _restrict1's weights: 0.25 f[2j] + 0.5 f[2j+1] + 0.25 f[2j+2], left to right
template <typename T>
__device__ __forceinline__ typename Num<T>::F weigh(typename Num<T>::F u0, typename Num<T>::F u1,
                                                    typename Num<T>::F u2) {
  using O = Op<T>;
  using F = typename Num<T>::F;
  return O::add(O::add(O::mul(u0, F(0.25)), O::mul(u1, F(0.5))), O::mul(u2, F(0.25)));
}

// _restrict at coarse point (cz, cy, cx) of R (fine dims nz, ny, nx): the
// z pass, then y, then x, each over the previous pass's values, zero past the
// fine extent of the axis it weighs
template <typename T>
__device__ __forceinline__ typename Num<T>::F restrict_point(const T* R, int cz, int cy, int cx,
                                                             int nz, int ny, int nx, int nd) {
  using F = typename Num<T>::F;
  F vx[3];
  for (int ix = 0; ix < 3; ++ix) {
    const int fx = 2 * cx + ix;
    vx[ix] = F(0);
    if (fx >= nx) continue;
    F vy[3];
    for (int iy = 0; iy < 3; ++iy) {
      const int fy = 2 * cy + iy;
      vy[iy] = F(0);
      if (fy >= ny) continue;
      if (nd == 3) {
        F vz[3];
        for (int iz = 0; iz < 3; ++iz) {
          const int fz = 2 * cz + iz;
          vz[iz] = fz < nz ? Num<T>::up(R[(fz * ny + fy) * nx + fx]) : F(0);
        }
        vy[iy] = weigh<T>(vz[0], vz[1], vz[2]);
      } else {
        vy[iy] = Num<T>::up(R[fy * nx + fx]);
      }
    }
    vx[ix] = weigh<T>(vy[0], vy[1], vy[2]);
  }
  return weigh<T>(vx[0], vx[1], vx[2]);
}

// _prolong1 along one axis at fine index f from coarse extent M: odd f copies
// c[f/2]; even f = 2j < 2M is 0.5 (c[j-1] + c[j]), c[-1] = 0; f = 2M (an odd
// fine extent 2M+1) is 0.5 c[M-1]
struct Plan {
  int kind, j;  // kind 0 copy c[j], 1 the mean of c[j-1] and c[j], 2 half of c[j]
};
__device__ __forceinline__ Plan plan(int f, int M) {
  if (f & 1) return {0, f >> 1};
  if ((f >> 1) < M) return {1, f >> 1};
  return {2, M - 1};
}
template <typename T>
__device__ __forceinline__ typename Num<T>::F interp(Plan p, typename Num<T>::F lo,
                                                     typename Num<T>::F hi) {
  using O = Op<T>;
  using F = typename Num<T>::F;
  if (p.kind == 0) return hi;
  if (p.kind == 1) return O::mul(O::add(lo, hi), F(0.5));
  return O::mul(hi, F(0.5));
}

// _prolong at fine point (fz, fy, fx) from C (coarse dims mz, my, mx): the z
// pass, then y, then x, as restrict_point
template <typename T>
__device__ __forceinline__ typename Num<T>::F prolong_point(const T* C, int fz, int fy, int fx,
                                                            int mz, int my, int mx, int nd) {
  using F = typename Num<T>::F;
  const Plan px = plan(fx, mx), py = plan(fy, my);
  const Plan pz = nd == 3 ? plan(fz, mz) : Plan{0, 0};
  auto at_z = [&](int qy, int qx) -> F {  // the z pass at (fz, qy, qx)
    const F hi = Num<T>::up(C[(pz.j * my + qy) * mx + qx]);
    if (nd != 3) return hi;
    const F lo = (pz.kind == 1 && pz.j > 0) ? Num<T>::up(C[((pz.j - 1) * my + qy) * mx + qx])
                                            : F(0);
    return interp<T>(pz, lo, hi);
  };
  auto at_y = [&](int qx) -> F {  // the y pass at (fz, fy, qx)
    const F hi = at_z(py.j, qx);
    const F lo = (py.kind == 1 && py.j > 0) ? at_z(py.j - 1, qx) : F(0);
    return interp<T>(py, lo, hi);
  };
  const F hi = at_y(px.j);
  const F lo = (px.kind == 1 && px.j > 0) ? at_y(px.j - 1) : F(0);
  return interp<T>(px, lo, hi);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__host__ __device__ __forceinline__ long long align16(long long b) { return (b + 15) & ~15LL; }

__host__ __device__ __forceinline__ int points(const TailGeom& g, int l) {
  return g.dims[l][0] * g.dims[l][1] * g.dims[l][2];
}

// the shared-memory layout's bytes: kernels/mg_tail.py::tail_bytes
static long long tail_bytes(const TailGeom& g, int value_bytes) {
  long long total = 0;
  for (int l = 0; l + 1 < g.nlev; ++l) total += 3 * align16((long long)points(g, l) * value_bytes);
  const long long nc = points(g, g.nlev - 1);
  return total + align16(nc * value_bytes) + 4 * align16(nc * 4) + 2 * TAIL_WARPS * 4;
}

// The points start, start + step, ... of an (nz, ny, nx) grid as (z, y, x),
// stepped without a division
struct Walk {
  int z, y, x, sz, sy, sx;
  __device__ __forceinline__ Walk(int start, int step, int ny, int nx) {
    x = start % nx;
    y = (start / nx) % ny;
    z = start / (nx * ny);
    sx = step % nx;
    sy = (step / nx) % ny;
    sz = step / (nx * ny);
  }
  __device__ __forceinline__ void next(int ny, int nx) {
    x += sx;
    y += sy;
    z += sz;
    if (x >= nx) { x -= nx; ++y; }
    if (y >= ny) { y -= ny; ++z; }
  }
};

// fn(i, z, y, x) for this thread's points of an n-point grid from ``w``, the
// walk from this thread's first point, threads [0, nthreads) taking every
// nthreads-th point
template <typename Fn>
__device__ __forceinline__ void for_points(Walk w, int nthreads, int n, int ny, int nx, Fn fn) {
  if ((int)threadIdx.x >= nthreads) return;
  for (int i = threadIdx.x; i < n; i += nthreads, w.next(ny, nx)) fn(i, w.z, w.y, w.x);
}
template <typename Fn>
__device__ __forceinline__ void for_points(int nthreads, int n, int ny, int nx, Fn fn) {
  for_points(Walk(threadIdx.x, nthreads, ny, nx), nthreads, n, ny, nx, fn);
}

// The sum over the CG's threads of each one's partial, in a fixed order: each
// warp's butterfly, then a butterfly over the warps' sums (0 past cg_warps),
// the same in every thread. ``part`` holds TAIL_WARPS floats; the caller's
// barrier before the next write to the same ``part`` keeps the reads ahead of
// it.
__device__ __forceinline__ float cg_sum(float v, float* part, int cg_warps) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31;
  if (lane == 0 && (int)(threadIdx.x >> 5) < cg_warps) part[threadIdx.x >> 5] = v;
  __syncthreads();
  return warp_sum(lane < cg_warps ? part[lane] : 0.0f);
}

// The coarsest CG (_coarse_cg) on the first cg_warps warps (one point a
// thread at the north star's 6^3), the whole block at its barriers: b from bc
// (the level type), x back into bc. x, r and Ap are each thread's own points;
// p is read by the neighbours, so a barrier follows its update.
template <typename T>
__device__ void coarsest_cg(T* bc, float* x, float* r, float* p, float* ap, float* part,
                            int nz, int ny, int nx, int nd, const Coef<float>& c, int iters) {
  const int n = nz * ny * nx;
  const int cg_warps = min(TAIL_WARPS, (n + 31) / 32);
  const int nt = 32 * cg_warps;
  const Walk w(threadIdx.x, nt, ny, nx);  // each loop walks this thread's points from here
  float acc = 0.0f;
  for_points(w, nt, n, ny, nx, [&](int i, int, int, int) {
    const float v = Num<T>::to_cg(bc[i]);
    r[i] = v;
    p[i] = v;
    x[i] = 0.0f;
    acc = __fadd_rn(acc, __fmul_rn(v, v));
  });
  float rz = cg_sum(acc, part + TAIL_WARPS, cg_warps);  // the row the first step's p.Ap leaves
  for (int it = 0; it < iters; ++it) {
    acc = 0.0f;
    for_points(w, nt, n, ny, nx, [&](int i, int z, int y, int xx) {
      const float v = stencil<float>(p, z, y, xx, nz, ny, nx, nd, c);
      ap[i] = v;
      acc = __fadd_rn(acc, __fmul_rn(p[i], v));
    });
    const float pap = cg_sum(acc, part, cg_warps);
    const float alpha = pap > 0.0f ? __fdiv_rn(rz, pap) : 0.0f;
    acc = 0.0f;
    for_points(w, nt, n, ny, nx, [&](int i, int, int, int) {
      x[i] = __fadd_rn(x[i], __fmul_rn(alpha, p[i]));
      const float ri = __fsub_rn(r[i], __fmul_rn(alpha, ap[i]));
      r[i] = ri;
      acc = __fadd_rn(acc, __fmul_rn(ri, ri));
    });
    const float rz_new = cg_sum(acc, part + TAIL_WARPS, cg_warps);
    const float beta = rz > 0.0f ? __fdiv_rn(rz_new, rz) : 0.0f;
    for_points(w, nt, n, ny, nx, [&](int i, int, int, int) {
      p[i] = __fadd_rn(r[i], __fmul_rn(beta, p[i]));
    });
    __syncthreads();
    rz = rz_new;
  }
  for_points(w, nt, n, ny, nx, [&](int i, int, int, int) { bc[i] = Num<T>::from_cg(x[i]); });
}

// One block a row of the (m, *dims) block b; out the same shape.
template <typename T>
__global__ void __launch_bounds__(TAIL_THREADS)
    mg_tail_kernel(const T* __restrict__ b, T* __restrict__ out, const float* a0,
                   const float* a1, const float* a2, const float* sigma, TailGeom g, int nu1,
                   int nu2, float omega, int iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  using F = typename Num<T>::F;
  using O = Op<T>;
  const float* a[3] = {a0, a1, a2};
  const int nl = g.nlev - 1;  // levels above the coarsest
  T* lb[TAIL_MAX_LEVELS];
  T* lx[TAIL_MAX_LEVELS];
  T* lt[TAIL_MAX_LEVELS];
  unsigned char* at = smem;
  for (int l = 0; l < nl; ++l) {
    const long long bytes = align16((long long)points(g, l) * sizeof(T));
    lb[l] = (T*)at;
    lx[l] = (T*)(at + bytes);
    lt[l] = (T*)(at + 2 * bytes);
    at += 3 * bytes;
  }
  const int nc = points(g, nl);
  T* bc = (T*)at;
  at += align16((long long)nc * sizeof(T));
  const long long fb = align16((long long)nc * 4);
  float* cx = (float*)at;
  float* cr = (float*)(at + fb);
  float* cp = (float*)(at + 2 * fb);
  float* cap = (float*)(at + 3 * fb);
  float* part = (float*)(at + 4 * fb);  // 2 * TAIL_WARPS partial sums

  const int tid = threadIdx.x;
  const long long n0 = points(g, 0);
  T* in = nl > 0 ? lb[0] : bc;
  const T* brow = b + blockIdx.x * n0;
#pragma unroll 8
  for (int i = tid; i < n0; i += TAIL_THREADS) in[i] = brow[i];  // eight loads in flight
  __syncthreads();

  // a damped-Jacobi sweep of level l: lt = lx + inv_c (lb - A lx), then swap
  auto sweep = [&](int l, const Coef<F>& c) {
    const int nz = g.dims[l][0], ny = g.dims[l][1], nx = g.dims[l][2];
    const T* X = lx[l];
    const T* B = lb[l];
    T* Y = lt[l];
    for_points(TAIL_THREADS, nz * ny * nx, ny, nx, [&](int i, int z, int y, int x) {
      const F d = O::sub(Num<T>::up(B[i]), stencil<T>(X, z, y, x, nz, ny, nx, g.nd, c));
      Y[i] = Num<T>::down(O::add(Num<T>::up(X[i]), O::mul(c.inv_c, d)));
    });
    __syncthreads();
    lt[l] = lx[l];
    lx[l] = Y;
  };

  // down: pre-smoothing, the residual, its restriction into the next level's b
  for (int l = 0; l < nl; ++l) {
    const int nz = g.dims[l][0], ny = g.dims[l][1], nx = g.dims[l][2];
    const Coef<F> c = coef_level<T>(coef_f32(a, sigma, g.nd, g.level0 + l, omega));
    const T* B = lb[l];
    T* X = lx[l];
    for (int i = tid; i < nz * ny * nx; i += TAIL_THREADS)
      X[i] = Num<T>::down(O::mul(c.inv_c, Num<T>::up(B[i])));
    __syncthreads();
    for (int s = 0; s < nu1 - 1; ++s) sweep(l, c);
    const T* Xs = lx[l];
    T* R = lt[l];
    for_points(TAIL_THREADS, nz * ny * nx, ny, nx, [&](int i, int z, int y, int x) {
      R[i] = Num<T>::down(O::sub(Num<T>::up(B[i]), stencil<T>(Xs, z, y, x, nz, ny, nx, g.nd, c)));
    });
    __syncthreads();
    const int mz = g.dims[l + 1][0], my = g.dims[l + 1][1], mx = g.dims[l + 1][2];
    T* next = l + 1 < nl ? lb[l + 1] : bc;
    for_points(TAIL_THREADS, mz * my * mx, my, mx, [&](int i, int z, int y, int x) {
      next[i] = Num<T>::down(restrict_point<T>(R, z, y, x, nz, ny, nx, g.nd));
    });
    __syncthreads();
  }

  // the coarsest: fixed-iteration CG in f32 with its own f32 coefficients
  coarsest_cg<T>(bc, cx, cr, cp, cap, part, g.dims[nl][0], g.dims[nl][1], g.dims[nl][2], g.nd,
                 coef_f32(a, sigma, g.nd, g.level0 + nl, omega), iters);
  __syncthreads();

  // up: the prolonged correction, then post-smoothing
  for (int l = nl - 1; l >= 0; --l) {
    const int nz = g.dims[l][0], ny = g.dims[l][1], nx = g.dims[l][2];
    const int mz = g.dims[l + 1][0], my = g.dims[l + 1][1], mx = g.dims[l + 1][2];
    const Coef<F> c = coef_level<T>(coef_f32(a, sigma, g.nd, g.level0 + l, omega));
    const T* e = l + 1 < nl ? lx[l + 1] : bc;
    T* X = lx[l];
    for_points(TAIL_THREADS, nz * ny * nx, ny, nx, [&](int i, int z, int y, int x) {
      X[i] = Num<T>::down(O::add(Num<T>::up(X[i]), prolong_point<T>(e, z, y, x, mz, my, mx, g.nd)));
    });
    __syncthreads();
    for (int s = 0; s < nu2; ++s) sweep(l, c);
  }

  const T* res = nl > 0 ? lx[0] : bc;
  T* orow = out + blockIdx.x * n0;
#pragma unroll 8
  for (int i = tid; i < n0; i += TAIL_THREADS) orow[i] = res[i];
}

template <typename T>
static int launch(const void* b, void* out, int m, const TailGeom& g, const float* a0,
                  const float* a1, const float* a2, const float* sigma, int nu1, int nu2,
                  float omega, int iters, long long bytes, cudaStream_t s) {
  // the opt-in a device has been given for this instantiation (0: the default 48 KB)
  static long long opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (bytes > 48 * 1024 && bytes > opted[dev]) {
    err = cudaFuncSetAttribute(mg_tail_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    opted[dev] = bytes;
  }
  mg_tail_kernel<T><<<m, TAIL_THREADS, bytes, s>>>((const T*)b, (T*)out, a0, a1, a2, sigma, g,
                                                   nu1, nu2, omega, iters);
  return (int)cudaGetLastError();
}

extern "C" {

// dtype: 0 bfloat16, 1 float32, 2 float64 (b and out, both contiguous (m, *dims[0]));
// dims: nlev * 3 ints (nz, ny, nx) a level, the tail's first level first, nz = 1 for a
// 2D grid (nd = 2); a0, a1, a2, sigma: the fine couplings (fastest axis first; a2
// null in 2D) and the zeroth-order term, 0-d f32 device tensors; bytes: the
// shared memory the caller computed for this layout (refused unless it is the
// kernel's). Returns a cudaError_t as int.
int mg_tail_launch(int dtype, const void* b, void* out, int m, int nd, int nlev, int level0,
                   const int* dims, const void* a0, const void* a1, const void* a2,
                   const void* sigma, int nu1, int nu2, double omega, int iters,
                   long long bytes, void* stream) {
  if (dtype < 0 || dtype > 2 || m < 1 || (nd != 2 && nd != 3) || nlev < 1 ||
      nlev > TAIL_MAX_LEVELS || level0 < 0 || iters < 0 || !a0 || !a1 || (nd == 3 && !a2) ||
      !sigma)
    return (int)cudaErrorInvalidValue;
  TailGeom g;
  g.nlev = nlev;
  g.nd = nd;
  g.level0 = level0;
  for (int l = 0; l < nlev; ++l) {
    for (int k = 0; k < 3; ++k) {
      g.dims[l][k] = dims[3 * l + k];
      if (g.dims[l][k] < 1) return (int)cudaErrorInvalidValue;
    }
    if (nd == 2 && g.dims[l][0] != 1) return (int)cudaErrorInvalidValue;
    if (l > 0)
      for (int k = 3 - nd; k < 3; ++k)
        if (g.dims[l][k] != g.dims[l - 1][k] / 2) return (int)cudaErrorInvalidValue;
  }
  const int value_bytes = dtype == 0 ? 2 : dtype == 1 ? 4 : 8;
  if (bytes != tail_bytes(g, value_bytes)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float *f0 = (const float*)a0, *f1 = (const float*)a1, *f2 = (const float*)a2,
              *fs = (const float*)sigma;
  const float om = (float)omega;
  switch (dtype) {
    case 0: return launch<__nv_bfloat16>(b, out, m, g, f0, f1, f2, fs, nu1, nu2, om, iters, bytes, s);
    case 1: return launch<float>(b, out, m, g, f0, f1, f2, fs, nu1, nu2, om, iters, bytes, s);
    default: return launch<double>(b, out, m, g, f0, f1, f2, fs, nu1, nu2, om, iters, bytes, s);
  }
}

// the shared memory a block may opt in to on ``device`` (bytes), or -error
int mg_tail_smem_optin(int device) {
  int v = 0;
  cudaError_t err = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? v : -(int)err;
}

}  // extern "C"
