// Ablation of the first version of the ELL SpMM of csrc/ell_spmm.cu,
// for Hopper (sm_90a): where did that kernel's microseconds go?
//
// Replaces experiments/gather_ablate.py::_variant_kernel (launched by
// run_variant), the experiment that times the TPU gather kernel against
// degraded copies of its body. The TPU body's mechanisms (a dynamic scratch
// load, take_along_axis on one 128-lane vreg) do not exist on this card, so
// what is ablated here is the port's own kernel as first written, whose
// design is this experiment's definition: one thread per row i holds
// KC (coefficient, column) pairs in registers and, for each of the m rows
// of X, gathers X[r, col] through L1/L2 and accumulates. One mechanism is
// removed at a time; each variant is still a defined function, so the card
// can hold it to a plain version:
//
//   full      Y[r,i] = sum_j data[i,j] * X[r, cols[i,j]]      K2's first body
//   nogather  Y[r,i] = sum_j data[i,j] * X[r, i']             i' = min(i, ncols-1)
//             the irregular address is gone: every term still issues its own
//             load of X (a volatile asm load, so the k loads per row of X
//             are not merged into one), but all of a warp's loads are
//             neighbours and hit in L1. The index stream is still loaded.
//   nodyn     Y[r,i] = sum_j data[i,j] * X[r, (i' + j) mod ncols]
//             the index stream is gone: the column is computed (a compare
//             and a subtract, no `%` in the inner loop), not loaded.
//   nofma     Y[r,i] = X[r, i'] + data[i,0]
//             the inner loop is gone: coefficients and indices are streamed
//             once (volatile asm loads, results dropped), X is read and Y
//             written once.
//
// The full body is a template over the register chunk KC and the threads of
// a block, so that the sweep that stood where the TPU's tile sweep stood
// (KC in {8, 16, 24, 32} x threads in {128, 256, 512}) has explicit
// arguments. With K2's first choice (KC from k, 256 threads) the full body
// here is K2's first version, statement for statement: every slot to k,
// one row of X at a time. The redesigned K2 (csrc/ell_spmm.cu) gives the
// same bits on finite X, so the full body is its bit check.
//
// What bounds them: the first version was held by its X gathers (one L1
// request per multiply-add, few in flight), not by bytes. The variants say
// which of the gather's irregular addresses, the index stream, or the
// inner loop's instructions kept it from its byte bound.
//
// Interface: plain C for ctypes; the launch goes on the caller's stream and
// the function returns cudaGetLastError().

#include <cuda_runtime.h>

enum { EA_FULL = 0, EA_NOGATHER = 1, EA_NODYN = 2, EA_NOFMA = 3 };

// threads the card should hold: 4 blocks of 256 on each of 132 SMs, as
// K2's first version aimed for
#define EA_TARGET_THREADS (528 * 256)

// loads the compiler must issue, one per call, whatever becomes of the value
__device__ __forceinline__ float load_f32_kept(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ int load_s32_kept(const int* p) {
  int v;
  asm volatile("ld.global.nc.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

template <int KC, int THREADS, int VARIANT>
__global__ void __launch_bounds__(THREADS)
ell_ablate_kernel(const float* __restrict__ data_t, const int* __restrict__ cols_t,
                  const float* __restrict__ x, float* __restrict__ y, int n, int k,
                  int ncols, int m, int rows_per_block) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const int r0 = blockIdx.y * rows_per_block;
  const int r1 = min(m, r0 + rows_per_block);
  const int ic = min(i, ncols - 1);
  if (VARIANT == EA_NOFMA) {
    for (int j = 0; j < k; ++j) {
      if (j) load_f32_kept(data_t + (size_t)j * n + i);
      load_s32_kept(cols_t + (size_t)j * n + i);
    }
    const float d0 = __ldg(data_t + i);
    for (int r = r0; r < r1; ++r)
      y[(size_t)r * n + i] = __ldg(x + (size_t)r * ncols + ic) + d0;
    return;
  }
  for (int j0 = 0; j0 < k; j0 += KC) {
    float val[KC];
    int col[KC];
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      val[j] = 0.f;
      col[j] = 0;
      if (j0 + j < k) {
        val[j] = __ldg(data_t + (size_t)(j0 + j) * n + i);
        if (VARIANT == EA_FULL) {
          col[j] = __ldg(cols_t + (size_t)(j0 + j) * n + i);
        } else if (VARIANT == EA_NOGATHER) {
          load_s32_kept(cols_t + (size_t)(j0 + j) * n + i);
        } else {  // EA_NODYN: k <= ncols (checked by the launcher), so one subtract
          const int c = ic + j0 + j;
          col[j] = c >= ncols ? c - ncols : c;
        }
      }
    }
    for (int r = r0; r < r1; ++r) {
      const float* xr = x + (size_t)r * ncols;
      float* yr = y + (size_t)r * n + i;
      float acc = j0 ? *yr : 0.f;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        if (j0 + j < k) {
          if (VARIANT == EA_NOGATHER)
            acc += val[j] * load_f32_kept(xr + ic);
          else
            acc += val[j] * __ldg(xr + col[j]);
        }
      }
      *yr = acc;
    }
  }
}

namespace {

struct Args {
  const float* data_t;
  const int* cols_t;
  const float* x;
  float* y;
  int n, k, ncols, m;
  cudaStream_t stream;
};

template <int KC, int THREADS, int VARIANT>
void launch(const Args& a) {
  const unsigned gx = (unsigned)((a.n + THREADS - 1) / THREADS);
  const unsigned target = EA_TARGET_THREADS / THREADS;
  int split = (int)((target + gx - 1) / gx);
  split = split < 1 ? 1 : (split > a.m ? a.m : split);
  const int rows_per_block = (a.m + split - 1) / split;
  const dim3 grid(gx, (unsigned)((a.m + rows_per_block - 1) / rows_per_block));
  ell_ablate_kernel<KC, THREADS, VARIANT><<<grid, THREADS, 0, a.stream>>>(
      a.data_t, a.cols_t, a.x, a.y, a.n, a.k, a.ncols, a.m, rows_per_block);
}

// the degraded variants exist at K2's first 256 threads only
template <int KC, int THREADS>
bool launch_variant(int variant, const Args& a) {
  if (variant == EA_FULL) {
    launch<KC, THREADS, EA_FULL>(a);
    return true;
  }
  if constexpr (THREADS == 256) {
    if (variant == EA_NOGATHER) {
      launch<KC, 256, EA_NOGATHER>(a);
    } else if (variant == EA_NODYN) {
      launch<KC, 256, EA_NODYN>(a);
    } else {
      launch<KC, 256, EA_NOFMA>(a);
    }
    return true;
  }
  return false;
}

template <int THREADS>
bool launch_kc(int kc, int variant, const Args& a) {
  switch (kc) {
    case 8: return launch_variant<8, THREADS>(variant, a);
    case 16: return launch_variant<16, THREADS>(variant, a);
    case 24: return launch_variant<24, THREADS>(variant, a);
    case 32: return launch_variant<32, THREADS>(variant, a);
  }
  return false;
}

}  // namespace

extern "C" {

// kc = 0 takes K2's first version's chunk for this k. Returns a
// cudaError_t as int.
int ell_ablate_launch(int variant, int kc, int threads, const void* data_t,
                      const void* cols_t, long long n, int k, long long ncols,
                      const void* x, void* y, int m, void* stream) {
  if (n < 1 || n > 0x7fffffffLL || ncols < 1 || ncols > 0x7fffffffLL || k < 1 || m < 1 ||
      variant < EA_FULL || variant > EA_NOFMA || (variant == EA_NODYN && k > ncols))
    return (int)cudaErrorInvalidValue;
  if (kc == 0) kc = k <= 8 ? 8 : (k <= 16 ? 16 : (k <= 24 ? 24 : 32));
  const Args a = {(const float*)data_t, (const int*)cols_t, (const float*)x, (float*)y,
                  (int)n, k, (int)ncols, m, (cudaStream_t)stream};
  bool ok = false;
  if (threads == 128) ok = launch_kc<128>(kc, variant, a);
  else if (threads == 256) ok = launch_kc<256>(kc, variant, a);
  else if (threads == 512) ok = launch_kc<512>(kc, variant, a);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
