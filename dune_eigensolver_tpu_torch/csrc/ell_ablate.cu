// Ablation of the ELL SpMM K2 (csrc/ell_spmm.cu), for Hopper (sm_90a):
// where do its microseconds go?
//
// Replaces experiments/gather_ablate.py::_variant_kernel (launched by
// run_variant), the experiment that times the shipped TPU gather kernel
// against degraded copies of its body. The TPU body's mechanisms (a dynamic
// scratch load, take_along_axis on one 128-lane vreg) do not exist on this
// card, so what is ablated here is the body K2 ships, csrc/ell_body.cuh,
// one mechanism at a time. Each variant is still a defined function (the
// header states them), so the card holds it to a plain version:
//
//   nogather  no irregular address: every term loads X at the row's own
//             column; K2's coefficient and index streams, and its one X
//             load a term, stay
//   nodyn     no index stream: the column is computed, not loaded; the
//             coefficient stream and the X loads stay
//   nofma     no inner loop: K2's coefficient and index streams loaded once
//             (XOR-folded, not multiplied), X read and Y written once
//
// As the reference's BlockSpecs bring every variant the (smax, Tr) blocks
// of data and lanes, nogather and nofma load every slot K2 loads (to the
// warp counts). A loaded value that nothing reads would be removed by
// ptxas, so each has a reader the compiler cannot prove idle: nogather
// adds (index & 0) to its column, nofma stores its fold only on a value no
// fold can take, the 0 and that value being a kernel argument
// (ell_body.cuh, ELL_NEVER). experiments/gather_ablate.py::slot_loads
// counts the loads in the SASS; chip_smoke.py and a card test hold them
// to K2's.
//
// They are instantiated at K2's constants (ELL_ROWS, ELL_KC, its register
// caps) and read K2's index stream (int16 offsets or int32 columns). Where
// the TPU experiment swept its row tile, this one sweeps K2's two knobs,
// the rows of X in flight (ROWS) and the register chunk (KC), on the same
// body (ELL_FULL); every setting gives K2's bits, and K2's own (8, 9) is
// one of them.
//
// K2's first version (its body before the redesign) stays here as
// its bit check and as the baseline its time is taken in turns with:
// ell_first_kernel, statement for statement that body at 256 threads and
// KC from k (8, 16, 24 or 32), reading int32 columns. It holds one row of X
// in flight and a chunk of KC gathers under a per-slot predicate; on finite
// X it gives K2's bits.
//
// What bounds them: K2 is held by its X gathers (one L1 request per
// multiply-add), not by bytes. The variants split the rest of K2's time
// against its copy bound: the gathers' irregular addresses, the index
// stream, the inner loop's instructions.
//
// Interface: plain C for ctypes; the launch goes on the caller's stream and
// the function returns cudaGetLastError().

#include "ell_body.cuh"

// threads the card should hold with the first version: 4 blocks of 256 on
// each of 132 SMs, as that version aimed for
#define EA_FIRST_TARGET_THREADS (528 * 256)

// The sweep's ELL_FULL instantiations live in ell_sweep_r{1,4,8}.cu, one
// source (one nvcc, all built together) for each of ROWS 1, 4, 8, each
// with KC 6, 8, 9 and 12 (csrc/ell_sweep.cuh); K2's own (8, 9) is one of
// them. experiments/gather_ablate.py SWEEP lists the same settings.
extern "C" {
int ell_sweep_launch_r1(int kc, dim3 grid, cudaStream_t s, const void* data_t,
                        const void* cols_t, int index_bytes, const int* slots, const void* x,
                        void* y, int n, int ncols, int m, int rows_per_block);
int ell_sweep_launch_r4(int kc, dim3 grid, cudaStream_t s, const void* data_t,
                        const void* cols_t, int index_bytes, const int* slots, const void* x,
                        void* y, int n, int ncols, int m, int rows_per_block);
int ell_sweep_launch_r8(int kc, dim3 grid, cudaStream_t s, const void* data_t,
                        const void* cols_t, int index_bytes, const int* slots, const void* x,
                        void* y, int n, int ncols, int m, int rows_per_block);
}

template <int KC>
__global__ void __launch_bounds__(256)
ell_first_kernel(const float* __restrict__ data_t, const int* __restrict__ cols_t,
                 const float* __restrict__ x, float* __restrict__ y, int n, int k,
                 int ncols, int m, int rows_per_block) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  const int r0 = blockIdx.y * rows_per_block;
  const int r1 = min(m, r0 + rows_per_block);
  for (int j0 = 0; j0 < k; j0 += KC) {
    float val[KC];
    int col[KC];
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      val[j] = 0.f;
      col[j] = 0;
      if (j0 + j < k) {
        val[j] = __ldg(data_t + (size_t)(j0 + j) * n + i);
        col[j] = __ldg(cols_t + (size_t)(j0 + j) * n + i);
      }
    }
    for (int r = r0; r < r1; ++r) {
      const float* xr = x + (size_t)r * ncols;
      float* yr = y + (size_t)r * n + i;
      float acc = j0 ? *yr : 0.f;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        if (j0 + j < k) acc += val[j] * __ldg(xr + col[j]);
      }
      *yr = acc;
    }
  }
}

namespace {

struct Args {
  const void* data_t;
  const void* cols_t;
  int index_bytes;
  const int* slots;
  const void* x;
  void* y;
  int n, ncols, m;
  cudaStream_t stream;
};

template <int V, int ROWS, int KC>
void launch(const Args& a) {
  int rows_per_block;
  const dim3 grid = ell_grid(a.n, a.m, &rows_per_block);
  ell_body_launch<V, ROWS, KC, ELL_MIN_BLOCKS_I16, ELL_MIN_BLOCKS, float>(
      grid, a.stream, a.data_t, a.cols_t, a.index_bytes, a.slots, a.x, a.y, a.n, a.ncols, a.m,
      rows_per_block);
}

template <int KC>
void launch_first(const float* data_t, const int* cols_t, const float* x, float* y, int n, int k,
                  int ncols, int m, cudaStream_t s) {
  const unsigned gx = (unsigned)((n + 255) / 256);
  const unsigned target = EA_FIRST_TARGET_THREADS / 256;
  int split = (int)((target + gx - 1) / gx);
  split = split < 1 ? 1 : (split > m ? m : split);
  const int rows_per_block = (m + split - 1) / split;
  const dim3 grid(gx, (unsigned)((m + rows_per_block - 1) / rows_per_block));
  ell_first_kernel<KC><<<grid, 256, 0, s>>>(data_t, cols_t, x, y, n, k, ncols, m,
                                            rows_per_block);
}

}  // namespace

extern "C" {

// variant 0 (ELL_FULL) at the sweep setting (rows, kc); 1-3 the degraded
// variants, which exist at K2's (ELL_ROWS, ELL_KC) alone. cols_t: K2's
// index stream, (k, n) int16 offsets (index_bytes 2) or int32 columns (4);
// warp_slots: K2's ceil(n / 32) counts. Returns a cudaError_t as int.
int ell_ablate_launch(int variant, int rows, int kc, const void* data_t, const void* cols_t,
                      int index_bytes, const void* warp_slots, long long n, int k,
                      long long ncols, const void* x, void* y, int m, void* stream) {
  if (n < 1 || n > 0x7fffffffLL || ncols < 1 || ncols > 0x7fffffffLL || k < 1 || m < 1 ||
      (index_bytes != 2 && index_bytes != 4) || variant < ELL_FULL || variant > ELL_NOFMA ||
      (variant == ELL_NODYN && k > ncols))
    return (int)cudaErrorInvalidValue;
  const Args a = {data_t, cols_t, index_bytes, (const int*)warp_slots, x, y,
                  (int)n, (int)ncols, m, (cudaStream_t)stream};
  if (variant != ELL_FULL) {
    if (rows != ELL_ROWS || kc != ELL_KC) return (int)cudaErrorInvalidValue;
    if (variant == ELL_NOGATHER) launch<ELL_NOGATHER, ELL_ROWS, ELL_KC>(a);
    else if (variant == ELL_NODYN) launch<ELL_NODYN, ELL_ROWS, ELL_KC>(a);
    else launch<ELL_NOFMA, ELL_ROWS, ELL_KC>(a);
    return (int)cudaGetLastError();
  }
  int rows_per_block;
  const dim3 grid = ell_grid(a.n, a.m, &rows_per_block);
  auto sweep = rows == 1 ? ell_sweep_launch_r1 : rows == 4 ? ell_sweep_launch_r4
             : rows == 8 ? ell_sweep_launch_r8 : nullptr;
  if (sweep == nullptr ||
      sweep(kc, grid, a.stream, a.data_t, a.cols_t, a.index_bytes, a.slots, a.x, a.y, a.n,
            a.ncols, a.m, rows_per_block))
    return (int)cudaErrorInvalidValue;  // a setting that was not built
  return (int)cudaGetLastError();
}

// K2's first version: int32 columns (k, n), KC from k, 256 threads.
// Returns a cudaError_t as int.
int ell_first_launch(const void* data_t, const void* cols_t, long long n, int k,
                     long long ncols, const void* x, void* y, int m, void* stream) {
  if (n < 1 || n > 0x7fffffffLL || ncols < 1 || ncols > 0x7fffffffLL || k < 1 || m < 1)
    return (int)cudaErrorInvalidValue;
  const float* d = (const float*)data_t;
  const int* c = (const int*)cols_t;
  const float* xx = (const float*)x;
  float* yy = (float*)y;
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= 8) launch_first<8>(d, c, xx, yy, (int)n, k, (int)ncols, m, s);
  else if (k <= 16) launch_first<16>(d, c, xx, yy, (int)n, k, (int)ncols, m, s);
  else if (k <= 24) launch_first<24>(d, c, xx, yy, (int)n, k, (int)ncols, m, s);
  else launch_first<32>(d, c, xx, yy, (int)n, k, (int)ncols, m, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
