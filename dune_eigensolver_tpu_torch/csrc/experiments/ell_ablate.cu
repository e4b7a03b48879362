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
// What bounds them: K2 is held by its X gathers (one L1 request per
// multiply-add), not by bytes. The variants split the rest of K2's time
// against its copy bound: the gathers' irregular addresses, the index
// stream, the inner loop's instructions.
//
// Interface: plain C for ctypes; the launch goes on the caller's stream and
// the function returns cudaGetLastError().

#include "../ell_body.cuh"

// The sweep's ELL_FULL instantiations live in ell_sweep_r{1,4,8}.cu, one
// source (one nvcc, all built together) for each of ROWS 1, 4, 8, each
// with KC 6, 8, 9 and 12 (ell_sweep.cuh); K2's own (8, 9) is one of
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

}  // extern "C"
