// General-sparsity (ELL) SpMM in the transposed layout, for Hopper (sm_90a).
//
// Replaces dune_eigensolver_tpu/kernels/gather_spmm.py:792 _seg_kernel
// (launched by windowed_spmm_t, gather_spmm.py:898). It computes what that
// kernel computes, not its machinery:
//
//     Y[r, i] = sum_j data[i, j] * X[r, cols[i, j]]
//
// with X (m, ncols) and Y (m, n) contiguous row-major, f32 storage and f32
// accumulation, or f64 storage and f64 accumulation (the card's f64 solves
// and the f64 Rayleigh-Ritz refinement; the TPU had no f64). The TPU
// kernel's segments, 128-lane windows, COO tail and
// right-padded layout exist because tpu.dynamic_gather reads one 128-lane
// vreg; a CUDA thread gathers from device memory through L1/L2 directly,
// so the ELL container feeds the kernel as it is. Padding slots hold an
// in-bounds column and a zero coefficient, so no load is masked.
//
// What bounds it: not bytes. Each stored entry is a 4-byte coefficient and
// a 4-byte index serving 2 flops per row of X, and each of those flops
// gathers an X value from an irregular column: one 4-byte L1 request per
// multiply-add. The first version held at most one row of X and a
// chunk of 8-32 gathers in flight, loaded its chunk under a per-slot
// predicate with 92 registers at k = 18, and took 45% of its copy bound
// on the 2^20 graph, 30% on elasticity_2d(512) as scalar ELL (E4: without
// the irregular addresses it took a third of the time). And it paid for
// padding: the RCM-ordered 2^20 graph has 7,340,032 slots for 3,250,580
// entries (44% real; k = 7 is set by seven rows), and every padded slot
// streamed a coefficient and an index and gathered X like a real one.
//
// What the design does about that:
// - The slot loop of a warp stops at that warp's last stored entry: one
//   count per 32 consecutive rows (ELLMatrix.warp_slots, made once per
//   container), uniform across the warp, so no thread diverges. On the
//   graph the counts average 4.00 against k = 7. Slots after a warp's
//   count are padding (zero coefficient, the row's own column), whose
//   products are zero on finite X: skipping them changes no bit. (Alone
//   this is worth 10-18% on the graph: the first version was held less by
//   the padding's bytes than by how few gathers it had in flight.)
// - No predicated slot: up to ELL_KC (coefficient, column) pairs sit in
//   registers, with the exact count a template constant (recursive tail).
//   A warp of at most ELL_KC slots loads its pairs once and keeps them
//   over all rows of X; a longer one (elasticity's 18) sweeps chunks of
//   ELL_KC and an exact remainder for each group of rows of X, reloading
//   the pairs (the block's lie in L1) and keeping the sums in registers,
//   so that Y is written once, not read back and written per chunk.
// - ELL_ROWS rows of X are unrolled, so a thread has ELL_ROWS x chunk
//   independent gathers in flight, and the registers are capped so that
//   ELL_MIN_BLOCKS blocks share an SM: latency is hidden by more warps as
//   much as by more loads a warp (at these caps ptxas keeps a few words in
//   local memory, which L1 holds; every higher cap and fewer rows measured
//   slower, PERF.md section 6).
// - Where every column lies within int16 of its row (a mesh-ordered
//   operator: elasticity_2d's span is about +-1,024), the index stream is
//   int16 offsets col - i (formats.py::ell_column_offsets), half the bytes
//   of int32 columns. The container holds one index stream, whichever its
//   columns allow (ELLMatrix.kernel_streams): a choice, not a fallback.
// The coefficients arrive as (k, n) streams (ELLMatrix.kernel_streams), so
// one thread per row i loads its pairs coalesced across the warp, once,
// and reuses them for every row of X; Y's stores are coalesced. The
// gathers of neighbouring rows land near each other for a banded (RCM- or
// mesh-ordered) operator and are left to L1/L2. When n is small the m rows
// are split over blockIdx.y so that the card still gets enough threads.
// Slots in stored order, one chain of fused multiply-adds per output from
// +0: the first version's bits on finite X.
// f64 is the same body with the value type a template parameter:
// ELL_ROWS_F64 rows of X in flight, since each gathered value and each sum
// takes two registers, and its own register cap; the index stream is the
// same.
// The body lives in csrc/ell_body.cuh, a template over the variant, the
// rows of X in flight and the register chunk, which the ablation
// (csrc/ell_ablate.cu) instantiates too; K2 is its ELL_FULL instantiation
// at ELL_ROWS, ELL_KC and the caps below.
// Registers (ptxas, sm_90a): see PERF.md section 6; the build log prints
// them.
//
// Interface: plain C, loaded with ctypes. The launch goes on the caller's
// stream and the function returns cudaGetLastError() so the wrapper can
// raise on a refused launch.

#include "ell_body.cuh"

#define ELL_ROWS_F64 4        // rows of X in flight in f64
#define ELL_MIN_BLOCKS_F64 3  // blocks an SM holds in f64: 168 registers

extern "C" {

// value_bytes: 4 (float32 coefficients, X and Y) or 8 (float64); cols_t:
// (k, n) int32 columns (index_bytes 4) or int16 offsets col - i (index_bytes
// 2); warp_slots: ceil(n / 32) int32 counts, each at most k. Returns a
// cudaError_t as int.
int ell_spmm_t_launch(int value_bytes, const void* data_t, const void* cols_t,
                      int index_bytes, const void* warp_slots, long long n, int k,
                      long long ncols, const void* x, void* y, int m, void* stream) {
  if (n < 0 || n > 0x7fffffffLL || ncols < 1 || ncols > 0x7fffffffLL || k < 0 || m < 1 ||
      (index_bytes != 2 && index_bytes != 4) || (value_bytes != 4 && value_bytes != 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 0) return (int)cudaGetLastError();
  if (k == 0) {  // no stored entries: Y = 0
    cudaMemsetAsync(y, 0, (size_t)m * (size_t)n * value_bytes, s);
    return (int)cudaGetLastError();
  }
  int rows_per_block;
  const dim3 grid = ell_grid(n, m, &rows_per_block);
  const int* slots = (const int*)warp_slots;
  if (value_bytes == 4) {
    ell_body_launch<ELL_FULL, ELL_ROWS, ELL_KC, ELL_MIN_BLOCKS_I16, ELL_MIN_BLOCKS, float>(
        grid, s, data_t, cols_t, index_bytes, slots, x, y, (int)n, (int)ncols, m,
        rows_per_block);
  } else {
    ell_body_launch<ELL_FULL, ELL_ROWS_F64, ELL_KC, ELL_MIN_BLOCKS_F64, ELL_MIN_BLOCKS_F64,
                    double>(grid, s, data_t, cols_t, index_bytes, slots, x, y, (int)n,
                            (int)ncols, m, rows_per_block);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
