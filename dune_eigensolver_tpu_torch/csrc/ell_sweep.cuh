// One row count of the ELL ablation's sweep (csrc/ell_ablate.cu): K2's
// body (csrc/ell_body.cuh, ELL_FULL) at ELL_SWEEP_ROWS rows of X in flight
// and register chunks KC 6, 8, 9 and 12, on both index streams, at K2's
// register caps. Included by ell_sweep_r1.cu, ell_sweep_r4.cu and
// ell_sweep_r8.cu, so that the sweep's 24 instantiations build as three
// nvcc processes side by side instead of one.

#pragma once

#include "ell_body.cuh"

#define ELL_SWEEP_CAT2(a, b) a##b
#define ELL_SWEEP_CAT(a, b) ELL_SWEEP_CAT2(a, b)

// Launch the setting (ELL_SWEEP_ROWS, kc) on the caller's stream; returns 0,
// or 1 for a kc that was not built.
extern "C" int ELL_SWEEP_CAT(ell_sweep_launch_r, ELL_SWEEP_ROWS)(
    int kc, dim3 grid, cudaStream_t s, const void* data_t, const void* cols_t, int index_bytes,
    const int* slots, const void* x, void* y, int n, int ncols, int m, int rows_per_block) {
  constexpr int R = ELL_SWEEP_ROWS;
#define ELL_SWEEP_KC(K)                                                                     \
  case K:                                                                                  \
    ell_body_launch<ELL_FULL, R, K, ELL_MIN_BLOCKS_I16, ELL_MIN_BLOCKS, float>(             \
        grid, s, data_t, cols_t, index_bytes, slots, x, y, n, ncols, m, rows_per_block);     \
    return 0;
  switch (kc) {
    ELL_SWEEP_KC(6)
    ELL_SWEEP_KC(8)
    ELL_SWEEP_KC(9)
    ELL_SWEEP_KC(12)
  }
#undef ELL_SWEEP_KC
  return 1;
}
