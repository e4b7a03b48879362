// The ELL ablation's sweep at 8 rows of X in flight (csrc/ell_sweep.cuh).

#define ELL_SWEEP_ROWS 8
#include "ell_sweep.cuh"
