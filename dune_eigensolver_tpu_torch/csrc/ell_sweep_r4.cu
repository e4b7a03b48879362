// The ELL ablation's sweep at 4 rows of X in flight (csrc/ell_sweep.cuh).

#define ELL_SWEEP_ROWS 4
#include "ell_sweep.cuh"
