// The ELL ablation's sweep at 1 row of X in flight (ell_sweep.cuh).

#define ELL_SWEEP_ROWS 1
#include "ell_sweep.cuh"
