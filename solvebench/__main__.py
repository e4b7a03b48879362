"""``python3 -m solvebench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``."""

import os

from solvebench.clock import process_start

T0 = process_start()  # before torch is imported: set-up counts from here

# one process with few threads: the solves' host work is one Python thread,
# and idle worker pools of the math libraries would only compete with it
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

from solvebench.run import main  # noqa: E402

raise SystemExit(main(t0=T0))
