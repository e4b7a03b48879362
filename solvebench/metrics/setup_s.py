"""``setup_s`` (s, end to end, host clock): from the process's start to the
moment the window may begin: the import, CUDA's start, loading the
program's kernel library (built by nvcc in a checkout's first run), making
and handing over the operand, the preconditioner's and the program's set-up
memo and one warm solve of the cell's own recipe, and the host buffers of
the sampled eigenvectors."""

UNIT = "s"


def read(run):
    return run.setup_s
