"""dune_eigensolver_tpu_torch — the PyTorch/CUDA port of dune_eigensolver_tpu.

The JAX package beside this one is the reference: every module here has a
counterpart of the same path and function names there, and the tests in
``tests/test_torch_*.py`` hold the two to stated tolerances on the same
inputs. This package imports ``torch``, ``numpy`` and ``scipy`` and never
``jax`` (nor the JAX package, whose ``__init__`` imports jax).

Layout (the ported slice: the nested-LOBPCG north-star solve):

* ``sparse``     — ``DIAMatrix`` container, problem builders, ``spmm_t``
* ``kernels``    — the DIA SpMM: plain PyTorch version + CUDA kernel wrapper
* ``csrc``       — hand-written CUDA C++ for sm_90a (built at first use by
  ``utils.native`` into ``_build/``)
* ``ops``        — blocked (B-)orthonormalization with spectral whitening
* ``factorize``  — geometric-multigrid V-cycle preconditioner
* ``solvers``    — LOBPCG on the reciprocal pencil, nested iteration
* ``oracle``     — closed-form Dirichlet Laplacian spectra

Conventions: containers are frozen dataclasses over tensors, functions are
plain functions on tensors, devices are explicit, and nothing records
gradients.
"""

import torch

# The JAX reference forces Precision.HIGHEST on every Gram matrix
# (ops/ortho.py, solvers/lobpcg.py); the PyTorch equivalent is strict f32
# matmuls with TF32 off, set explicitly rather than trusting the defaults.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from dune_eigensolver_tpu_torch.sparse.formats import (  # noqa: E402
    DIAMatrix,
    dia_from_numpy,
    dia_from_scipy,
)
from dune_eigensolver_tpu_torch.sparse.spmm import spmm_t  # noqa: E402
from dune_eigensolver_tpu_torch.sparse import problems  # noqa: E402
from dune_eigensolver_tpu_torch.solvers import (  # noqa: E402
    EigenResult,
    lobpcg_generalized,
    lobpcg_nested,
)
from dune_eigensolver_tpu_torch.factorize import mg_inverse_factory  # noqa: E402

__all__ = [
    "DIAMatrix",
    "dia_from_numpy",
    "dia_from_scipy",
    "spmm_t",
    "problems",
    "EigenResult",
    "lobpcg_generalized",
    "lobpcg_nested",
    "mg_inverse_factory",
]
