"""dune_eigensolver_tpu_torch — the PyTorch/CUDA port of dune_eigensolver_tpu.

The JAX package beside this one is the reference: every module here has a
counterpart of the same path and function names there, and the tests in
``tests/test_torch_*.py`` hold the two to stated tolerances on the same
inputs. This package imports ``torch``, ``numpy`` and ``scipy`` and never
``jax`` (nor the JAX package, whose ``__init__`` imports jax).

Layout (the ported slices: the nested-LOBPCG north-star solve, the
general-sparsity ELL/BSR path with the CG inverse and
``generalized_inverse``, the kernel-measurement path, the standard entry
points with the iterative and direct inverse engines, the single-card
solver extras, and the distributed layer):

* ``sparse``     — ``DIAMatrix``/``ELLMatrix``/``BSRMatrix`` containers,
  problem builders, RCM reordering, ``spmm_t``
* ``kernels``    — the DIA, ELL and BSR SpMMs: plain PyTorch versions +
  CUDA kernel wrappers
* ``csrc``       — hand-written CUDA C++ for sm_90a (built at first use by
  ``utils.native`` into ``_build/``)
* ``ops``        — blocked (B-)orthonormalization with spectral whitening
* ``factorize``  — Jacobi-CG, Chebyshev, Chebyshev-CG, multigrid V-cycle
  and V-cycle-CG inverses, and ``default_inverse_factory``'s routing
* ``solvers``    — ``standard_largest``/``standard_inverse``, LOBPCG on the
  reciprocal pencil, nested iteration, shift-invert ``generalized_inverse``,
  f64 Rayleigh-Ritz refinement, adaptive GenEO selection, checkpointed
  (segmented) solves
* ``dist``       — the distributed layer on ``torch.distributed``: halo
  SpMM on each rank's rows (K1, K2), all-reduced Grams, the sharded
  drivers and V-cycle, spawned gloo ranks (``dist.dryrun``)
* ``utils``      — device default, kernel build, verbosity/profiler trace
  (``vlog``), the paranoid NaN tripwire (``paranoid``)
* ``experiments`` — the kernel studies: copy probe, DIA staging variants,
  ELL ablation, gather probes
* ``bench``      — FLOP/byte models, device timing, weak scaling
* ``cli``        — the reference program's protocols (``python -m``)
* ``oracle``     — closed-form Dirichlet Laplacian spectra, scipy/ARPACK
  oracles

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
    BSRMatrix,
    DIAMatrix,
    ELLMatrix,
    bsr_from_numpy,
    bsr_from_scipy,
    dia_from_numpy,
    dia_from_scipy,
    ell_from_numpy,
    ell_from_scipy,
)
from dune_eigensolver_tpu_torch.sparse.spmm import spmm_t  # noqa: E402
from dune_eigensolver_tpu_torch.sparse import problems  # noqa: E402
from dune_eigensolver_tpu_torch.solvers import (  # noqa: E402
    EigenResult,
    generalized_inverse,
    generalized_inverse_adaptive,
    generalized_inverse_checkpointed,
    lobpcg_generalized,
    lobpcg_generalized_checkpointed,
    lobpcg_nested,
    refine_eigenpairs,
    standard_inverse,
    standard_largest,
)
from dune_eigensolver_tpu_torch.factorize import (  # noqa: E402
    cg_inverse_factory,
    cheb_cg_inverse_factory,
    chebyshev_inverse_factory,
    default_inverse_factory,
    mg_cg_inverse_factory,
    mg_inverse_factory,
)

__all__ = [
    "BSRMatrix",
    "DIAMatrix",
    "ELLMatrix",
    "bsr_from_numpy",
    "bsr_from_scipy",
    "dia_from_numpy",
    "dia_from_scipy",
    "ell_from_numpy",
    "ell_from_scipy",
    "spmm_t",
    "problems",
    "EigenResult",
    "generalized_inverse",
    "generalized_inverse_adaptive",
    "generalized_inverse_checkpointed",
    "lobpcg_generalized",
    "lobpcg_generalized_checkpointed",
    "lobpcg_nested",
    "refine_eigenpairs",
    "standard_inverse",
    "standard_largest",
    "cg_inverse_factory",
    "cheb_cg_inverse_factory",
    "chebyshev_inverse_factory",
    "default_inverse_factory",
    "mg_cg_inverse_factory",
    "mg_inverse_factory",
]
