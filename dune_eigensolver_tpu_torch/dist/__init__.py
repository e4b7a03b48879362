"""The distributed layer on ``torch.distributed`` (counterpart of the JAX
package's ``dist/``): row-sharded DIA and general-sparsity solves, the
sharded multigrid V-cycle, and spawned CPU ranks for trying them out
(``dist/dryrun.py``). The exports are the JAX ``__all__``
(``dist/__init__.py:26-47``)."""

from dune_eigensolver_tpu_torch.dist.mesh import ROW_AXIS, init_distributed, make_mesh
from dune_eigensolver_tpu_torch.dist.mg import make_sharded_mg_prec_fn, sharded_mg_geometry
from dune_eigensolver_tpu_torch.dist.sharded import (
    dia_spmm_halo,
    dia_spmm_halo_t,
    halo_exchange,
    halo_exchange_t,
    local_diag_block,
    psum_reduce,
    schwarz_inverse_t,
    sharded_generalized_inverse,
    sharded_lobpcg_generalized,
    sharded_standard_inverse,
    sharded_standard_largest,
)
from dune_eigensolver_tpu_torch.dist.windowed import (
    sharded_generalized_inverse_general,
    sharded_lobpcg_general,
    sharded_standard_largest_general,
    windowed_shard_plan,
)

__all__ = [
    "ROW_AXIS",
    "make_mesh",
    "init_distributed",
    "make_sharded_mg_prec_fn",
    "sharded_mg_geometry",
    "dia_spmm_halo",
    "dia_spmm_halo_t",
    "halo_exchange",
    "halo_exchange_t",
    "local_diag_block",
    "psum_reduce",
    "schwarz_inverse_t",
    "sharded_generalized_inverse",
    "sharded_lobpcg_generalized",
    "sharded_standard_inverse",
    "sharded_standard_largest",
    "sharded_generalized_inverse_general",
    "sharded_lobpcg_general",
    "sharded_standard_largest_general",
    "windowed_shard_plan",
]
