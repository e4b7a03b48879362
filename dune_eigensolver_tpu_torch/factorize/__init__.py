from dune_eigensolver_tpu_torch.factorize.multigrid import mg_inverse_factory

__all__ = ["mg_inverse_factory"]
