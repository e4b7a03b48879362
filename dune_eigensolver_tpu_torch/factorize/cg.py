"""Krylov helpers (the slice needs only ``_cast_floating`` of the JAX
package's ``factorize/cg.py``; ``cg_solve_t`` and the CG inverse
factories are not ported yet)."""

from __future__ import annotations

import dataclasses

import torch

from dune_eigensolver_tpu_torch.sparse.formats import DIAMatrix


def _cast_floating(tree, dt):
    """Cast every floating tensor in ``tree`` (a tensor, a DIAMatrix, or a
    tuple/list of these) to ``dt``; other leaves pass through."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dt) if tree.is_floating_point() else tree
    if isinstance(tree, DIAMatrix):
        return dataclasses.replace(tree, data=_cast_floating(tree.data, dt))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_cast_floating(t, dt) for t in tree)
    return tree
