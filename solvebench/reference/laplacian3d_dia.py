"""Plain reference of operand family ``laplacian3d_dia``.

Imports numpy and torch only: nothing of the program. It judges the
eigenpairs that the timed solves returned (``check``): the smallest
``report`` eigenvalues of every solve against the closed form of the 3D
Dirichlet Laplacian, 4 sin^2(pi i / (2 (N + 1))) summed over the three
axes, and the residuals of the sampled solves' eigenvectors, with A applied
in float64 by plain shifted adds over the diagonals that both sides were
handed (upcast from the configuration's dtype), in blocks of vectors.
"""

from __future__ import annotations

import numpy as np
import torch


def exact_smallest(N: int, k: int) -> np.ndarray:
    """The smallest k eigenvalues of the N^3 Dirichlet Laplacian (6 on the
    diagonal), in float64, ascending with multiplicity."""
    m = min(N, k)
    one = 4.0 * np.sin(np.pi * np.arange(1, m + 1) / (2.0 * (N + 1))) ** 2
    return np.sort((one[:, None, None] + one[None, :, None] + one[None, None, :]).ravel())[:k]


def dia_apply_f64(data: torch.Tensor, offsets, X: torch.Tensor) -> torch.Tensor:
    """Y = A X for X (b, n) float64; data[d, i] is entry (i, i + offsets[d])."""
    n = X.shape[1]
    Y = torch.zeros_like(X)
    for d, o in enumerate(offsets):
        c = data[d].to(torch.float64)
        if o >= 0:
            Y[:, :n - o] += c[:n - o] * X[:, o:]
        else:
            Y[:, -o:] += c[-o:] * X[:, :n + o]
    return Y


def prepare(cfg: dict, report: int, arrays: dict, cache_dir) -> dict:
    return {"exact": exact_smallest(int(cfg["N"]), report)}


def check(state: dict, report: int, arrays: dict, answers, block: int = 4) -> dict:
    """Readings over ``answers``: each a dict with ``eigenvalues`` (numpy)
    and, for the sampled solves, ``eigenvectors`` (n, nev) on the host.
    An answer of the wrong shape or with a non-finite entry reads inf.

    * ``eig_err``: max |lambda_k - lambda_k,exact| / max |lambda_exact| (the
      reference program's oracle error), over every answer;
    * ``resid``: max ||r|| / (lambda ||x||), r = A x - lambda x, over the
      sampled answers' vectors."""
    k = report
    exact = state["exact"]
    n = arrays["n"]
    data, offsets = arrays["data"], arrays["offsets"]
    inf = float("inf")
    out = {"eig_err": 0.0, "resid": 0.0}
    for ans in answers:
        lam = np.asarray(ans["eigenvalues"], dtype=np.float64)
        if lam.shape[0] < k or not np.isfinite(lam[:k]).all():
            return dict.fromkeys(out, inf)
        out["eig_err"] = max(out["eig_err"], float(np.abs(lam[:k] - exact).max() / exact.max()))
        V = ans.get("eigenvectors")
        if V is None:
            continue
        if V.shape[0] != n or V.shape[1] < k:
            return dict(out, resid=inf)
        for j in range(0, k, block):
            X = V[:, j:min(j + block, k)].to(data.device, torch.float64).T.contiguous()
            lj = torch.as_tensor(lam[j:j + X.shape[0]], device=data.device)
            AX = dia_apply_f64(data, offsets, X)
            R = AX - lj[:, None] * X
            r = R.norm(dim=1) / (lj.abs() * X.norm(dim=1))
            r = torch.where(torch.isfinite(r), r, torch.full_like(r, inf))
            out["resid"] = max(out["resid"], float(r.max()))
            del X, AX, R
    return out
