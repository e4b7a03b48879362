"""Plain reference of operand family ``laplacian3d_dia_ns``: the north-star
cell's copy of ``laplacian3d_dia``'s reference, with the closed-form
control.

Imports numpy and torch only: nothing of the program, and no other file of
the benchmark (a reference imports nothing else). ``exact_smallest``,
``dia_apply_f64`` and ``check`` are ``laplacian3d_dia``'s, copied, so
``eig_err`` and ``resid`` mean what they mean there; ``prepare`` is its
too, with the grid's N kept for the control; ``round_tf32`` is
``elasticity2d_bsr``'s. A test holds the copies to their originals.

The eigenpairs of the 7-point Dirichlet Laplacian on N^3 are known in
closed form: for a triple (a, b, c) of 1..N the eigenvector is
sin(pi a (x+1)/(N+1)) sin(pi b (y+1)/(N+1)) sin(pi c (z+1)/(N+1)), x the
fastest index, and the eigenvalue the sum of the three
4 sin^2(pi k / (2 (N+1))). ``control_answers`` puts the ``report``
smallest of them, rounded to TF32, in the program's place.
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
    return {"exact": exact_smallest(int(cfg["N"]), report), "N": int(cfg["N"])}


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


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits, to nearest."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def smallest_triples(N: int, k: int) -> np.ndarray:
    """The (a, b, c) of the k smallest eigenvalues, 1-based, in the order
    ``exact_smallest`` gives them (ties in the order of the triples), a
    acting on the fastest index."""
    m = min(N, k)
    one = 4.0 * np.sin(np.pi * np.arange(1, m + 1) / (2.0 * (N + 1))) ** 2
    flat = (one[:, None, None] + one[None, :, None] + one[None, None, :]).ravel()
    order = np.argsort(flat, kind="stable")[:k]
    return np.stack(np.unravel_index(order, (m, m, m)), axis=1) + 1


def closed_form_pairs(N: int, k: int):
    """The k smallest eigenpairs, one at a time: (eigenvalue, eigenvector
    of N^3 entries with norm 1), both float64."""
    x = torch.arange(1, N + 1, dtype=torch.float64)
    lam = exact_smallest(N, k)

    def sine(p):
        s = torch.sin(np.pi * int(p) * x / (N + 1))
        return s / s.norm()

    for j, (a, b, c) in enumerate(smallest_triples(N, k)):
        v = sine(c)[:, None, None] * sine(b)[None, :, None] * sine(a)[None, None, :]
        yield float(lam[j]), v.reshape(-1)


def control_answers(state: dict, precision: str) -> list:
    """The closed-form eigenpairs in the program's place in ``precision``:
    each made in float64, rounded to TF32 (``round_tf32``), as one answer whose vectors
    are (n, report) float32 on the host."""
    if precision != "tf32":
        raise ValueError(f"no control in {precision}")
    exact = state["exact"]
    N, k = int(state["N"]), len(exact)
    V = torch.empty((k, N ** 3), dtype=torch.float32)
    for j, (_, v) in enumerate(closed_form_pairs(N, k)):
        V[j] = round_tf32(v.to(torch.float32))
    vals = round_tf32(torch.as_tensor(exact, dtype=torch.float32))
    return [{"eigenvalues": vals.double().numpy(), "eigenvectors": V.T}]
