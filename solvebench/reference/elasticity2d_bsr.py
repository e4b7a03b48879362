"""Plain reference of operand family ``elasticity2d_bsr``.

Imports numpy, scipy and torch only: nothing of the program. It judges the
eigenpairs that the timed solves returned (``check``): the ``report``
smallest eigenvalues of every solve against the pencil's, and the residuals
of the sampled solves' eigenvectors, with A and B applied in float64 by a
plain gather over the blocks that both sides were handed, upcast.

The reference eigenpairs come from ARPACK shift-invert in float64 (scipy
``eigsh`` with a SuperLU factorization of A - sigma B) on the same arrays.
The pencil does not depend on the seed, and the factorization and the
iteration take about a minute of host time, so they are kept in the
checkout's reference cache under a key of the configuration and of this
file's and the generator's sources: the first run in a checkout computes
them, every later run reads them.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import numpy as np
import torch


def to_scipy(arrays: dict):
    """(A, B) as float64 scipy CSR from the handed arrays (present blocks
    only)."""
    import scipy.sparse as sp

    present = arrays["present"].cpu().numpy()
    bcols = arrays["bcols"].cpu().numpy().astype(np.int64)
    bdata = arrays["bdata"].to(torch.float64).cpu().numpy()
    nbr, k = bcols.shape
    keep = np.arange(k)[None, :] < present.sum(axis=1)[:, None]
    rows = np.repeat(np.arange(nbr), keep.sum(axis=1))
    blocks = bdata[keep]  # (nnzb, 2, 2), row-major over (row, slot)
    cols = bcols[keep]
    r = (2 * rows[:, None, None] + np.arange(2)[None, :, None]).repeat(2, axis=2)
    c = (2 * cols[:, None, None] + np.arange(2)[None, None, :]).repeat(2, axis=1)
    n = arrays["n"]
    A = sp.csr_matrix((blocks.ravel(), (r.ravel(), c.ravel())), shape=(n, n))
    B = sp.diags(arrays["mass"].to(torch.float64).cpu().numpy().ravel()).tocsr()
    return A, B


def smallest(A, B, k: int, sigma: float):
    """The k smallest eigenpairs of A x = lambda B x by ARPACK shift-invert
    around ``sigma``, to machine precision, from a fixed start: values
    ascending, vectors (n, k) B-orthonormal."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import LinearOperator, eigsh, splu

    lu = splu(sp.csc_matrix(A - sigma * B), permc_spec="MMD_AT_PLUS_A")
    op = LinearOperator(A.shape, matvec=lu.solve, dtype=np.float64)
    vals, vecs = eigsh(A, k=k, M=B, sigma=sigma, which="LM", OPinv=op, tol=0.0,
                       v0=np.ones(A.shape[0]))
    order = np.argsort(vals)
    return vals[order], vecs[:, order]


#: the shift-invert point: A - SIGMA B is positive definite
SIGMA = -1e-3


def _key(cfg: dict, k: int) -> str:
    h = hashlib.sha256(json.dumps([cfg, k, SIGMA], sort_keys=True).encode())
    here = Path(__file__).resolve()
    for src in (here, here.parent.parent / "operands" / "elasticity2d_bsr.py"):
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def prepare(cfg: dict, report: int, arrays: dict, cache_dir) -> dict:
    """The reference eigenpairs, from the cache or computed and stored."""
    k = report
    stem = Path(cache_dir) / f"elasticity2d_bsr-{_key(cfg, k)}"
    if not stem.with_suffix(".npz").is_file():
        A, B = to_scipy(arrays)
        # a few more than reported, so that a multiple eigenvalue at the end
        # of the reported range is resolved whole
        vals, vecs = smallest(A, B, k + 4, SIGMA)
        stem.parent.mkdir(parents=True, exist_ok=True)
        tmp = stem.with_suffix(f".{os.getpid()}.tmp.npz")
        np.savez(tmp, eigenvalues=vals[:k], eigenvectors=vecs[:, :k].astype(np.float32))
        os.replace(tmp, stem.with_suffix(".npz"))
    with np.load(stem.with_suffix(".npz")) as z:
        return {"ref": z["eigenvalues"], "vectors": z["eigenvectors"]}


def control_answers(state: dict, precision: str) -> list:
    """The reference put in the program's place in ``precision``: its
    eigenpairs rounded to that precision, as one answer."""
    if precision != "tf32":
        raise ValueError(f"no control in {precision}")
    vals = torch.as_tensor(state["ref"], dtype=torch.float32)
    vecs = torch.as_tensor(state["vectors"])
    return [{"eigenvalues": round_tf32(vals).double().numpy(), "eigenvectors": round_tf32(vecs)}]


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits, to nearest."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def bsr_apply_f64(bdata: torch.Tensor, bcols: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Y = A X for X (b, n) float64 over 2x2 blocks: Y[:, 2i:2i+2] = sum over
    slots s of bdata[i, s] @ X[:, 2 bcols[i, s]:...]; padding blocks are 0."""
    b, n = X.shape
    Xb = X.reshape(b, n // 2, 2)
    G = Xb[:, bcols.long()]  # (b, nbr, k, 2)
    Y = torch.einsum("iskl,bisl->bik", bdata.to(torch.float64), G)
    return Y.reshape(b, n)


def check(state: dict, report: int, arrays: dict, answers, block: int = 8) -> dict:
    """Readings over ``answers`` (as in ``laplacian3d_dia.check``):

    * ``eig_err``: max over k of |lambda_k - lambda_k,ref| / |lambda_k,ref|,
      over every answer: each eigenvalue against its own, so that one off
      by 10% reads 0.1 wherever it sits in the spectrum;
    * ``resid``: max ||r|| / (|lambda| ||B x||), r = A x - lambda B x,
      over the sampled answers' vectors."""
    k = report
    ref = state["ref"]
    n = arrays["n"]
    bdata, bcols = arrays["bdata"], arrays["bcols"]
    mass = arrays["mass"].to(bdata.device, torch.float64).reshape(-1)
    inf = float("inf")
    out = {"eig_err": 0.0, "resid": 0.0}
    for ans in answers:
        lam = np.asarray(ans["eigenvalues"], dtype=np.float64)
        if lam.shape[0] < k or not np.isfinite(lam[:k]).all():
            return dict.fromkeys(out, inf)
        out["eig_err"] = max(out["eig_err"], float((np.abs(lam[:k] - ref) / np.abs(ref)).max()))
        V = ans.get("eigenvectors")
        if V is None:
            continue
        if V.shape[0] != n or V.shape[1] < k:
            return dict(out, resid=inf)
        for j in range(0, k, block):
            X = V[:, j:min(j + block, k)].to(bdata.device, torch.float64).T.contiguous()
            lj = torch.as_tensor(lam[j:j + X.shape[0]], device=bdata.device)
            AX = bsr_apply_f64(bdata, bcols, X)
            BX = mass * X
            R = AX - lj[:, None] * BX
            r = R.norm(dim=1) / (lj.abs() * BX.norm(dim=1))
            r = torch.where(torch.isfinite(r), r, torch.full_like(r, inf))
            out["resid"] = max(out["resid"], float(r.max()))
            del X, AX, BX, R
    return out
