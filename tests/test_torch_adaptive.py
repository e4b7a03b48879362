"""Adaptive GenEO selection of the port against the JAX package's.

The pencil is the 2D GenEO pair at N = 16 (Neumann Laplacian, partition-
of-unity mass with overlap 3, n = 256), shift 1e-3, in f64. Its spectrum
(dense, from the reciprocal pencil) has its widest gap among lambda_17..24
between lambda_20 = 0.92357 and lambda_21 = 0.93937; the threshold sits at
its midpoint, so nev grows 8 -> 11 -> 15 -> 20 -> 26 in both packages and
stops with 20 eigenvalues below. The two packages start each round from
their own random block (torch and jax.random give different numbers), so
they are held to the same schedule and count, and to the converged
eigenvalues at 1e-6, not to the same iterations.
"""

import re

import numpy as np
import pytest
import scipy.linalg as sla
import torch

from dune_eigensolver_tpu.solvers import generalized_inverse_adaptive as jadaptive
from dune_eigensolver_tpu.sparse import problems as jproblems
from dune_eigensolver_tpu_torch import factorize
from dune_eigensolver_tpu_torch.solvers import generalized_inverse_adaptive as tadaptive
from dune_eigensolver_tpu_torch.sparse import dia_from_numpy

torch.set_num_threads(2)

N, SHIFT = 16, 1e-3
KW = dict(nev=8, tol=1e-10, shift=SHIFT, growth=1.3, rayleigh_ritz=True, verbose=1)


def _pencil():
    Aj = jproblems.laplacian_neumann_2d(N, dtype=np.float64)
    Bj = jproblems.laplacian_b_2d(N, 3, dtype=np.float64)
    At, Bt = (dia_from_numpy(np.asarray(M.data), M.offsets, M.shape, device="cpu")
              for M in (Aj, Bj))
    return Aj, Bj, At, Bt


def _spectrum(At, Bt):
    """The pencil's finite eigenvalues, ascending, by the dense reciprocal
    pencil B x = nu (A + shift B) x."""
    A, B = At.to_scipy().toarray(), Bt.to_scipy().toarray()
    nu = sla.eigh(B, A + SHIFT * B, eigvals_only=True)[::-1]
    return 1.0 / nu[nu > 1e-12] - SHIFT


def _rounds(out):
    """(nev, n_below) of each ``adaptive:`` line, and lambda_max."""
    rows = re.findall(r"adaptive: nev=(\d+) lambda_max=(\S+) threshold=\S+ n_below=(\d+)", out)
    return [(int(a), int(c)) for a, _, c in rows], [float(b) for _, b, _ in rows]


def test_adaptive_matches_jax_schedule(capsys):
    Aj, Bj, At, Bt = _pencil()
    lam = _spectrum(At, Bt)
    threshold = 0.5 * (lam[19] + lam[20])
    capsys.readouterr()
    rt, nt = tadaptive(At, Bt, threshold, **KW)
    out_t = capsys.readouterr().out
    rj, nj = jadaptive(Aj, Bj, threshold, **KW)
    out_j = capsys.readouterr().out
    sched_t, lmax_t = _rounds(out_t)
    sched_j, lmax_j = _rounds(out_j)
    assert [s for s, _ in sched_t] == [8, 11, 15, 20, 26]
    assert sched_t == sched_j
    assert nt == nj == 20 == int((lam < threshold).sum())
    np.testing.assert_allclose(lmax_t, lmax_j, atol=1e-6)
    et, ej = rt.eigenvalues.numpy(), np.asarray(rj.eigenvalues)
    assert et.shape == ej.shape == (26,)
    assert np.abs(et - ej).max() <= 1e-6
    assert np.abs(et - lam[:26]).max() <= 1e-6
    assert float(et.max()) >= threshold


def test_adaptive_stops_at_once(capsys):
    """A threshold below the first round's lambda_max: one round, no
    growth, in both packages."""
    Aj, Bj, At, Bt = _pencil()
    capsys.readouterr()
    rt, nt = tadaptive(At, Bt, 0.3, **KW)
    rj, nj = jadaptive(Aj, Bj, 0.3, **KW)
    sched, _ = _rounds(capsys.readouterr().out)
    assert sched == [(8, 3), (8, 3)]
    assert nt == nj == 3
    assert rt.eigenvalues.shape == (8,)
    np.testing.assert_allclose(rt.eigenvalues.numpy(), np.asarray(rj.eigenvalues), atol=1e-6)


@pytest.mark.parametrize("threshold,nev_max,final,below", [(0.85, None, 15, 12),
                                                          (2.0, 12, 12, 12)])
def test_adaptive_factorizes_once(monkeypatch, threshold, nev_max, final, below):
    """The default engine (the block-banded direct one for this 2D stencil)
    is built once and serves every round: three rounds (8 -> 11 -> 15) to
    a threshold between lambda_12 and lambda_13, and a growth capped by
    ``nev_max`` (8 -> 11 -> 12) short of a threshold never reached."""
    calls = []
    real = factorize.banded_inverse_factory

    def counted(A, **kw):
        calls.append(A.shape)
        return real(A, **kw)

    monkeypatch.setattr(factorize, "banded_inverse_factory", counted)
    _, _, At, Bt = _pencil()
    res, n_below = tadaptive(At, Bt, threshold, nev=8, tol=1e-6, shift=SHIFT, nev_max=nev_max)
    assert calls == [(N * N, N * N)]
    assert res.eigenvalues.shape == (final,)
    assert n_below == below
