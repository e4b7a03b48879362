"""The port's host-setup helper (``csrc/host/dunetpu.cpp``, built with g++
by ``utils/native.py``) against the numpy loops it replaces, on the CPU.

The schedules of the host-LU engine (levels, chunk order and boundaries,
the packed row/column/value tables) and the CSR -> ELL packing are integer
work and copies: the helper must give the port's numpy versions' and the
JAX package's numpy path's arrays bit for bit, on the strict triangles of
SuperLU factors of a 2D Laplacian and of a random sparse matrix, in f32 and
f64. The no-pivot band LU multiplies by 1/pivot where numpy divides and
may contract its update into an FMA, so it is held to the numpy loop at
1e-13 of max|band| on a band whose pivots do not grow. Also: a zero pivot
reports its row, a broken source raises with g++'s output, two processes
that build at once both load a whole library, out-of-bounds input is
refused before any pointer is passed, no path of the package calls the
numpy versions, and ``bench/host_setup.py`` runs.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from dune_eigensolver_tpu.factorize import banded as jbanded
from dune_eigensolver_tpu.factorize import host_lu as jlu
from dune_eigensolver_tpu.sparse import problems as jproblems

from dune_eigensolver_tpu_torch import factorize
from dune_eigensolver_tpu_torch.factorize import banded as tbanded
from dune_eigensolver_tpu_torch.factorize import host_lu as tlu
from dune_eigensolver_tpu_torch.sparse import dia_from_numpy
from dune_eigensolver_tpu_torch.utils import native

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _laplacian_triangles(N=24):
    """Strict L and mirrored strict U of SuperLU's factors of the 2D
    Dirichlet Laplacian, as ``factorize`` cuts them."""
    A = jproblems.laplacian_dirichlet_2d(N, dtype=np.float64).to_scipy()
    lu, _ = tlu._superlu(A, "MMD_AT_PLUS_A", True, True)
    return tlu._strict_triangles(lu)


def _random_triangles(n=500, seed=11):
    S = sp.random(n, n, density=0.02, random_state=np.random.RandomState(seed), format="csr")
    L = sp.tril(S, k=-1, format="csr")
    Umir = sp.triu(S, k=1, format="csr")[::-1, ::-1].tocsr()
    return L, Umir


TRIANGLES = {"laplacian": _laplacian_triangles, "random": _random_triangles}


def test_helper_builds_and_loads():
    """The helper builds into ``_build/`` under a hashed name, a second
    build finds it, and ``available()`` reports it."""
    path, _ = native.build_host()
    assert os.path.isfile(path)
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(path).startswith("libdunetpu_host_")
    assert native.build_host() == (path, "")
    assert native.available()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("side", ["lower", "upper_mirrored"])
@pytest.mark.parametrize("problem", sorted(TRIANGLES))
def test_schedules_equal_the_numpy_paths(problem, side, dtype):
    """Levels and the whole chunk schedule (chunks of 16 rows, so levels
    split into several chunks): the helper's arrays equal the port's numpy
    versions' and the JAX package's numpy path's, values and dtypes."""
    T = TRIANGLES[problem]()[0 if side == "lower" else 1]
    n = T.shape[0]
    data = T.data.astype(dtype)
    lev = native.levels_from_csr(T.indptr, T.indices)
    assert lev.dtype == np.int32
    assert np.array_equal(lev, tlu._levels_from_csr_numpy(T.indptr, T.indices))
    assert np.array_equal(lev, jlu._levels_from_csr(T.indptr, T.indices))
    assert np.array_equal(tlu._levels_from_csr(T.indptr, T.indices), lev)

    got = tlu._chunk_schedule(T.indptr, T.indices, data, n, 16)
    want = tlu._chunk_schedule_numpy(T.indptr, T.indices, data, n, 16)
    ref = jlu._chunk_schedule(T.indptr, T.indices, data, n, 16)
    assert got[3:] == want[3:] and got[3] == ref[3]
    assert got[4] == int(lev.max()) + 1 > 1
    for g, w, r in zip(got[:3], want[:3], ref[:3]):
        assert g.dtype == w.dtype == r.dtype
        assert np.array_equal(g, w) and np.array_equal(g, r)


def test_schedule_of_an_empty_triangle():
    """A triangle with no entries: one level, chunks of consecutive rows,
    kmax 1, as the numpy path gives."""
    T = sp.csr_matrix((40, 40))
    got = native.chunk_schedule(T.indptr, T.indices, T.data, 40, 16)
    want = tlu._chunk_schedule_numpy(T.indptr, T.indices, T.data, 40, 16)
    assert got[3:] == want[3:] == (1, 1)
    for g, w in zip(got[:3], want[:3]):
        assert np.array_equal(g, w)


def test_chunk_schedule_refuses_other_dtypes():
    """Other value types: ``None`` from the bridge (the JAX module's
    contract), ``TypeError`` from the engine, never a numpy fallback."""
    L, _ = _random_triangles(60)
    data = L.data.astype(np.float16)
    assert native.chunk_schedule(L.indptr, L.indices, data, 60, 16) is None
    with pytest.raises(TypeError, match="float16"):
        tlu._chunk_schedule(L.indptr, L.indices, data, 60, 16)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_csr_to_ell_equals_numpy(dtype):
    """CSR -> ELL packing: each row's entries in order, then ``pad_col``
    and 0 up to kmax; empty rows too."""
    S = sp.random(300, 280, density=0.03, random_state=np.random.RandomState(5), format="csr")
    S = S.astype(dtype)
    kmax = int(np.diff(S.indptr).max()) + 2
    cols, vals = native.csr_to_ell(S.indptr, S.indices, S.data, kmax, 279)
    want_c = np.full((300, kmax), 279, np.int32)
    want_v = np.zeros((300, kmax), dtype)
    for i in range(300):
        s, e = S.indptr[i], S.indptr[i + 1]
        want_c[i, : e - s] = S.indices[s:e]
        want_v[i, : e - s] = S.data[s:e]
    assert cols.dtype == np.int32 and vals.dtype == dtype
    assert np.array_equal(cols, want_c) and np.array_equal(vals, want_v)
    assert native.csr_to_ell(S.indptr, S.indices, S.data.astype(np.int64), kmax, 0) is None
    with pytest.raises(ValueError, match="kmax"):
        native.csr_to_ell(S.indptr, S.indices, S.data, kmax - 3, 0)


def _flipped_band(N=20, flips=(3, 50, 222)):
    """The 2D Dirichlet Laplacian with the sign of a few diagonal entries
    flipped: indefinite, so ``factorize_banded`` takes the LU branch, and
    still diagonally dominant, so no pivot grows."""
    Aj = jproblems.laplacian_dirichlet_2d(N, dtype=np.float64)
    data = np.array(Aj.data)
    data[Aj.offsets.index(0), list(flips)] *= -1.0
    return dia_from_numpy(data, Aj.offsets, Aj.shape, device="cpu")


def test_lu_banded_agrees_with_numpy():
    """The helper's band LU against the numpy loop at 1e-13 of max|band|
    (it multiplies by 1/pivot and may fuse the update into an FMA); the
    numpy loop gives the JAX package's numpy path's bits; L U rebuilds A;
    and ``factorize_banded`` takes the LU branch on this band."""
    At = _flipped_band()
    band, bw, n = tbanded._band_from_dia(At)
    lb, ub = tbanded._lu_banded(band, bw, n)
    lb0, ub0 = tbanded._lu_banded_numpy(band, bw, n)
    scale = np.abs(band).max()
    assert np.abs(lb - lb0).max() <= 1e-13 * scale
    assert np.abs(ub - ub0).max() <= 1e-13 * scale
    lbj, ubj = jbanded._lu_banded(band, bw, n)
    assert np.array_equal(lb0, lbj) and np.array_equal(ub0, ubj)
    L = sum(sp.diags(lb[b, : n - b], -b) for b in range(bw + 1))
    U = sum(sp.diags(ub[b, : n - b], b) for b in range(bw + 1))
    dense = At.to_scipy().toarray()
    assert np.abs((L @ U).toarray() - dense).max() <= 1e-13 * scale
    assert factorize.factorize_banded(At, C=128).stats[3] == "lu"


def test_lu_banded_zero_pivot_reports_its_row():
    """A pivot that is exactly zero at row 3 (rows 0-2 do not couple to
    it): the helper returns 3 and the engine raises naming it, as the numpy
    loop does."""
    n, bw = 8, 1
    band = np.zeros((2 * bw + 1, n))  # band[bw + o, i] = A[i, i + o]
    band[bw] = 2.0
    band[bw, 3] = 0.0
    band[bw + 1, :-1] = 1.0  # superdiagonal A[i, i+1]
    band[bw - 1, 1:] = 1.0  # subdiagonal A[i, i-1]
    band[bw + 1, 2] = band[bw - 1, 3] = 0.0  # A[2, 3] = A[3, 2] = 0
    work = tbanded._lu_band_work(band, bw, n)
    assert native.lu_banded(work, n, bw) == 3
    for lu in (tbanded._lu_banded, tbanded._lu_banded_numpy):
        with pytest.raises(ZeroDivisionError, match="zero pivot at row 3"):
            lu(band, bw, n)
    with pytest.raises(ValueError, match="float64"):
        native.lu_banded(work.astype(np.float32), n, bw)


def test_out_of_bounds_input_is_refused():
    """Offsets or columns that would take the helper out of its arrays
    raise ``ValueError`` before any pointer is passed."""
    L, _ = _random_triangles(60)
    bad = L.indices.copy()
    bad[0] = 60
    with pytest.raises(ValueError, match="columns"):
        native.levels_from_csr(L.indptr, bad)
    with pytest.raises(ValueError, match="offsets"):
        native.chunk_schedule(L.indptr[:-1], L.indices, L.data, 60, 16)
    with pytest.raises(ValueError, match="offsets"):
        native.levels_from_csr(L.indptr[::-1].copy(), L.indices)


def test_broken_source_raises_with_the_compiler_output(tmp_path):
    """A source g++ refuses: ``RuntimeError`` carrying g++'s message, and
    no library is left behind."""
    src = tmp_path / "broken.cpp"
    src.write_text('extern "C" int f() { return undeclared_name; }\n')
    out = tmp_path / "build"
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        native.build_host(source=str(src), build_dir=str(out))
    assert "undeclared_name" in str(err.value)
    assert not any(p.suffix == ".so" for p in out.iterdir())


def test_concurrent_builds_both_load_a_whole_library(tmp_path):
    """Two processes build the helper into one empty directory at once:
    each compiles to a file of its own and renames it onto the shared
    name, so both load a whole library and compute the same levels, and no
    temporary file is left."""
    code = (
        "import sys, numpy as np, scipy.sparse as sp\n"
        "from dune_eigensolver_tpu_torch.utils import native\n"
        "path, _ = native.build_host(build_dir=sys.argv[1])\n"
        "lib = native._bind_host(path)\n"
        "L = sp.tril(sp.random(200, 200, density=0.05, random_state=np.random.RandomState(2),"
        " format='csr'), k=-1, format='csr')\n"
        "lev = np.zeros(200, np.int32)\n"
        "lib.levels_from_csr(200, L.indptr.astype(np.int64), L.indices.astype(np.int64), lev)\n"
        "print(path, int(lev.max()), int(lev.sum()))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    lines = [o.strip().splitlines()[-1] for o in outs]
    assert lines[0] == lines[1]
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(lines[0].split()[0])]


def test_package_paths_never_call_the_numpy_versions(monkeypatch):
    """``factorize`` (host LU) and ``factorize_banded``'s LU branch run
    with the numpy versions made to raise: the helper serves both, and the
    host LU's level counts come from its schedules."""

    def refuse(*_a, **_k):
        raise AssertionError("a numpy version was called")

    for name in ("_levels_from_csr_numpy", "_chunk_schedule_numpy"):
        monkeypatch.setattr(tlu, name, refuse)
    monkeypatch.setattr(tbanded, "_lu_banded_numpy", refuse)
    Aj = jproblems.laplacian_dirichlet_2d(16, dtype=np.float64)
    At = dia_from_numpy(np.asarray(Aj.data), Aj.offsets, Aj.shape, device="cpu")
    F = factorize.factorize(At, chunk=64)
    Fj = jlu.factorize(Aj, chunk=64, dtype=np.float64)
    assert F.stats == Fj.stats
    assert factorize.factorize_banded(_flipped_band(), C=128).stats[3] == "lu"


def test_host_setup_bench_runs_in_turns():
    """``bench/host_setup.py`` times ``lu_inverse_factory`` in a fresh
    process a run, the trees in the order given and then reversed, each
    record with the factors' statistics (here one tree, on the CPU)."""
    from dune_eigensolver_tpu_torch.bench import host_setup

    recs = host_setup.run([REPO], N=12, device="cpu")
    assert [r["tree"] for r in recs] == [REPO, REPO]
    assert recs[0]["stats"] == recs[1]["stats"] and recs[0]["chunks_L"] >= 1
    assert all(r["seconds"] > 0 for r in recs)
