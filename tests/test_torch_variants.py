"""The kernel experiments' plain versions and the column-layout wrappers
against the JAX package, on the CPU.

The JAX staging variants (``experiments/kernel_variants.py``: ``spmm_c``,
``spmm_b``, ``spmm_d``) and copy probes (``experiments/pipeline_probe.py``)
run their Pallas kernels in interpret mode, through a monkeypatch of
``pl.pallas_call`` made in this file (nothing in ``experiments/`` is
edited); all of them, manual DMA included, run that way on the CPU. The port's
CUDA kernels cannot run here: what is held to the JAX kernels is their plain
version, ``dia_spmm_t_reference`` (one for all three variants, which
compute one function) and ``ident_reference``/``identd_reference``; the
kernels themselves are held to those plain versions on the card
(tests/test_torch_cuda.py). Inputs come from numpy seeds.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import experiments.kernel_variants as jkv
import experiments.pipeline_probe as jpp
from dune_eigensolver_tpu.kernels.dia_spmm import PaddedLayout, _round_up
from dune_eigensolver_tpu.ops import ortho as jortho
from dune_eigensolver_tpu.sparse import formats as jformats
from dune_eigensolver_tpu.sparse import problems as jproblems
from dune_eigensolver_tpu.sparse.spmm import spmm as jspmm

from dune_eigensolver_tpu_torch.experiments import kernel_variants as tkv
from dune_eigensolver_tpu_torch.experiments import pipeline_probe as tpp
from dune_eigensolver_tpu_torch.kernels.dia_spmm import dia_spmm_t_reference
from dune_eigensolver_tpu_torch.ops import ortho as tortho
from dune_eigensolver_tpu_torch.solvers.standard import random_multivector, random_multivector_t
from dune_eigensolver_tpu_torch.sparse import (
    bsr_from_numpy,
    dia_from_numpy,
    ell_from_numpy,
    spmm,
)
from dune_eigensolver_tpu_torch.sparse.spmm import bsr_spmm, dia_spmm, ell_spmm

torch.set_num_threads(2)


@pytest.fixture
def interpret(monkeypatch):
    """Run every ``pl.pallas_call`` of the two experiment modules in
    interpret mode (they share the ``pl`` module object)."""
    assert jkv.pl is jpp.pl
    monkeypatch.setattr(jkv.pl, "pallas_call",
                        functools.partial(jkv.pl.pallas_call, interpret=True))


def _dia_case(N, m, seed):
    """2D 5-point pattern with seeded coefficients, f32; n = N^2 <= 2,000."""
    rng = np.random.default_rng(seed)
    A = jproblems.laplacian_dirichlet_2d(N, dtype=np.float32)
    n = A.shape[0]
    data = np.asarray(A.data) * rng.uniform(0.5, 1.5, (5, n)).astype(np.float32)
    Aj = jformats.DIAMatrix(data=jnp.asarray(data), offsets=A.offsets, shape=A.shape)
    At = dia_from_numpy(data, A.offsets, A.shape, device="cpu")
    X = rng.standard_normal((m, n)).astype(np.float32)
    return Aj, At, X


def _jax_variant(name, Aj, X, T):
    """The JAX variant's result on (m, n), through the operand layout its
    ``main`` gives it."""
    m, n = X.shape
    Xt = jnp.asarray(X)
    if name == "c":
        halo = max(abs(o) for o in Aj.offsets)
        H = _round_up(max(halo, 128), 128)
        n_pad = _round_up(n, T)
        Xp = jnp.pad(Xt, ((0, 0), (H, H + n_pad - n)))
        data = jnp.pad(Aj.data, ((0, 0), (0, n_pad - n)))
        return np.asarray(jkv.spmm_c(Aj.offsets, Aj.shape, T, data, Xp))[:, :n]
    L = PaddedLayout(n, m, Aj.offsets, tile=T)
    Ap, Xp = L.pad_operator(Aj), L.pad(Xt)
    if name.startswith("b"):
        s, q = int(name[1]), int(name[2])
        Y = jkv.spmm_b(Aj.offsets, L.T, L.G, L.width, Ap.data, Xp, nslots=s, depth=q)
    else:
        Y = jkv.spmm_d(Aj.offsets, L.T, L.width, Ap.data, Xp, alias=name == "d_alias")
    return np.asarray(L.unpad(Y))


@pytest.mark.parametrize("name", ["c", "b21", "b32", "b43", "d", "d_alias"])
@pytest.mark.parametrize("N,T", [(40, 256), (44, 512)])
def test_jax_variant_equals_port_plain_version(interpret, name, N, T):
    """f32, the same five products per entry summed in offset order by both:
    1e-5 of max|Y|. n = 1,600 and 1,936 are no multiples of the tile."""
    Aj, At, X = _dia_case(N, 8, seed=N)
    Y = dia_spmm_t_reference(At, torch.from_numpy(X)).numpy()
    J = _jax_variant(name, Aj, X, T)
    assert J.shape == Y.shape
    assert np.abs(J - Y).max() <= 1e-5 * np.abs(Y).max()


def test_jax_variant_d_two_chain_equals_port_plain_version(interpret):
    """The reference's in-place 2-chain check, against the plain version
    applied twice."""
    Aj, At, X = _dia_case(40, 8, seed=7)
    L = PaddedLayout(X.shape[1], 8, Aj.offsets, tile=256)
    Ap, Xp = L.pad_operator(Aj), L.pad(jnp.asarray(X))
    once = jkv.spmm_d(Aj.offsets, L.T, L.width, Ap.data, Xp, alias=True)
    twice = np.asarray(L.unpad(jkv.spmm_d(Aj.offsets, L.T, L.width, Ap.data, once, alias=True)))
    Xt = torch.from_numpy(X)
    Y2 = dia_spmm_t_reference(At, dia_spmm_t_reference(At, Xt)).numpy()
    assert np.abs(twice - Y2).max() <= 1e-5 * np.abs(Y2).max()


@pytest.mark.parametrize("T", [256, 512])
def test_jax_copy_probes_equal_port_plain_versions(interpret, T):
    """One f32 add per element on both sides: exact."""
    rng = np.random.default_rng(T)
    x = rng.standard_normal((8, 2048)).astype(np.float32)
    d = rng.standard_normal((5, 2048)).astype(np.float32)
    xt, dt = torch.from_numpy(x), torch.from_numpy(d)
    assert np.array_equal(np.asarray(jpp.pallas_ident(T, jnp.asarray(x))),
                          tpp.ident_reference(xt).numpy())
    assert np.array_equal(np.asarray(jpp.pallas_identd(T, jnp.asarray(d), jnp.asarray(x))),
                          tpp.identd_reference(dt, xt).numpy())


def test_kernel_wrappers_refuse_cpu_tensors():
    """No fallback: on a CPU tensor every kernel wrapper raises, before
    anything is built; only the ``main``s choose the plain version."""
    _, At, X = _dia_case(12, 8, seed=0)
    Xt = torch.from_numpy(X)
    for fn in (tkv.spmm_c, tkv.spmm_b, tkv.spmm_d):
        with pytest.raises(ValueError, match="CUDA"):
            fn(At, Xt)
        assert fn.launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        tkv.spmm_d(At, Xt, alias=True)
    with pytest.raises(ValueError, match="CUDA"):
        tpp.ident(256, Xt)
    with pytest.raises(ValueError, match="CUDA"):
        tpp.ident_alias(256, Xt)
    with pytest.raises(ValueError, match="CUDA"):
        tpp.identd(256, Xt[:5].contiguous(), Xt)
    assert tpp.ident.launches == tpp.identd.launches == tpp.ident_alias.launches == 0


def test_experiment_mains_on_cpu(capsys):
    """``main`` with ``--device cpu`` times the plain versions at a small
    size and says that no rate is the card's."""
    assert tpp.main(["1024", "--device", "cpu", "--width", "8192", "--mb", "1"]) == 0
    out = capsys.readouterr().out
    assert "device: cpu" in out and "[plain]" in out and "[kernel]" not in out
    for label in ("1d copy 1MB", "1d copy_ 1MB", "2d copy (  8,8192)", "2d copy ( 64,1024)",
                  "ident+d T=1024", "ident ALIASED T=1024"):
        assert label in out, label
    assert tkv.main(["256", "--device", "cpu", "--N", "32", "--mb", "1"]) == 0
    out = capsys.readouterr().out
    assert "device: cpu (plain version only" in out
    assert "copy:" in out and "plain:" in out and "GB/s" in out and "shipped" not in out
    assert tkv.spmm_c.launches == tkv.spmm_b.launches == tkv.spmm_d.launches == 0


# ---------------------------------------------------------------------------
# Column-layout wrappers
# ---------------------------------------------------------------------------


def _operand(kind, dtype):
    import scipy.sparse as sp

    if kind == "dia":
        J = jproblems.laplacian_dirichlet_2d(20, dtype=dtype)
        return J, dia_from_numpy(np.asarray(J.data), J.offsets, J.shape, device="cpu")
    if kind == "ell":
        S = jproblems.unstructured_laplacian(500, extra_edges=25, seed=3, fmt="scipy")
        J = jformats.ell_from_scipy(sp.csr_matrix(S), dtype=dtype)
        return J, ell_from_numpy(np.asarray(J.data), np.asarray(J.cols), J.shape, J.nnz,
                                 device="cpu")
    J = jproblems.elasticity_2d(9, dtype=dtype)[0]
    return J, bsr_from_numpy(np.asarray(J.bdata), np.asarray(J.bcols), J.shape, J.block, J.nnz,
                             device="cpu")


@pytest.mark.parametrize("kind", ["dia", "ell", "bsr"])
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 1e-5)])
def test_column_layout_spmm(kind, dtype, tol):
    J, T = _operand(kind, dtype)
    X = np.random.default_rng(1).standard_normal((J.shape[1], 8)).astype(dtype)
    Yj = np.asarray(jspmm(J, jnp.asarray(X)))
    Yt = spmm(T, torch.from_numpy(X))
    assert Yt.shape == (J.shape[0], 8) and Yt.dtype == torch.from_numpy(X).dtype
    assert np.abs(Yt.numpy() - Yj).max() <= tol * np.abs(Yj).max()
    named = {"dia": dia_spmm, "ell": ell_spmm, "bsr": bsr_spmm}
    assert torch.equal(named[kind](T, torch.from_numpy(X)), Yt)
    other = "ell" if kind == "dia" else "dia"
    with pytest.raises(TypeError):
        named[other](T, torch.from_numpy(X))
    with pytest.raises(ValueError, match="shape mismatch"):
        spmm(T, torch.from_numpy(X[:-1]))
    with pytest.raises(TypeError):
        spmm(object(), torch.from_numpy(X))


@pytest.mark.parametrize("block", [1, 8])
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 1e-5)])
def test_orthonormalize_blocked_column_layout(block, dtype, tol):
    X = np.random.default_rng(block).standard_normal((700, 16)).astype(dtype)
    Qj = np.asarray(jortho.orthonormalize_blocked(jnp.asarray(X), block=block))
    Qt = tortho.orthonormalize_blocked(torch.from_numpy(X), block=block).numpy()
    assert Qt.shape == X.shape
    assert np.abs(Qt - Qj).max() <= tol * 50  # entries O(1/sqrt(n)); Gram conditioning O(10)
    G = Qt.T.astype(np.float64) @ Qt.astype(np.float64)
    assert np.abs(G - np.eye(16)).max() <= (1e-10 if dtype == np.float64 else 1e-4)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 1e-5)])
def test_dot_products_column_layout(dtype, tol):
    rng = np.random.default_rng(5)
    Q1 = rng.standard_normal((900, 8)).astype(dtype)
    Q2 = rng.standard_normal((900, 8)).astype(dtype)
    t1, t2 = torch.from_numpy(Q1), torch.from_numpy(Q2)
    Gj = np.asarray(jortho.dot_products_all(jnp.asarray(Q1), jnp.asarray(Q2)))
    Gt = tortho.dot_products_all(t1, t2).numpy()
    scale = np.abs(Q1).T @ np.abs(Q2)  # each entry's sum of magnitudes
    assert (np.abs(Gt - Gj) <= tol * scale).all()
    dj = np.asarray(jortho.dot_products_diagonal(jnp.asarray(Q1), jnp.asarray(Q2)))
    dt = tortho.dot_products_diagonal(t1, t2).numpy()
    assert (np.abs(dt - dj) <= tol * np.diag(scale)).all()
    assert np.allclose(dt, np.diag(Gt), rtol=0, atol=float(tol * np.diag(scale).max()))


def test_random_multivector_layouts_agree():
    """Column k of the column layout is row k of the transposed one from
    the same generator state; N(0, 1) entries."""
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    X = random_multivector(g1, 4000, 8, torch.float64, "cpu")
    Xt = random_multivector_t(g2, 4000, 8, torch.float64, "cpu")
    assert X.shape == (4000, 8) and torch.equal(X, Xt.T)
    assert abs(X.mean().item()) < 0.05 and abs(X.std().item() - 1.0) < 0.05
