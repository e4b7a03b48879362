"""ELL/BSR containers and SpMMs of the PyTorch port against the JAX package.

The port's plain versions ``ell_spmm_t_reference``/``bsr_spmm_t_reference``
are held against the JAX package's XLA formulations ``ell_spmm_t``/
``bsr_spmm_t`` and against its Pallas gather kernels (``_seg_kernel``,
``_blk_kernel``) run through ``windowed_spmm_t`` in interpret mode, on the
same seeded operands carried across as numpy arrays. The containers, their
bridges and setup operations, the problem generators and the RCM reordering
must agree with the JAX package exactly. The CUDA kernels themselves run
only on a card: tests/test_torch_cuda.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import reverse_cuthill_mckee

from dune_eigensolver_tpu.kernels.gather_spmm import (
    windowed_from_bsr,
    windowed_from_ell,
    windowed_spmm_t,
)
from dune_eigensolver_tpu.solvers import standard as jstandard
from dune_eigensolver_tpu.sparse import formats as jformats
from dune_eigensolver_tpu.sparse import problems as jproblems
from dune_eigensolver_tpu.sparse.reorder import rcm_pencil as jrcm_pencil
from dune_eigensolver_tpu.sparse.spmm import bsr_spmm_t, ell_spmm_t
from dune_eigensolver_tpu_torch.kernels import gather_spmm as kg
from dune_eigensolver_tpu_torch.solvers import standard as tstandard
from dune_eigensolver_tpu_torch.solvers.engine import make_engine
from dune_eigensolver_tpu_torch.sparse import (
    BSRMatrix,
    DIAMatrix,
    ELLMatrix,
    bsr_from_numpy,
    bsr_from_scipy,
    ell_from_numpy,
    ell_from_scipy,
    problems,
    rcm_pencil,
    spmm_t,
    unpermute_vectors,
)

torch.set_num_threads(2)


def _random_sym_csr(n, avg_nnz, seed):
    """Random sparse SPD (weighted-graph-Laplacian-like), RCM-ordered, as
    tests/test_gather_spmm.py builds it."""
    S = sp.random(n, n, density=avg_nnz / n, random_state=seed, format="csr")
    S = S + S.T
    S.data = -np.abs(S.data)
    S = S - sp.diags(S.diagonal())
    S = S + sp.diags(np.asarray(-S.sum(axis=1)).ravel() + 0.5)
    perm = reverse_cuthill_mckee(sp.csr_matrix(S), symmetric_mode=True)
    return sp.csr_matrix(S)[perm][:, perm]


def _kron_blocks(nb, b, seed):
    """A b x b-block operator: a random sparse pattern times a dense SPD
    block (tests/test_gather_spmm.py:309-331)."""
    g = np.random.default_rng(seed)
    blockmat = g.normal(size=(b, b))
    return sp.csr_matrix(sp.kron(_random_sym_csr(nb, 5, seed=7), blockmat + blockmat.T + 4 * np.eye(b)))


def _jax_operand(name, dtype):
    """The JAX package's container for each named operand."""
    if name == "ell900":
        return jformats.ell_from_scipy(_random_sym_csr(900, 7, seed=0), dtype=dtype)
    if name == "ell1001":
        return jformats.ell_from_scipy(_random_sym_csr(1001, 6, seed=4), dtype=dtype)
    if name == "elast12_bsr":
        return jproblems.elasticity_2d(12, dtype=dtype)[0]
    if name == "elast12_ell":
        A = jproblems.elasticity_2d(12, dtype=np.float64)[0]
        return jformats.ell_from_scipy(A.to_scipy(), dtype=dtype)
    if name == "kron4_bsr":
        return jformats.bsr_from_scipy(_kron_blocks(300, 4, seed=2), block=(4, 4), dtype=dtype)
    raise KeyError(name)


def _bridge(J):
    """The port's container holding the same bits as the JAX container J."""
    if isinstance(J, jformats.BSRMatrix):
        return bsr_from_numpy(np.asarray(J.bdata), np.asarray(J.bcols), J.shape, J.block, J.nnz,
                              device="cpu")
    return ell_from_numpy(np.asarray(J.data), np.asarray(J.cols), J.shape, J.nnz, device="cpu")


OPERANDS = ["ell900", "ell1001", "elast12_bsr", "elast12_ell", "kron4_bsr"]


def _jax_spmm(J, Xt):
    return bsr_spmm_t(J, Xt) if isinstance(J, jformats.BSRMatrix) else ell_spmm_t(J, Xt)


@pytest.mark.parametrize("name", OPERANDS)
@pytest.mark.parametrize("m", [8, 24, 128])
@pytest.mark.parametrize(
    "dtype,rtol",
    # f64: the same products, summed in another order: last-bit roundoff;
    # f32: one f32 rounding per term, relative to the output's magnitude
    [(np.float64, 1e-12), (np.float32, 1e-5)],
)
def test_reference_matches_xla(name, m, dtype, rtol):
    J = _jax_operand(name, dtype)
    Xt = np.random.default_rng(m).standard_normal((m, J.shape[1])).astype(dtype)
    Yj = np.asarray(_jax_spmm(J, jnp.asarray(Xt)))
    A = _bridge(J)
    Yt = spmm_t(A, torch.from_numpy(Xt)).numpy()
    assert Yt.dtype == dtype and Yt.shape == (m, J.shape[0])
    np.testing.assert_allclose(Yt, Yj, rtol=rtol, atol=rtol * np.abs(Yj).max())


@pytest.mark.parametrize(
    "name,m",
    # every operand at m=8, the 2x2 BSR and an ELL also at 24 and 128 (the
    # interpret mode costs seconds per case; the XLA test above covers all)
    [(name, 8) for name in OPERANDS]
    + [(name, m) for name in ("elast12_bsr", "ell1001") for m in (24, 128)],
)
def test_reference_matches_pallas_interpret(name, m):
    """Against the TPU kernels themselves: ``_seg_kernel`` for ELL,
    ``_blk_kernel`` for the b=2 and b=4 BSR operands, in interpret mode on
    their right-padded windowed layout (tile 256 keeps the interpret-mode
    compile small; the kernels compute the same for any tile). f32, in
    other summation orders: 1e-5 of the output's magnitude."""
    J = _jax_operand(name, np.float32)
    n = J.shape[0]
    W = (windowed_from_bsr if isinstance(J, jformats.BSRMatrix) else windowed_from_ell)(
        J, tile=256, m=m
    )
    Xt = np.random.default_rng(m + 1).standard_normal((m, n)).astype(np.float32)
    Xp = jnp.pad(jnp.asarray(Xt), ((0, 0), (0, W.width - n)))
    Yj = np.asarray(windowed_spmm_t(W, Xp, interpret=True))[:, :n]
    Yt = spmm_t(_bridge(J), torch.from_numpy(Xt)).numpy()
    np.testing.assert_allclose(Yt, Yj, rtol=1e-5, atol=1e-5 * np.abs(Yj).max())


def test_reference_bf16_accumulates_in_f32():
    """bf16 storage sums in f32 and rounds once, as the Pallas kernels do:
    within one bf16 ulp (2^-7 relative) of the f32 product of the same
    bf16 inputs."""
    for J in (_jax_operand("ell900", np.float32), _jax_operand("elast12_bsr", np.float32)):
        A = _bridge(J)
        X = torch.from_numpy(np.random.default_rng(5).standard_normal((8, J.shape[0])))
        X16 = X.to(torch.bfloat16)
        field = "bdata" if isinstance(A, BSRMatrix) else "data"
        A16 = dataclasses.replace(A, **{field: getattr(A, field).to(torch.bfloat16)})
        Y16 = spmm_t(A16, X16)
        assert Y16.dtype == torch.bfloat16
        # the same bf16 values, summed in f32
        exact = spmm_t(dataclasses.replace(A, **{field: getattr(A16, field).float()}), X16.float())
        err = (Y16.float() - exact).abs().max().item()
        assert err <= 2 ** -7 * exact.abs().max().item(), err


def _scipy_sources():
    """(scipy matrix, block or None, k) of the containers the exactness
    tests build: patterns that miss some diagonal entries, so shifts land
    in padding slots (an ELL, the same ELL padded wider, a 2x2 BSR), and
    the two generated operators."""
    S = _random_sym_csr(300, 5, seed=6).tolil()
    for i in (0, 7, 299):
        S[i, i] = 0.0
    S = sp.csr_matrix(S)
    S.eliminate_zeros()
    Sb = _kron_blocks(60, 2, seed=3).tolil()
    Sb[2:4, 2:4] = 0.0  # block row 1 without its diagonal block
    Sb = sp.csr_matrix(Sb)
    Sb.eliminate_zeros()
    return [
        (S, None, None),
        (S, None, 9),
        (Sb, (2, 2), None),
        (jproblems.elasticity_2d(6, dtype=np.float64)[0].to_scipy(), (2, 2), None),
        (jproblems.unstructured_laplacian(200, extra_edges=10, seed=1, fmt="scipy"), None, None),
    ]


def _assert_same_container(T, J):
    assert type(T).__name__ == type(J).__name__
    assert T.shape == tuple(J.shape) and T.nnz == J.nnz
    if isinstance(J, jformats.BSRMatrix):
        assert T.block == tuple(J.block)
        np.testing.assert_array_equal(T.bdata.numpy(), np.asarray(J.bdata))
        np.testing.assert_array_equal(T.bcols.numpy(), np.asarray(J.bcols))
    else:
        np.testing.assert_array_equal(T.data.numpy(), np.asarray(J.data))
        np.testing.assert_array_equal(T.cols.numpy(), np.asarray(J.cols))


def test_converters_and_setup_ops_match_jax_exactly():
    """``*_from_scipy`` (padding contract included), the numpy bridges,
    ``diagonal``, ``with_shifted_diagonal``, ``axpy`` and ``to_scipy`` give
    the JAX package's bits."""
    for S, block, k in _scipy_sources():
        if block is not None:
            J = jformats.bsr_from_scipy(S, block=block)
            T = bsr_from_scipy(S, block=block, device="cpu")
        else:
            J, T = jformats.ell_from_scipy(S, k=k), ell_from_scipy(S, k=k, device="cpu")
        _assert_same_container(T, J)
        _assert_same_container(_bridge(J), J)
        assert T.cols.dtype == torch.int32 if isinstance(T, ELLMatrix) else T.bcols.dtype == torch.int32
        np.testing.assert_array_equal(T.diagonal().numpy(), np.asarray(J.diagonal()))
        _assert_same_container(T.with_shifted_diagonal(0.37), J.with_shifted_diagonal(0.37))
        Jw = J.with_shifted_diagonal(1.25)
        _assert_same_container(T.axpy(0.5, _bridge(Jw)), J.axpy(0.5, Jw))
        assert (T.to_scipy() != J.to_scipy()).nnz == 0


def test_shifted_operand_on_ell_and_bsr_matches_jax():
    """A + shift*B + reg*I, the shift fold of every solve, on the general
    containers (host-side axpy through scipy, as in the reference)."""
    Aj, Bj = jproblems.elasticity_2d(8)
    S = jproblems.unstructured_laplacian(300, extra_edges=15, seed=2, fmt="scipy")
    Uj = jformats.ell_from_scipy(S)
    Ij = jformats.ell_from_scipy(sp.eye(300))
    for A_j, B_j in ((Aj, Bj), (Uj, Ij), (Uj, None)):
        for shift, reg in ((1e-3, 0.0), (0.5, 0.1), (0.0, 0.0)):
            Sj = jstandard.shifted_operand(A_j, B_j, shift, reg)
            St = tstandard.shifted_operand(
                _bridge(A_j), None if B_j is None else _bridge(B_j), shift, reg
            )
            _assert_same_container(St, Sj)


def test_generators_match_jax():
    """The vectorised elasticity assembly and the graph Laplacian give the
    JAX package's matrices bit for bit."""
    for J, T in zip(jproblems.elasticity_2d(12), problems.elasticity_2d(12, device="cpu")):
        _assert_same_container(T, J)
    for J, T in zip(jproblems.elasticity_2d(5, E=2.0, nu=0.25, lumped_mass=False),
                    problems.elasticity_2d(5, E=2.0, nu=0.25, lumped_mass=False, device="cpu")):
        _assert_same_container(T, J)
    _assert_same_container(
        problems.unstructured_laplacian(800, 40, seed=5, device="cpu"),
        jproblems.unstructured_laplacian(800, 40, seed=5),
    )
    Sj = jproblems.unstructured_laplacian(500, 25, seed=3, fmt="scipy")
    St = problems.unstructured_laplacian(500, 25, seed=3, fmt="scipy")
    assert (Sj != St).nnz == 0
    A32, _ = problems.elasticity_2d(4, dtype=torch.float32, device="cpu")
    assert A32.dtype == torch.float32 and A32.bcols.dtype == torch.int32


def test_rcm_pencil_matches_jax():
    S = jproblems.unstructured_laplacian(800, extra_edges=40, seed=5, fmt="scipy")
    Aj, _, pj = jrcm_pencil(S)
    At, Bt, pt = rcm_pencil(S, device="cpu")
    np.testing.assert_array_equal(pt, pj)
    _assert_same_container(At, Aj)
    assert Bt is None
    Ej, Mj = jproblems.elasticity_2d(7)
    Aj, Bj, pj = jrcm_pencil(Ej, Mj, block=(2, 2))
    At, Bt, pt = rcm_pencil(_bridge(Ej), _bridge(Mj), block=(2, 2), dtype=torch.float32,
                            device="cpu")
    np.testing.assert_array_equal(pt, pj)
    assert At.dtype == torch.float32 and isinstance(Bt, BSRMatrix)
    np.testing.assert_array_equal(At.bcols.numpy(), np.asarray(Aj.bcols))
    np.testing.assert_array_equal(At.bdata.numpy(), np.asarray(Aj.bdata).astype(np.float32))
    V = np.random.default_rng(0).standard_normal((len(pt), 2))
    np.testing.assert_array_equal(unpermute_vectors(V, pt)[pt], V)


def test_spmm_t_dispatch_and_cuda_wrappers_on_cpu():
    """CPU operands take the plain versions and never count a launch; the
    kernel wrappers refuse CPU tensors before they load anything."""
    A = _bridge(_jax_operand("elast12_bsr", np.float32))
    E = _bridge(_jax_operand("elast12_ell", np.float32))
    X = torch.from_numpy(np.random.default_rng(0).standard_normal((8, A.shape[0])).astype(np.float32))
    before = (kg.ell_spmm_t_cuda.launches, kg.bsr_spmm_t_cuda.launches)
    torch.testing.assert_close(spmm_t(A, X), spmm_t(E, X), rtol=1e-5, atol=1e-5)
    assert (kg.ell_spmm_t_cuda.launches, kg.bsr_spmm_t_cuda.launches) == before
    for wrapper, M in ((kg.bsr_spmm_t_cuda, A), (kg.ell_spmm_t_cuda, E)):
        with pytest.raises(ValueError, match="CUDA"):
            wrapper(M, X)
    with pytest.raises(ValueError, match="square blocks"):
        kg.bsr_spmm_t_cuda(
            bsr_from_scipy(_kron_blocks(20, 3, seed=1), block=(3, 3), device="cpu"), X)
    with pytest.raises(TypeError, match="unsupported operand"):
        spmm_t(A.to_scipy(), X)


def test_make_engine_routes_bsr_blocks_the_kernel_lacks_to_ell():
    """Square 2x2/4x4 BSR stays BSR, other blocks are scalar-expanded to
    ELL at setup (the reference's windowed_from_bsr routing), DIA and ELL
    stay as they are, mixed pairs stay mixed; the operator is unchanged."""
    S3 = _kron_blocks(40, 3, seed=5)
    B3 = bsr_from_scipy(S3, block=(3, 3), device="cpu")
    B2 = _bridge(_jax_operand("elast12_bsr", np.float64))
    D = DIAMatrix(torch.ones((1, B2.shape[0]), dtype=torch.float64), (0,), B2.shape)
    A_int, B_int = make_engine(B3, B3)
    assert isinstance(A_int, ELLMatrix) and isinstance(B_int, ELLMatrix)
    X = torch.from_numpy(np.random.default_rng(1).standard_normal((8, S3.shape[0])))
    torch.testing.assert_close(spmm_t(A_int, X), spmm_t(B3, X), rtol=1e-12, atol=1e-12)
    A_int, B_int = make_engine(B2, D)
    assert A_int is B2 and B_int is D
    E = _bridge(_jax_operand("ell900", np.float64))
    A_int, B_int = make_engine(E)
    assert A_int is E and B_int is None


def test_kernel_streams_are_transposed_copies_made_once():
    """The CUDA kernels read the coefficients as (k, n) / (k, nbr, b, b)
    streams: the same values, transposed, contiguous, built once per
    container and reused."""
    E = _bridge(_jax_operand("ell900", np.float32))
    data_t, cols_t = E.kernel_streams
    assert data_t.is_contiguous() and cols_t.is_contiguous()
    assert torch.equal(data_t, E.data.T) and torch.equal(cols_t, E.cols.T)
    assert cols_t.dtype == torch.int32 and E.kernel_streams[0] is data_t
    Bm = _bridge(_jax_operand("kron4_bsr", np.float32))
    bdata_t, bcols_t = Bm.kernel_streams
    assert bdata_t.shape == (Bm.bcols.shape[1], Bm.nbr, 4, 4) and bdata_t.is_contiguous()
    assert torch.equal(bdata_t, Bm.bdata.transpose(0, 1)) and torch.equal(bcols_t, Bm.bcols.T)
    assert Bm.kernel_streams[1] is bcols_t
