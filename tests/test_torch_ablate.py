"""The ELL-kernel ablation's plain versions, on the CPU.

The port ablates the body its ELL kernel K2 ships (``csrc/ell_body.cuh``,
instantiated by ``csrc/experiments/ell_ablate.cu``); the CUDA variants
cannot run here, so what is tested is what defines them: each variant's plain version
against an explicit numpy loop, the byte model, the sweep's settings and
the wrappers' refusals, and
``full``'s plain version against the JAX experiment's ``run_variant('full')``
(``experiments/gather_ablate.py``), whose Pallas kernel runs in interpret
mode through a monkeypatch of ``pl.pallas_call`` made here, with
``bench_loop`` replaced by one application. The kernels themselves are held
to these plain versions on the card (tests/test_torch_cuda.py).
"""

import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import dune_eigensolver_tpu.kernels.gather_spmm as jgather
import experiments.gather_ablate as jablate
from dune_eigensolver_tpu.sparse import formats as jformats
from dune_eigensolver_tpu.sparse import problems as jproblems

from dune_eigensolver_tpu_torch.experiments import gather_ablate as ga
from dune_eigensolver_tpu_torch.sparse import ell_from_numpy, ell_from_scipy

torch.set_num_threads(2)


@pytest.fixture
def one_application(monkeypatch):
    """``run_variant`` returns the kernel's output instead of a time, and
    its ``pl.pallas_call`` runs in interpret mode."""
    monkeypatch.setattr(jablate.pl, "pallas_call",
                        functools.partial(jablate.pl.pallas_call, interpret=True))
    monkeypatch.setattr(jablate, "bench_loop",
                        lambda fn, x, K=0, reps=0, op_args=(): fn(x, *op_args))


@pytest.mark.parametrize("Nel", [8, 10, 12])
def test_jax_full_variant_equals_port_plain_version(one_application, Nel):
    """f32, the same products summed in another order: 1e-5 of max|Y|. The
    operand is the experiment's (``elasticity_2d(Nel)`` scaled by its max
    row sum, as scalar ELL), n = 98..242, tile 256. ``run_variant`` clones
    the kernel's invocation without the COO tail of ``windowed_spmm_t``, so
    the few tail entries the planner left (``far_*``) are added here."""
    Ae, _ = jproblems.elasticity_2d(Nel, dtype=np.float32)
    Sa = Ae.to_scipy()
    Sa = Sa / float(np.abs(Sa).sum(axis=1).max())
    Aj = jformats.ell_from_scipy(Sa, dtype=np.float32)
    W, _, L = jgather.make_windowed_operands(Aj, tile=256, m=8)
    X = np.random.default_rng(Nel).standard_normal((8, Aj.shape[0])).astype(np.float32)
    J = np.array(L.unpad(jablate.run_variant(W, L.pad(jnp.asarray(X)), "full")))
    rows, cols, vals = (np.asarray(a) for a in (W.far_rows, W.far_cols, W.far_vals))
    np.add.at(J, (slice(None), rows), vals[None, :] * X[:, cols])
    At = ell_from_numpy(np.asarray(Aj.data), np.asarray(Aj.cols), Aj.shape, Aj.nnz, device="cpu")
    Y = ga.variant_reference(At, torch.from_numpy(X), "full").numpy()
    assert J.shape == Y.shape
    assert np.abs(J - Y).max() <= 1e-5 * np.abs(Y).max()


def _operand(kind):
    if kind == "square":
        S = sp.random(301, 301, density=0.03, random_state=1, format="csr") + sp.eye(301)
    else:  # more rows than columns: i' = min(i, ncols - 1) matters
        S = sp.random(120, 77, density=0.08, random_state=2, format="csr")
    return ell_from_scipy(sp.csr_matrix(S), dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("variant", ga.VARIANTS)
@pytest.mark.parametrize("kind", ["square", "tall"])
def test_variant_reference_computes_its_function(variant, kind):
    """Each plain version against the formula of the module docstring,
    written as a loop over the stored slots, in f64: 1e-13 of the sum of
    magnitudes."""
    A = _operand(kind)
    n, ncols = A.shape
    data, cols = A.data.numpy(), A.cols.numpy()
    X = np.random.default_rng(3).standard_normal((5, ncols))
    own = np.minimum(np.arange(n), ncols - 1)
    want = np.zeros((5, n))
    if variant == "nofma":
        want = X[:, own] + data[:, 0][None, :]
    else:
        for j in range(A.k):
            col = {"full": cols[:, j], "nogather": own, "nodyn": (own + j) % ncols}[variant]
            want += data[:, j][None, :] * X[:, col]
    got = ga.variant_reference(A, torch.from_numpy(X), variant).numpy()
    assert got.shape == (5, n)
    assert np.abs(got - want).max() <= 1e-13 * (np.abs(data).sum(axis=1).max() * np.abs(X).max() + 1)
    with pytest.raises(ValueError, match="unknown variant"):
        ga.variant_reference(A, torch.from_numpy(X), "nothing")


def test_variant_bytes_counts_what_the_function_needs():
    A = _operand("square")
    n, nnz, m = A.shape[0], A.nnz, 8
    xy = 2 * n * m
    assert ga.variant_bytes(A, m, "full") == 4 * (2 * nnz + xy)
    assert ga.variant_bytes(A, m, "nogather") == ga.variant_bytes(A, m, "nodyn") == 4 * (nnz + xy)
    assert ga.variant_bytes(A, m, "nofma") == 4 * (n + xy)


@pytest.mark.parametrize("index_bytes", [2, 4])
def test_variant_bytes_counts_the_index_width_k2_reads(index_bytes):
    """``full``'s copy bound counts its indices at the width K2 reads (int16
    offsets on a mesh-ordered operand); the other variants load no index
    their function needs."""
    A = _operand("square")
    n, nnz, m = A.shape[0], A.nnz, 8
    assert ga.variant_bytes(A, m, "full", index_bytes) == 4 * (nnz + 2 * n * m) + index_bytes * nnz
    for variant in ("nogather", "nodyn", "nofma"):
        assert ga.variant_bytes(A, m, variant, index_bytes) == ga.variant_bytes(A, m, variant)


def test_sweep_holds_k2s_setting():
    """At most 12 (rows, kc) settings of K2's body, K2's own (8, 9) among
    them, on the grid K2's tuning tried: rows 1, 4, 8 x kc 6, 8, 9, 12."""
    assert ga.K2_SETTING == (8, 9) and ga.K2_SETTING in ga.SWEEP
    assert len(ga.SWEEP) <= 12 and len(set(ga.SWEEP)) == len(ga.SWEEP)
    assert {r for r, _ in ga.SWEEP} == {1, 4, 8} and {k for _, k in ga.SWEEP} == {6, 8, 9, 12}


@pytest.mark.parametrize("variant,rows,kc", [
    ("full", 3, 9), ("full", 8, 10), ("full", 2, 9), ("full", 0, 0),
    ("nogather", 4, 9), ("nodyn", 8, 6), ("nofma", 1, 9),
])
def test_ablate_refuses_an_unbuilt_setting(variant, rows, kc):
    """A (rows, kc) the source did not build is refused before anything is
    loaded or built, on any device; the degraded variants exist at K2's
    setting alone."""
    A = ell_from_scipy(sp.eye(40, format="csr"), dtype=torch.float32, device="cpu")
    X = torch.ones((8, 40))
    before = ga.ablate_full.launches
    with pytest.raises(ValueError, match="not built"):
        ga._launch(variant, A, X, rows, kc)
    if variant == "full":
        with pytest.raises(ValueError, match="not built"):
            ga.ablate_full(A, X, rows, kc)
    assert ga.ablate_full.launches == before


def test_ablate_wrappers_refuse_cpu_tensors():
    """No fallback: on a CPU tensor every kernel wrapper raises, before
    anything is built; only ``main`` and ``run_variant`` on a CPU tensor
    choose the plain version."""
    A = ell_from_scipy(sp.eye(40, format="csr"), dtype=torch.float32, device="cpu")
    X = torch.ones((8, 40))
    for fn in (ga.ablate_full, ga.ablate_nogather, ga.ablate_nodyn, ga.ablate_nofma):
        with pytest.raises(ValueError, match="CUDA"):
            fn(A, X)
        assert fn.launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        ga.check_variants(A, X)
    assert ga.run_variant(A, X, "nofma") > 0  # the plain version, timed


def test_ablate_operands_are_scaled_and_square():
    ops = ga.ablate_operands("cpu", Nel=6, graph_n=500)
    assert [name for name, _ in ops] == ["elasticity_6", "graph_500"]
    for _, A in ops:
        assert A.shape[0] == A.shape[1] and A.dtype == torch.float32
        assert abs(A.data.abs().sum(dim=1).max().item() - 1.0) < 1e-6
    assert ops[0][1].k == 18 and ops[0][1].shape[0] == 2 * 5 * 5


def test_ablate_main_on_cpu(capsys):
    """``main`` with ``--device cpu`` times the plain versions of the four
    variants on both operands, prints the greppable lines (no copy share:
    no rate here is the card's) and no sweep."""
    assert ga.main(["6", "--device", "cpu", "--m", "8", "--graph-n", "400"]) == 0
    out = capsys.readouterr().out
    assert "device: cpu (plain versions" in out and out.rstrip().endswith("done")
    lines = [ln for ln in out.splitlines() if ln.startswith("ABLATE")]
    assert len(lines) == 8 and not any("kc=" in ln for ln in lines)
    for ln, variant in zip(lines, ga.VARIANTS * 2):
        assert re.fullmatch(rf"ABLATE variant={variant} us=\d+\.\d gbps=\d+\.\d "
                            r"streamed_bytes=\d+ streamed_gbps=\d+\.\d share=\d+\.\d{3} "
                            r"copy_share=n/a operand=(elasticity_6|graph_400)", ln), ln
    assert "share=1.000 copy_share=n/a operand=elasticity_6" in lines[0]
