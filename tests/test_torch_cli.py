"""The port's config tree, roofline models, timing helper, device default and
CLI against the JAX package's, on the CPU.

Both ``ParameterTree``s read the same INI text and overrides; every function
of ``bench/models.py`` is held to its JAX counterpart exactly; the CLI's
``matvec`` and ``mgs`` protocols run at a small size with ``ev.device=cpu``
and must print the reference's line formats; the ``largest``, ``smallest``
and ``eigenvalues`` protocols run in both packages at a small size (the
JAX package on its CPU backend) and are held to each other as far as two
different random start blocks allow.
"""

import inspect
import os
import re

import numpy as np
import pytest
import torch

import scipy.linalg
from scipy.sparse.linalg import eigsh as _eigsh

import dune_eigensolver_tpu.bench.models as jmodels
import dune_eigensolver_tpu.config as jconfig
import dune_eigensolver_tpu.oracle.scipy_oracle as joracle
import dune_eigensolver_tpu_torch.bench.models as tmodels
import dune_eigensolver_tpu_torch.config as tconfig
import dune_eigensolver_tpu_torch.oracle.scipy_oracle as toracle
from dune_eigensolver_tpu_torch import cli
from dune_eigensolver_tpu_torch.bench.timing import bench_loop
from dune_eigensolver_tpu_torch.utils.device import resolve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INI = os.path.join(REPO, "dune-eigensolver.ini")
FLOAT = r"\d+\.\d+"
ARPACK_SEED = 0


@pytest.fixture(autouse=True)
def _arpack_start_pinned(monkeypatch):
    """Every ARPACK call of these tests, in both packages' oracles, starts
    from one seeded random vector. Given no ``rng`` and no ``v0``, scipy
    draws the start from the operating system's entropy, and about one start
    in 1,500 (2 of seeds 0-2,999 on the 3D pencil of ``3d-mgcg``) lets
    shift-invert Lanczos at k = 8 miss one copy of the triple eigenvalue
    1.05644: the 1e-14 "truth" then holds 1.24123 twice, and a solve's error
    against it reads 0.1795 whatever the solve did. Both oracles call
    ``eigsh`` by their module's name; ``test_smallest_protocol_cpu`` holds
    the pinned oracle to a dense solve."""
    def eigsh(*args, **kw):
        if kw.get("v0") is None and kw.get("rng") is None:
            kw["rng"] = np.random.default_rng(ARPACK_SEED)
        return _eigsh(*args, **kw)

    for mod in (toracle, joracle):
        monkeypatch.setattr(mod, "eigsh", eigsh)


def _flat(tree):
    return {f"{sec}.{k}": v for sec in tree._data for k, v in tree._data[sec].items()}


def test_defaults_equal_reference_but_for_the_two_keys():
    """The port drops the TPU-only ``ev.compile_cache[_dir]`` (absent from
    the reference's DEFAULTS too, read with ``get``) and adds ``ev.device``;
    nothing else differs."""
    t, j = _flat(tconfig.ParameterTree()), _flat(jconfig.ParameterTree())
    assert t.pop("ev.device") == ""
    assert t == j
    assert not any("compile_cache" in k for k in t)


def test_ini_and_overrides_equal_reference(tmp_path):
    ini = tmp_path / "t.ini"
    ini.write_text("[ev]\ntol = 1e-6\nN = 48\nflag = True\n[extra]\nfoo = bar\n[mv]\nm = 24\n")
    over = ["ev.tol=1e-5", "ev.method=arpack", "grid.N=64", "ev.flag=false", "mgs.n=10",
            "new.key=1.5"]
    trees = []
    for mod in (tconfig, jconfig):
        pt = mod.ParameterTree()
        pt.read_ini(INI).read_ini(str(ini)).read_cli(over)
        trees.append(pt)
    t, j = _flat(trees[0]), _flat(trees[1])
    t.pop("ev.device")
    assert t == j
    assert trees[0]["ev.flag"] is False and trees[0]["extra.foo"] == "bar"
    assert trees[0].section("mv") == trees[1].section("mv")
    assert trees[0].get("nope.key", 7) == 7
    with pytest.raises(ValueError):
        trees[0].read_cli(["notakeyvalue"])
    with pytest.raises(KeyError):
        trees[0]["nodot"]


@pytest.mark.parametrize("raw", ["12", "1e-3", "true", "False", " raes ", "0.5", "cpu"])
def test_convert_equals_reference(raw):
    a, b = tconfig._convert(raw), jconfig._convert(raw)
    assert a == b and type(a) is type(b)


MODEL_ARGS = {
    "flops_orthonormalize": [(1 << 20, 16), (1000, 8)],
    "bytes_orthonormalize_naive": [(1 << 20, 16), (1000, 8, 8)],
    "bytes_orthonormalize_blocked": [(1 << 20, 16), (1000, 24, 4, 2)],
    "flops_spmm": [(20_963_328, 8)],
    "bytes_spmm_dia": [(4_194_304, 5, 8), (10_077_696, 7, 24, 2)],
    "bytes_spmm_ell": [(1_048_576, 7_340_032, 8), (100, 700, 3, 8)],
    "flops_trisolve_banded": [(64, 128, 8)],
    "arithmetic_intensity": [(1e9, 3e8), (5.0, 0.0)],
}


@pytest.mark.parametrize("name", sorted(MODEL_ARGS))
def test_models_equal_reference(name):
    for args in MODEL_ARGS[name]:
        assert getattr(tmodels, name)(*args) == getattr(jmodels, name)(*args)


def test_models_cover_every_reference_function():
    public = {n for n, f in inspect.getmembers(jmodels, inspect.isfunction)}
    assert public == set(MODEL_ARGS)
    assert public == {n for n, f in inspect.getmembers(tmodels, inspect.isfunction)}


def test_default_device_raises_without_a_card():
    """The default is the card: on a machine without one the helper, the
    generators and the CLI raise rather than compute on the CPU."""
    from dune_eigensolver_tpu_torch.sparse import dia_from_numpy, problems

    if torch.cuda.is_available():
        assert resolve(None).type == "cuda" and resolve("").type == "cuda"
        return
    for call in (
        lambda: resolve(None),
        lambda: resolve(""),
        lambda: problems.laplacian_dirichlet_2d(4),
        lambda: problems.laplacian_dirichlet_3d(3),
        lambda: problems.elasticity_2d(3),
        lambda: problems.unstructured_laplacian(10),
        lambda: dia_from_numpy(np.ones((1, 4)), (0,), (4, 4)),
        lambda: cli.main(["--test", "mgs", "mgs.n=8"]),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_resolve_passes_explicit_devices():
    assert resolve("cpu") == torch.device("cpu")
    assert resolve(torch.device("cpu")) == torch.device("cpu")
    # the scipy form of the graph needs no device at all
    from dune_eigensolver_tpu_torch.sparse import problems

    assert problems.unstructured_laplacian(10, fmt="scipy").shape == (10, 10)


def test_bench_loop_cpu_counts_applications():
    """K applications per chain, one warm-up chain and ``reps`` timed ones
    on the CPU; the caller's x0 is not modified by an in-place step."""
    calls = []

    def step(x, a):
        calls.append(1)
        return x.add_(a)

    x0 = torch.zeros(4)
    t = bench_loop(step, x0, K=5, reps=3, op_args=(torch.ones(4),))
    assert len(calls) == 5 * (1 + 3) and t > 0
    assert torch.equal(x0, torch.zeros(4))


def test_matvec_protocol_cpu(capsys):
    rc = cli.main([INI, "--test", "matvec", "ev.N=16", "mv.m=8", "ev.device=cpu"])
    out = capsys.readouterr().out.splitlines()
    assert rc == 0
    lines = [ln for ln in out if ln.startswith("RESULT")]
    # on the CPU only the plain variants run
    assert [ln.split()[1] for ln in lines] == ["plain", "plain_t", "bsr_plain", "ell_plain"]
    for ln in lines:
        assert re.fullmatch(rf"RESULT \w+ \d+ \d+ 8 {FLOAT} GFLOP/s {FLOAT} GB/s", ln), ln
    # n and nnz of the 16x16 Laplacian and of elasticity_2d(8) (7x7 interior nodes)
    assert lines[0].split()[2:5] == ["256", str(5 * 256 - 2 * 16 - 2), "8"]
    assert lines[2].split()[2] == str(2 * 7 * 7)


def test_matvec_gather_operands_are_one_scaled_operator():
    """The BSR and the ELL operand of ``matvec`` are the same elasticity
    operator on the N // 2 grid, scaled to a max row sum of 1 (f64: exact
    up to the division's rounding)."""
    Mb, Me = cli.matvec_gather_operands(16, torch.float64, "cpu")
    Sb, Se = Mb.to_scipy(), Me.to_scipy()
    assert Mb.block == (2, 2) and Mb.shape == Me.shape == (2 * 7 * 7, 2 * 7 * 7)
    assert Mb.nnz == Me.nnz == Se.nnz
    assert abs(Sb - Se).max() == 0.0
    assert abs(np.abs(Se).sum(axis=1).max() - 1.0) < 1e-14


def test_mgs_protocol_cpu(capsys):
    rc = cli.main(["--test", "mgs", "mgs.n=10", "ev.device=cpu", "ev.verbose=1"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "device: cpu platform=cpu" in out and "== mgs ==" in out
    (line,) = [ln for ln in out.splitlines() if ln.startswith("P_n_m_i_perfn_perfb:")]
    assert re.fullmatch(rf"P_n_m_i_perfn_perfb: 1 1024 16 15 {FLOAT} {FLOAT}", line), line


@pytest.mark.parametrize("name", ["scaling", "nonsense"])
def test_unported_protocol_returns_2(name, capsys):
    """An unknown name returns 2 before anything runs, naming the tests
    there are. (``scaling`` waited for the distributed layer when this test
    was named; now it runs on a world-size-1 gloo group the CLI starts and
    ends itself, and prints its ``SCALING`` lines.)"""
    import torch.distributed as dist

    argv = ["--test", name, "ev.device=cpu", "scaling.log2_rows_per_device=8",
            "scaling.n_iter=2", "scaling.solver_n_iter=1"]
    if name == "nonsense":
        assert cli.main(argv) == 2
        out = capsys.readouterr().out
        assert "unknown test" in out
        assert "matvec" in out and "mgs" in out and "largest" in out and "scaling" in out
        return
    assert cli.main(argv) == 0
    lines = [ln.split() for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("SCALING ")]
    assert [ln[1:4] for ln in lines] == [
        ["spmm", "xla", "islands"], ["spmm", "xla", "connected"],
        ["solver", "xla", "islands"], ["solver", "xla", "connected"]]
    for ln in lines:
        assert ln[4:6] == ["1", "256"] and float(ln[7]) == 1.0  # P, n, efficiency at P = 1
        assert len(ln) == (8 if ln[1] == "spmm" else 12)  # + four phase columns
    assert not dist.is_initialized()  # the CLI's own group is gone


@pytest.mark.parametrize("name,head", [
    ("smallest", "N_M_TOL_RASERROR_ARPERROR_TIMERATIO: 200 8 2.0e-03 "),
    ("eigenvalues", "RESULT eigenvalues_test raes N=200 m=8 "),
])
def test_ini_defaults_run(name, head, capsys):
    """The reference program's own defaults (the INI: the 2D GenEO pencil
    at N = 200, f32, ``ev.inverse=auto``, the block-banded engine) run and
    print the protocol's line; ``smallest``'s error against the ARPACK truth
    stays within 5e-2 of the largest of the 8 values, as
    ``test_smallest_protocol_cpu`` holds it."""
    torch.set_num_threads(2)
    assert cli.main([INI, "--test", name, "ev.device=cpu"]) == 0
    (line,) = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith(head)]
    if name == "smallest":
        # the largest of the 8 truth values is 0.02714 (ARPACK at 1e-14)
        assert float(line.split()[4]) <= 5e-2 * 0.02714


@pytest.mark.parametrize("method", ["dist", "dist_general"])
def test_distributed_methods_return_2(method, capsys):
    """``ev.method=dist|dist_general`` waited for the distributed layer when
    this test was named; now they run on the CLI's own world-size-1 gloo
    group, which is gone afterwards, and print the ``RESULT`` line with the
    eigenvalues (``ev.verbose=1``) of the GenEO pencil: the smallest is the
    Neumann null space at ~0. An unknown method still raises."""
    import torch.distributed as dist

    torch.set_num_threads(2)
    assert cli.main(["--test", "eigenvalues", f"ev.method={method}", "ev.N=16",
                     "ev.dtype=float64", "ev.verbose=1", "ev.device=cpu"]) == 0
    assert not dist.is_initialized()
    out = capsys.readouterr().out
    (line,) = [ln for ln in out.splitlines()
               if ln.startswith(f"RESULT eigenvalues_test {method} N=16 m=8 ")]
    assert re.search(r"iters=\d+ time=", line)
    ev = [float(v) for v in out.split("eigenvalues: [")[1].split("]")[0].split()]
    assert len(ev) == 6 and abs(ev[0]) < 1e-6 and 0.19 < ev[1] < 0.2
    with pytest.raises(ValueError, match="unknown ev.method"):
        cli.main(["--test", "eigenvalues", "ev.method=nope", "ev.device=cpu"])


def test_default_test_is_the_reference_one_and_unported(capsys):
    """Without --test the reference runs ``largest``. (It was not ported when
    this test was named; now it runs and prints its result line.)"""
    assert cli.main(["ev.device=cpu", "ev.N=12", "ev.dtype=float64"]) == 0
    assert "N_M_TOL_ESARERROR_ESANERROR_ARANERROR_TIMERATIO: 12 8 " in capsys.readouterr().out


SCI = r"\d\.\d{3}e[+-]\d\d"


def _trees(overrides):
    """The same configuration for both packages (the JAX tree has no
    ``ev.device``; its backend in these tests is the CPU)."""
    t = tconfig.ParameterTree().read_ini(INI).read_cli([*overrides, "ev.device=cpu"])
    j = jconfig.ParameterTree().read_ini(INI).read_cli(overrides)
    return t, j


def test_largest_protocol_cpu(capsys):
    """f64, N = 16: both packages find the oracle equal to the closed form
    (1e-10), and stop on the same change-based criterion from different
    random blocks, so their errors against the oracle are of one size
    (both below 0.2, within a factor 4 of each other)."""
    import dune_eigensolver_tpu.cli as jcli

    t, j = _trees(["ev.N=16", "ev.dtype=float64", "ev.m=4"])
    rt = cli.largest_eigenvalues_convergence_test(t)
    (line,) = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("N_M_TOL")]
    assert re.fullmatch(rf"N_M_TOL_ESARERROR_ESANERROR_ARANERROR_TIMERATIO: 16 8 2\.0e-03 "
                        rf"{SCI} {SCI} {SCI} {FLOAT}", line), line
    rj = jcli.largest_eigenvalues_convergence_test(j)
    capsys.readouterr()
    assert set(rt) == set(rj)
    assert rt["oracle_vs_analytic"] <= 1e-10 and rj["oracle_vs_analytic"] <= 1e-10
    assert rt["err_refined"] is None and rt["iterations"] >= 2
    assert rt["err_vs_oracle"] <= 0.2 and rj["err_vs_oracle"] <= 0.2
    assert 0.25 <= rt["err_vs_oracle"] / rj["err_vs_oracle"] <= 4.0


def _dense_smallest(A, B, shift, k):
    """The k smallest eigenvalues of A x = lambda B x from a dense solve of
    B x = mu (A + shift B) x in f64 (B may be semidefinite): lambda =
    1/mu - shift over the k largest mu."""
    Ad, Bd = (toracle._to_scipy(M).toarray().astype(np.float64) for M in (A, B))
    mu = scipy.linalg.eigh(Bd, Ad + shift * Bd, eigvals_only=True)[::-1][:k]
    return np.sort(1.0 / mu - shift)


@pytest.mark.parametrize("overrides", [
    ["ev.N=12", "ev.inverse=cg", "ev.dtype=float64"],
    ["ev.N=8", "ev.dim=3", "ev.inverse=mgcg"],
    ["ev.N=6", "ev.problem=elasticity", "ev.inverse=cg", "ev.dtype=float64"],
    ["ev.N=12", "ev.dtype=float64"],
    ["ev.N=6", "ev.problem=elasticity", "ev.dtype=float64"],
], ids=["geneo-cg", "3d-mgcg", "elasticity-cg", "geneo-banded", "elasticity-rcm"])
def test_smallest_protocol_cpu(overrides, capsys):
    """Both packages against the ARPACK truth on the same pencil: converged,
    and the reference's line. The error is the largest over the whole block
    of 8, whose trailing values a change-based stop at 2e-3 leaves least
    converged: held to 5e-2 of the largest of them, and the two packages'
    errors (different random start blocks) within a factor 4 of each
    other. The truth itself is held to a dense solve (1e-8 of its largest
    value), so an oracle that misses a copy of a multiple eigenvalue fails
    here and not as a solver's error. Every assertion prints both packages'
    numbers."""
    import dune_eigensolver_tpu.cli as jcli
    from dune_eigensolver_tpu_torch.oracle import smallest_generalized

    t, j = _trees(overrides)
    rt = cli.smallest_eigenvalues_convergence_test(t)
    (line,) = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("N_M_TOL")]
    assert re.fullmatch(rf"N_M_TOL_RASERROR_ARPERROR_TIMERATIO: \d+ 8 2\.0e-03 {SCI} {SCI} "
                        rf"{FLOAT}", line), line
    rj = jcli.smallest_eigenvalues_convergence_test(j)
    capsys.readouterr()
    A, B = cli._problem_pair(t)
    shift = float(t["ev.shift"])
    truth, _ = smallest_generalized(A, B, 8, sigma=-shift)
    dense = _dense_smallest(A, B, shift, 8)
    keys = ("err_vs_truth", "oracle_err", "iterations", "converged")
    numbers = (f"port {({k: rt.get(k) for k in keys})}, jax {({k: rj.get(k) for k in keys})}, "
               f"truth {truth}, dense {dense}")
    assert set(rt) == set(rj), numbers
    assert np.abs(truth - dense).max() <= 1e-8 * dense.max(), numbers
    assert rt["converged"] and rj["converged"], numbers
    assert rt["err_vs_truth"] <= 5e-2 * truth.max(), numbers
    assert rj["err_vs_truth"] <= 5e-2 * truth.max(), numbers
    assert 0.25 <= rt["err_vs_truth"] / rj["err_vs_truth"] <= 4.0, numbers
    # ~11-16 each, by the start block
    assert abs(rt["iterations"] - rj["iterations"]) <= 8, numbers


@pytest.mark.parametrize("overrides", [
    ["ev.method=raes", "ev.N=12", "ev.inverse=cg"],
    ["ev.method=tpu", "ev.N=8", "ev.dim=3", "ev.inverse=chebcg"],
    ["ev.method=lobpcg", "ev.N=12", "ev.inverse=cg16"],
    ["ev.method=lobpcg", "ev.N=12", "ev.inverse=none"],
    ["ev.method=lobpcg", "ev.nested=1", "ev.dim=3", "ev.N=16", "ev.inverse=mg",
     "ev.b_identity=1", "ev.min_coarse=6", "ev.ortho_block=8"],
    ["ev.method=arpack", "ev.N=12"],
    ["ev.method=raes", "ev.N=12"],
], ids=["raes", "tpu", "lobpcg-cg16", "lobpcg-none", "lobpcg-nested", "arpack", "raes-banded"])
def test_eigenvalues_protocol_cpu(overrides, capsys):
    """``ev.method`` dispatch in both packages on the same pencil: the
    reference's RESULT line; ARPACK's eigenvalues equal (1e-10); the
    solvers' smallest ``ev.m`` = 4 eigenvalues of the block of 8, from
    different random blocks with a change-based stop at 2e-3, within 1e-2
    (relative to the largest) of each other."""
    import dune_eigensolver_tpu.cli as jcli

    t, j = _trees(overrides)
    rt = cli.eigenvalues_test(t)
    method = t["ev.method"]
    (line,) = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("RESULT")]
    assert re.fullmatch(rf"RESULT eigenvalues_test {method} N=\d+ m=8 iters=-?\d+ "
                        rf"time={FLOAT}s", line), line
    rj = jcli.eigenvalues_test(j)
    capsys.readouterr()
    et, ej = np.asarray(rt["eigenvalues"], np.float64), np.asarray(rj["eigenvalues"], np.float64)
    assert et.shape == ej.shape == (8,)
    if method == "arpack":
        assert rt["iterations"] == -1 and np.abs(et - ej).max() <= 1e-10
    else:
        assert rt["iterations"] > 0
        assert np.abs(et - ej)[:4].max() <= 1e-2 * np.abs(ej)[:4].max()


@pytest.mark.parametrize("test,overrides", [
    ("largest", ["ev.N=16", "ev.m=4", "ev.tol=1e-7", "ev.maxiter=2000"]),
    ("smallest", ["ev.N=12", "ev.m=4", "ev.tol=1e-7", "ev.maxiter=800"]),
])
def test_refine_protocol_cpu(test, overrides, capsys):
    """``ev.refine=on`` with the INI's f32 in both packages at the same N:
    the reference's ``REFINED_N_M_ERROR`` line, ``err_refined`` in the
    result, and both refined errors within the reference's target of 1e-6
    of the 1e-14 oracle and no worse than the unrefined ones. The port
    refines in f64 (measured ~1e-13 here), the JAX package on the CPU in
    compensated f32 (~1e-7 and ~1e-8): the port's error is held to 1e-9."""
    import dune_eigensolver_tpu.cli as jcli

    t, j = _trees(["ev.refine=on", *overrides])
    protocol = {"largest": "largest_eigenvalues_convergence_test",
                "smallest": "smallest_eigenvalues_convergence_test"}[test]
    rt = getattr(cli, protocol)(t)
    (line,) = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("REFINED")]
    assert re.fullmatch(rf"REFINED_N_M_ERROR: {t['ev.N']} 4 {SCI}", line), line
    rj = getattr(jcli, protocol)(j)
    capsys.readouterr()
    raw = "err_vs_oracle" if test == "largest" else "err_vs_truth"
    for r in (rt, rj):
        assert r["err_refined"] is not None and r["err_refined"] <= 1e-6
        assert r["err_refined"] <= r[raw] + 1e-12
    assert float(line.split()[-1]) == pytest.approx(rt["err_refined"], rel=1e-3, abs=1e-15)
    assert rt["err_refined"] <= 1e-9


def test_adaptive_protocol_cpu(capsys):
    """``ev.method=adaptive`` in both packages on the 2D GenEO pencil at
    N = 16 (f64, tol 1e-7): the threshold 0.83 lies between lambda_12 =
    0.809 and lambda_13 = 0.851, so nev grows 8 -> 11 -> 15 and 12
    eigenvalues lie below, in both; ``n_below`` ends the RESULT line. The
    two packages start from their own random blocks; their eigenvalues
    below the threshold agree to 1e-5 of the largest."""
    import dune_eigensolver_tpu.cli as jcli

    t, j = _trees(["ev.method=adaptive", "ev.N=16", "ev.threshold=0.83", "ev.verbose=1",
                   "ev.dtype=float64", "ev.tol=1e-7"])
    rt = cli.eigenvalues_test(t)
    out = capsys.readouterr().out
    (line,) = [ln for ln in out.splitlines() if ln.startswith("RESULT")]
    assert re.fullmatch(rf"RESULT eigenvalues_test adaptive N=16 m=15 iters=\d+ time={FLOAT}s "
                        rf"n_below=12", line), line
    assert re.findall(r"adaptive: nev=(\d+)", out) == ["8", "11", "15"]
    assert "  adaptive: m_final=15 n_below=12" in out
    rj = jcli.eigenvalues_test(j)
    capsys.readouterr()
    assert rt["n_below"] == rj["n_below"] == 12
    et, ej = np.asarray(rt["eigenvalues"]), np.asarray(rj["eigenvalues"], np.float64)
    assert et.shape == ej.shape == (15,)
    assert np.abs(et - ej)[:12].max() <= 1e-5 * np.abs(ej).max()


def test_ortho_block_full_protocol_cpu(capsys):
    """``ev.ortho_block=full`` (whole-basis CholeskyQR) in both packages:
    the RESULT line and the smallest four eigenvalues within 1e-2 of each
    other, as ``test_eigenvalues_protocol_cpu`` holds its solves."""
    import dune_eigensolver_tpu.cli as jcli

    t, j = _trees(["ev.method=lobpcg", "ev.ortho_block=full", "ev.N=12", "ev.inverse=cg"])
    rt = cli.eigenvalues_test(t)
    (line,) = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("RESULT")]
    assert re.fullmatch(rf"RESULT eigenvalues_test lobpcg N=12 m=8 iters=\d+ time={FLOAT}s",
                        line), line
    rj = jcli.eigenvalues_test(j)
    capsys.readouterr()
    et, ej = np.asarray(rt["eigenvalues"]), np.asarray(rj["eigenvalues"], np.float64)
    assert np.abs(et - ej)[:4].max() <= 1e-2 * np.abs(ej)[:4].max()


def test_paranoid_and_profile_dir_cli(tmp_path, capsys):
    """``ev.paranoid=1``: a clean solve alarms nothing, and paranoid mode is
    as it was after ``main`` returns; ``ev.profile_dir``: a Chrome trace of
    the test lands there."""
    from dune_eigensolver_tpu_torch.utils import paranoid

    logdir = tmp_path / "prof"
    assert cli.main(["--test", "eigenvalues", "ev.method=lobpcg", "ev.dim=3", "ev.N=8",
                     "ev.inverse=mg", "ev.b_identity=1", "ev.paranoid=1",
                     f"ev.profile_dir={logdir}", "ev.device=cpu"]) == 0
    out = capsys.readouterr().out
    assert "RESULT eigenvalues_test lobpcg N=8 " in out and "PARANOID" not in out
    assert not paranoid.paranoid_enabled() and paranoid._FLAGS == {}
    (name,) = os.listdir(logdir)
    assert name.endswith(".json") and os.path.getsize(logdir / name) > 0


def test_eigenvalues_protocol_guards(capsys):
    with pytest.raises(ValueError, match="ev.b_identity=1 requires"):
        cli.main(["--test", "eigenvalues", "ev.method=lobpcg", "ev.b_identity=1", "ev.N=8",
                  "ev.device=cpu"])
    with pytest.raises(ValueError, match="unknown ev.inverse"):
        cli.main(["--test", "eigenvalues", "ev.inverse=qr", "ev.N=8", "ev.device=cpu"])
    # ev.ortho_block=full runs now (test_ortho_block_full_protocol_cpu)
    capsys.readouterr()
    assert cli.main(["--test", "eigenvalues", "ev.method=lobpcg", "ev.ortho_block=full",
                     "ev.N=12", "ev.inverse=cg", "ev.device=cpu"]) == 0
    assert "RESULT eigenvalues_test lobpcg N=12 m=8 " in capsys.readouterr().out


def test_inverse_factory_kinds():
    """All seven kinds of the reference; ``auto``/``banded``/``lu`` are the
    solver's default (None)."""
    from dune_eigensolver_tpu_torch.sparse import problems

    A = problems.laplacian_dirichlet_3d(8, dtype=torch.float32, device="cpu")
    pt = tconfig.ParameterTree()
    for kind in ("auto", "banded", "lu"):
        pt["ev.inverse"] = kind
        assert cli._inverse_factory(pt) is None
    X = torch.ones((2, 512))
    for kind in ("cg", "cg16", "chebcg", "mg", "mgcg", "cheb"):
        pt["ev.inverse"] = kind
        aux, fn = cli._inverse_factory(pt)(A)
        Y = fn(aux, X)
        assert Y.shape == X.shape and Y.dtype == torch.float32 and torch.isfinite(Y).all()
    assert cli._want_refine(pt) is False
    pt["ev.dtype"] = "float64"
    assert cli._want_refine(pt) is False  # native f64 on the card: auto never refines


def test_problem_pair_kinds():
    pt = tconfig.ParameterTree().read_cli(["ev.N=6", "ev.device=cpu", "ev.overlap=1"])
    A, B = cli._problem_pair(pt)
    assert A.shape == B.shape == (36, 36) and float(A.data.sum()) == pytest.approx(0.0)
    pt["ev.dim"] = 3
    A, B = cli._problem_pair(pt)
    assert A.shape == (216, 216) and B.offsets == A.offsets and float(B.data.sum()) == 216.0
    pt["ev.problem"] = "elasticity"
    A, B = cli._problem_pair(pt)
    assert A.block == (2, 2) and A.shape == (50, 50)


def test_dtype_and_float64(capsys):
    pt = tconfig.ParameterTree()
    assert cli._dtype(pt) is torch.float32
    pt["ev.dtype"] = "float64"
    assert cli._dtype(pt) is torch.float64
    pt["ev.dtype"] = "int32"
    with pytest.raises(ValueError):
        cli._dtype(pt)
    assert cli.main(["--test", "mgs", "mgs.n=8", "mgs.m=8", "ev.dtype=float64",
                     "ev.device=cpu"]) == 0
    assert "P_n_m_i_perfn_perfb: 1 256 8 15" in capsys.readouterr().out


def test_printers_show_tensor_and_container(capsys):
    from dune_eigensolver_tpu.utils import printers as jprinters
    from dune_eigensolver_tpu_torch.sparse import problems
    from dune_eigensolver_tpu_torch.utils import printers

    a = np.arange(12.0).reshape(3, 4)
    printers.show(torch.from_numpy(a), "X")
    got = capsys.readouterr().out
    jprinters.show(a, "X")
    assert got == capsys.readouterr().out
    printers.show(problems.laplacian_dirichlet_2d(2, device="cpu"))
    assert "DIAMatrix: shape=(4, 4)" in capsys.readouterr().out
    printers.show_spectrum([1.0, 2.0], np.array([1.0, 2.5]))
    got = capsys.readouterr().out
    jprinters.show_spectrum([1.0, 2.0], np.array([1.0, 2.5]))
    assert got == capsys.readouterr().out and "max error: 5.000e-01" in got
