"""The port's config tree, roofline models, timing helper, device default and
CLI against the JAX package's, on the CPU.

Both ``ParameterTree``s read the same INI text and overrides; every function
of ``bench/models.py`` is held to its JAX counterpart exactly; the CLI's
``matvec`` and ``mgs`` protocols run at a small size with ``ev.device=cpu``
and must print the reference's line formats.
"""

import inspect
import os
import re

import numpy as np
import pytest
import torch

import dune_eigensolver_tpu.bench.models as jmodels
import dune_eigensolver_tpu.config as jconfig
import dune_eigensolver_tpu_torch.bench.models as tmodels
import dune_eigensolver_tpu_torch.config as tconfig
from dune_eigensolver_tpu_torch import cli
from dune_eigensolver_tpu_torch.bench.timing import bench_loop
from dune_eigensolver_tpu_torch.utils.device import resolve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INI = os.path.join(REPO, "dune-eigensolver.ini")
FLOAT = r"\d+\.\d+"


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


@pytest.mark.parametrize("name", ["largest", "smallest", "eigenvalues", "scaling", "nonsense"])
def test_unported_protocol_returns_2(name, capsys):
    assert cli.main(["--test", name, "ev.device=cpu"]) == 2
    out = capsys.readouterr().out
    assert ("not ported yet" in out) == (name != "nonsense")
    assert "matvec" in out and "mgs" in out


def test_default_test_is_the_reference_one_and_unported(capsys):
    """Without --test the reference runs ``largest``; the port says that it
    is not ported and returns 2."""
    assert cli.main(["ev.device=cpu"]) == 2
    assert "'largest' not ported yet" in capsys.readouterr().out


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
