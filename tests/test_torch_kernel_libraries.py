"""The port's two CUDA kernel libraries (``utils/native.py``), on the CPU:
nothing here is built or loaded.

The solver's sources (``csrc/*.cu``) and the kernel studies' sources
(``csrc/experiments/*.cu``) split ``csrc/``; an edit to a study never
renames the solver's library; and every kernel wrapper module declares the
entry points it launches (``native.Launchers``), each defined ``extern "C"``
in a source of the library it loads, with as many parameters as it is
declared with, while ``utils/native.py`` declares none of them.
"""

import ctypes
import importlib
import os
import re
import shutil

import pytest

from dune_eigensolver_tpu_torch.utils import native

SOLVER_SOURCES = ["bsr_spmm.cu", "cg_step.cu", "dia_spmm.cu", "ell_spmm.cu", "mg_tail.cu"]
WRAPPER_MODULES = [
    "dune_eigensolver_tpu_torch.kernels.dia_spmm",
    "dune_eigensolver_tpu_torch.kernels.gather_spmm",
    "dune_eigensolver_tpu_torch.kernels.cg_step",
    "dune_eigensolver_tpu_torch.kernels.mg_tail",
    "dune_eigensolver_tpu_torch.experiments.pipeline_probe",
    "dune_eigensolver_tpu_torch.experiments.kernel_variants",
    "dune_eigensolver_tpu_torch.experiments.gather_ablate",
    "dune_eigensolver_tpu_torch.experiments.gather_probe",
]


def _rel(paths, root=native.CSRC):
    return [os.path.relpath(p, root) for p in paths]


def _extern_c_definitions(paths) -> dict:
    """``{name: parameter count}`` of the functions the sources define
    inside their ``extern "C"`` blocks."""
    found = {}
    for path in paths:
        with open(path) as fh:
            text = fh.read()
        for block in re.findall(r'extern "C" \{(.*?)\}\s*// extern "C"', text, re.S):
            for name, params in re.findall(r"^(?:int|const char\*) (\w+)\(([^;{]*)\)\s*\{",
                                           block, re.M):
                found[name] = len([p for p in params.split(",") if p.strip()])
    return found


def test_libraries_split_the_sources():
    """Every ``.cu`` under ``csrc/`` belongs to exactly one library; the
    solver's holds the five sources a solve runs, and its hash reads only
    its own header, so no study header can rename it."""
    solver = _rel(native._sources(native.SOLVER))
    studies = _rel(native._sources(native.STUDIES))
    every = sorted(os.path.relpath(os.path.join(d, f), native.CSRC)
                   for d, _, files in os.walk(native.CSRC) for f in files if f.endswith(".cu"))
    assert solver == SOLVER_SOURCES
    assert not set(solver) & set(studies) and sorted(solver + studies) == every
    assert all(s.startswith("experiments" + os.sep) for s in studies) and len(studies) == 9
    assert _rel(native._headers(native.SOLVER)) == ["ell_body.cuh"]
    assert sorted(_rel(native._headers(native.STUDIES))) == [
        "ell_body.cuh", *(os.path.join("experiments", h) for h in
                          ("bulk_copy.cuh", "dia_body.cuh", "ell_sweep.cuh"))]
    assert native._lib_name(native.SOLVER) == "kernels"
    assert native._lib_name(native.STUDIES) == "experiments"


@pytest.mark.parametrize("edited,solver_renamed,studies_renamed", [
    ("experiments/copy_probe.cu", False, True),
    ("experiments/bulk_copy.cuh", False, True),
    ("experiments/ell_sweep.cuh", False, True),
    ("ell_body.cuh", True, True),
    ("dia_spmm.cu", True, False),
])
def test_a_study_edit_never_renames_the_solver_library(tmp_path, edited, solver_renamed,
                                                        studies_renamed):
    """In a copy of ``csrc/``: an edit to a study source or header renames
    the studies' library alone; K2's body, ``ell_body.cuh``, which the
    ablation instantiates, renames both; a solver source the solver's
    alone."""
    csrc = tmp_path / "csrc"
    shutil.copytree(native.CSRC, csrc, ignore=shutil.ignore_patterns("host"))

    def names():
        return [native._lib_path(native._sources(str(d)), native._headers(str(d), root=str(csrc)),
                                 native._lib_name(str(d)))
                for d in (csrc, csrc / "experiments")]

    before = names()
    assert [os.path.basename(p).split("_")[1] for p in before] == ["kernels", "experiments"]
    with open(csrc / edited, "a") as fh:
        fh.write("\n// edited\n")
    after = names()
    assert (after[0] != before[0], after[1] != before[1]) == (solver_renamed, studies_renamed)


@pytest.mark.parametrize("module", WRAPPER_MODULES)
def test_wrappers_declare_what_their_library_defines(module):
    """Each wrapper module declares its entry points beside its calls, in
    one ``Launchers`` of the library its sources lie in: every name is
    defined ``extern "C"`` there, with as many parameters as declared."""
    mod = importlib.import_module(module)
    launchers = [v for v in vars(mod).values() if isinstance(v, native.Launchers)]
    assert len(launchers) == 1
    (lib,) = launchers
    assert lib.csrc == (native.STUDIES if ".experiments." in module else native.SOLVER)
    defined = _extern_c_definitions(native._sources(lib.csrc))
    assert lib.signatures
    for name, argtypes in lib.signatures.items():
        assert name in defined, name
        assert defined[name] == len(argtypes), name


def test_native_declares_no_entry_point():
    """``utils/native.py`` names no launcher: a new kernel touches its
    source, its wrapper and its tests. The error string, which every
    library defines for ``check``, is the one entry point it declares."""
    sources = native._sources(native.SOLVER) + native._sources(native.STUDIES)
    defined = _extern_c_definitions(sources)
    with open(native.__file__) as fh:
        text = fh.read()
    assert {n for n in defined if re.search(rf"\b{n}\b", text)} == {"dune_cuda_error_string"}
    assert not re.search(r"\w+_launch\b", text)
    per_library = [_extern_c_definitions(native._sources(d)) for d in (native.SOLVER,
                                                                      native.STUDIES)]
    assert all("dune_cuda_error_string" in d for d in per_library)


def test_launchers_bind_once_at_the_first_call(monkeypatch):
    """Nothing is loaded when a wrapper module is imported; the first call
    loads the library of its directory and declares the entry points, and
    later calls return the same library without loading again."""
    class Lib:
        pass

    lib, loads = Lib(), []
    lib.probe_launch = type("Fn", (), {})()
    monkeypatch.setattr(native, "load", lambda csrc: loads.append(csrc) or lib)
    launchers = native.Launchers({"probe_launch": [ctypes.c_void_p, ctypes.c_int]},
                                 native.STUDIES)
    assert loads == []
    assert launchers() is lib and launchers() is lib
    assert loads == [native.STUDIES]
    assert lib.probe_launch.restype is ctypes.c_int
    assert lib.probe_launch.argtypes == [ctypes.c_void_p, ctypes.c_int]


def test_check_reads_the_error_string_of_a_loaded_library(monkeypatch):
    """``check`` raises with the CUDA error's text from whichever library a
    launch loaded (each defines the string), and passes 0."""
    class Lib:
        @staticmethod
        def dune_cuda_error_string(err):
            return f"error {err}".encode()

    monkeypatch.setattr(native, "_LIBS", {native.STUDIES: Lib()})
    native.check(0, "copy_add1_launch")
    with pytest.raises(RuntimeError, match=r"copy_add1_launch: CUDA error 1: error 1"):
        native.check(1, "copy_add1_launch")
