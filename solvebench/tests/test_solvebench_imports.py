"""No module that a run imports is JAX or the JAX package, compared by
whole top-level name; the reference imports nothing of the program either."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from solvebench import registry
from solvebench.run import FORBIDDEN, forbidden_modules

ROOT = registry.ROOT
PORT = "dune_eigensolver_tpu_torch"


def _imports(path: Path) -> set:
    """Top-level names of every import statement in a file, inside
    functions too, with the solvebench files it imports followed."""
    seen, names, todo = set(), set(), [path]
    while todo:
        p = todo.pop()
        if p in seen:
            continue
        seen.add(p)
        for node in ast.walk(ast.parse(p.read_text())):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module] if isinstance(node, ast.ImportFrom) and node.module
                    else [])
            for mod in mods:
                top = mod.split(".")[0]
                names.add(top)
                if top == "solvebench":
                    sub = ROOT.joinpath(*mod.split(".")[1:])
                    for cand in (sub.with_suffix(".py"), sub / "__init__.py"):
                        if cand.is_file():
                            todo.append(cand)
    return names


HARNESS = sorted(p for p in ROOT.rglob("*.py") if "tests" not in p.parts)
REFERENCE = sorted((ROOT / "reference").glob("*.py"))


@pytest.mark.parametrize("path", HARNESS, ids=lambda p: str(p.relative_to(ROOT)))
def test_harness_imports_no_jax(path):
    assert not _imports(path) & set(FORBIDDEN)


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = _imports(path)
    assert not names & set(FORBIDDEN)
    assert PORT not in names
    assert names <= {"__future__", "hashlib", "json", "os", "pathlib", "numpy", "scipy", "torch"}


def test_whole_names_are_compared():
    assert forbidden_modules({"jax.numpy": 1, "numpy": 1}) == ["jax"]
    assert forbidden_modules({"dune_eigensolver_tpu.sparse": 1}) == ["dune_eigensolver_tpu"]
    assert forbidden_modules({PORT: 1, PORT + ".solvers": 1, "jaxtyping": 1, "flaxen": 1}) == []


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(sorted({k.split('.')[0] "
                          "for k in sys.modules}))"], capture_output=True, text=True, check=True,
                         cwd=ROOT.parent, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    loaded = _loaded(
        "from solvebench import registry, run, trace, rooflines, spans\n"
        "b = registry.benchmark()\n"
        "[registry.metric(m['name']) for m in b['end_to_end'] + b['per_layer']]\n"
        "for w in b['workloads']:\n"
        "    wl = registry.workload(w['name']); cfg = registry.config(wl['config'])\n"
        "    registry.entry(wl['entry']); registry.operands(cfg['family'])\n"
        "    registry.reference(cfg['family'])\n"
        "    registry.precond(wl['precond']['kind']).factory(wl['precond'])\n"
        "import dune_eigensolver_tpu_torch.solvers, dune_eigensolver_tpu_torch.factorize\n")
    assert PORT in loaded
    assert not loaded & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded("from solvebench import registry\n"
                     "[registry.reference(p.stem) for p in registry.ROOT.glob('reference/*.py')]\n")
    assert PORT not in loaded and not loaded & set(FORBIDDEN)
