"""Find the benchmark's parts by name, each in a file of its own.

* ``configs/<config>.json``: an operand family, its sizes, dtype and
  precision, ``source``, ``reduced`` and ``assumed``;
* ``workloads/<cell>.json``: the config, entry point, solver options,
  preconditioner, start-block seeding, the comparison's sample and limits,
  and the cell's ``why``;
* ``operands/<family>.py``: the frozen generator of an operand family;
* ``reference/<family>.py``: its plain reference (imports nothing of the
  program);
* ``entries/<entry>.py``: how one entry point of the program is called;
* ``preconds/<kind>.py``: how one preconditioner of the program is built;
* ``metrics/<metric>.py``: one metric's reader and its arithmetic.

``BENCHMARK.json`` (beside the folder) says which metrics each cell reports.
Every loader takes ``root`` so that the tests can point it at a temporary
folder.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _checked(name: str) -> str:
    if not _NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def _json(root: Path, folder: str, name: str) -> dict:
    path = Path(root) / folder / f"{_checked(name)}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder[:-1]} named {name!r} ({path})")
    with open(path) as fh:
        return json.load(fh)


def _module(root: Path, folder: str, name: str):
    path = Path(root) / folder / f"{_checked(name)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder} module named {name!r} ({path})")
    key = f"solvebench._{folder}.{name.replace('.', '_').replace('-', '_')}.{abs(hash(str(path)))}"
    mod = sys.modules.get(key)
    if mod is None:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return mod


def config(name: str, root: Path = ROOT) -> dict:
    return _json(root, "configs", name)


def workload(name: str, root: Path = ROOT) -> dict:
    return _json(root, "workloads", name)


def operands(family: str, root: Path = ROOT):
    return _module(root, "operands", family)


def reference(family: str, root: Path = ROOT):
    return _module(root, "reference", family)


def entry(name: str, root: Path = ROOT):
    return _module(root, "entries", name)


def precond(kind: str, root: Path = ROOT):
    return _module(root, "preconds", kind)


def metric(name: str, root: Path = ROOT):
    return _module(root, "metrics", name)


def benchmark(root: Path = ROOT) -> dict:
    """``BENCHMARK.json`` beside the benchmark's folder."""
    with open(Path(root).parent / "BENCHMARK.json") as fh:
        return json.load(fh)


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries the cell reports: its per-layer metrics with
    ``trace``, else its end-to-end ones. A metric without ``workloads`` is
    every cell's."""
    entries = bench["per_layer" if trace else "end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]
