"""A copy of the benchmark's data in a temporary folder, with its cell cut
to a size the CPU solves in seconds, for the harness's own tests. Only the
sizes, the nesting depth and the limits differ from the committed files; the
code that runs is the committed harness's.

Beside it, the north star's recipe on the Laplacian (``LAP``): not a cell of
the benchmark, since its lower-precision control reads as its sound runs do
at the recipe's tolerance, but the harness's Laplacian path (operand,
reference, nested entry, multigrid) is kept and tested with it here."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from solvebench import registry

LAP = "lap3d-216.nested-nev24"
ELAST = "elast2d-512.lobpcg-nev8"

#: the north star: bench.py's recipe at 216^3, tolerance 2e-3
LAP_WORKLOAD = {
    "config": "lap3d-216", "traffic": "nested-nev24", "chips": 1, "entry": "lobpcg_nested",
    "options": {"nev": 24, "tol": 0.002, "maxiter": 300, "shift": 0.0, "min_coarse": 48,
                "coarse_tol": 0.0002, "ortho_iterations": 1, "ortho_block": 24,
                "b_identity": True},
    "precond": {"kind": "mg", "nu1": 1, "nu2": 1, "dtype": "bfloat16"},
    "seeding": {"pool": 16, "pool_seed": 1729},
    "report": 20, "check": {"vectors": 3, "within": 20}, "limits": {},
    "control": {"kind": "program", "precision": "tf32"},
    "why": "the north star, not a cell: its TF32 control is not separated at tol 2e-3",
}

#: per cell: the config's size, the workload's options, its check and limits
TINY = {
    LAP: ({"N": 16, "n": 4096}, {"min_coarse": 8},
          {"vectors": 2, "within": 2}, {"eig_err": 5e-3, "resid": 0.2}),
    ELAST: ({"N": 16, "n": 450}, {}, {"vectors": 2, "within": 2},
            {"eig_err": 1e-2, "resid": 0.3}),
}


def tiny_root(tmp: Path) -> Path:
    """A folder laid out as ``solvebench/`` beside a ``BENCHMARK.json``,
    with the tiny sizes; returns the ``solvebench`` folder in it."""
    root = Path(tmp) / "solvebench"
    for folder in ("configs", "workloads", "operands", "reference", "entries", "preconds",
                   "metrics"):
        shutil.copytree(registry.ROOT / folder, root / folder)
    shutil.copy(registry.ROOT.parent / "BENCHMARK.json", Path(tmp) / "BENCHMARK.json")
    (root / "workloads" / f"{LAP}.json").write_text(json.dumps(LAP_WORKLOAD))
    for cell, (cfg_over, opt_over, check, limits) in TINY.items():
        wpath = root / "workloads" / f"{cell}.json"
        wl = json.loads(wpath.read_text())
        wl["options"].update(opt_over)
        wl["check"], wl["limits"] = check, limits
        wpath.write_text(json.dumps(wl))
        cpath = root / "configs" / f"{wl['config']}.json"
        cfg = json.loads(cpath.read_text())
        cfg.update(cfg_over)
        cpath.write_text(json.dumps(cfg))
    return root
