"""The readings a cell's limits are set from: the checks of many seeds in
one process, set up once, with the program as the configuration states it
(``--seeds``) and then with the cell's lower-precision control
(``--control-seeds``).

    python3 -m solvebench.readings --workload <cell> --seconds <s> \\
        --seeds 11,12,... --control-seeds 21,22,23

The workload's ``control`` names it: ``{"kind": "program", "precision":
"tf32"}`` runs the program with TF32 on in its float32 matrix products, a
window as long as a run's; ``{"kind": "reference", "precision": "tf32"}``
puts the reference's eigenpairs, rounded to TF32, in the program's place.
Each window is judged as a run judges it; the program's state stays on the
card between windows. One JSON line per window, every reading in it; the
benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json

from solvebench import registry
from solvebench.run import Cell, Window, is_correct, set_precision


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def control_window(cell: Cell, seed: int, seconds: float) -> Window:
    control = cell.wl["control"]
    if control["kind"] == "program":
        set_precision(cell.torch, cell.cfg, control["precision"])
        try:
            return cell.window(seed, seconds)
        finally:
            set_precision(cell.torch, cell.cfg)
    ref = registry.reference(cell.cfg["family"], cell.root)
    answers = ref.control_answers(cell.reference_state(), control["precision"])
    return Window(0.0, len(answers), [], [], answers, 0, 0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m solvebench.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=_seeds, default=[])
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    args = ap.parse_args(argv)
    cell = Cell(args.workload, (args.seeds + args.control_seeds)[0])
    print(json.dumps({"workload": args.workload, "setup_s": cell.setup_s,
                      "control": cell.wl["control"]}), flush=True)
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for seed in seeds:
            w = control_window(cell, seed, args.seconds) if control else cell.window(seed, args.seconds)
            checks, readings = cell.judge(w)
            print(json.dumps({"seed": seed, "control": control, "correct": is_correct(w, checks),
                              "solves": w.attempted, "solve_s": w.seconds / max(len(w.times), 1),
                              "iterations": sum(w.iterations) / max(len(w.iterations), 1),
                              "peak_bytes": w.peak_bytes,
                              "readings": readings, "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
