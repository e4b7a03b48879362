"""The parts are found by name, a new config, workload and metric are added
as files alone, and BENCHMARK.json keeps to its schema."""

import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest

from solvebench import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = registry.benchmark()


def _hashes(root: Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_new_parts_are_found_by_name_without_an_edit(tmp_path):
    root = tmp_path / "solvebench"
    shutil.copytree(registry.ROOT, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(registry.ROOT.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _hashes(root)
    cfg = dict(registry.config("elast2d-512", root), name="elast2d-96", N=96, n=2 * 95 * 95)
    (root / "configs" / "elast2d-96.json").write_text(json.dumps(cfg))
    wl = dict(registry.workload("elast2d-512.lobpcg-nev8", root), config="elast2d-96")
    (root / "workloads" / "elast2d-96.lobpcg-nev8.json").write_text(json.dumps(wl))
    (root / "metrics" / "solver.twice.py").write_text(
        'UNIT = "it/solve"\n\n\ndef read(run):\n    return 2.0 * sum(run.iterations)\n')
    (root / "operands" / "graph_ell.py").write_text('def make(cfg, device):\n    return {}\n')
    after = _hashes(root)
    assert {k: v for k, v in after.items() if k in before} == before  # nothing edited
    assert registry.config("elast2d-96", root)["N"] == 96
    assert registry.workload("elast2d-96.lobpcg-nev8", root)["config"] == "elast2d-96"
    assert registry.metric("solver.twice", root).read(type("R", (), {"iterations": [1, 2]})) == 6.0
    assert callable(registry.operands("graph_ell", root).make)
    bench = dict(BENCH, per_layer=BENCH["per_layer"] + [
        {"name": "solver.twice", "unit": "it/solve", "better": "lower", "source": "program_counter",
         "layer": "solvers/lobpcg.py, solvers/nested.py", "moves": "solve_device_s",
         "workloads": ["elast2d-96.lobpcg-nev8"]}])
    assert [m["name"] for m in registry.cell_metrics(bench, "elast2d-96.lobpcg-nev8", True)] == [
        "solver.twice"]
    with pytest.raises(FileNotFoundError):
        registry.workload("no-such.cell", root)
    with pytest.raises(ValueError):
        registry.config("../configs/lap3d-216", root)


def test_every_part_of_the_benchmark_has_its_file():
    for c in BENCH["configs"]:
        cfg = registry.config(c["name"])
        assert Path(registry.ROOT.parent / c["file"]).is_file()
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"] == []
        assert callable(registry.operands(cfg["family"]).make)
        assert callable(registry.reference(cfg["family"]).check)
    for w in BENCH["workloads"]:
        wl = registry.workload(w["name"])
        assert (wl["config"], wl["traffic"], wl["chips"], wl["why"]) == (
            w["config"], w["traffic"], w["chips"], w["why"])
        assert callable(registry.entry(wl["entry"]).build)
        assert callable(registry.precond(wl["precond"]["kind"]).factory)
        assert "resid" in wl["limits"] and set(wl["limits"]) <= {"eig_err", "resid"}
        assert wl["control"]["precision"] == "tf32" and wl["seeding"]["pool"] >= 8
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert registry.metric(m["name"]).UNIT == m["unit"]


def test_benchmark_json_keeps_to_its_schema():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["solvebench"] and BENCH["command"][:3] == ["python3", "-m", "solvebench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    # a full check of 24 cells fits its 43,200 s
    assert 2 + 14 * 24 <= (43200 - 1200 - 24 * 180) / (BENCH["run_seconds"] + 60)
    cells = {w["name"] for w in BENCH["workloads"]}
    configs = {c["name"] for c in BENCH["configs"]}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert NAME.match(w["traffic"])
    assert {w["config"] for w in BENCH["workloads"]} == configs
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"]) and 1 <= len(m["layer"]) <= 200
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m["workloads"]) <= cells
    for cell in cells:
        reported = [m["name"] for m in registry.cell_metrics(BENCH, cell, False)]
        assert "setup_s" in reported and len(reported) >= 2
        assert registry.cell_metrics(BENCH, cell, True)
    assert len(json.dumps(BENCH)) <= 64 * 1024
