"""The readers of the program's own spans and counters
(``program_trace.py``): the arithmetic on fixed events and spans, the
readers through the registry, nothing read from a program without the
spans, and the set-up again of the tiny cell on the CPU."""

from pathlib import Path
from types import SimpleNamespace

import pytest

from solvebench import program_trace as pt
from solvebench import registry
from solvebench.run import Run
from solvebench_tiny import ELAST, tiny_root

BASE = 1_000_000_000  # the trace's baseTimeNanoseconds


def _span(name, start_us, end_us, parent=None):
    """A span record as ``vlog.Span`` has it, its times given on the
    trace's clock (microseconds from ``BASE``)."""
    return SimpleNamespace(name=name, start_ns=BASE + int(start_us * 1000),
                           end_ns=BASE + int(end_us * 1000), parent=parent)


#: solve [0, 100] holding ortho [10, 30], precond [40, 90] holding
#: cg.apply [41, 89] holding cg.stop [60, 70], and lobpcg.stop [95, 99]
SPANS = [_span("solve", 0, 100), _span("lobpcg.ortho", 10, 30, 0),
         _span("lobpcg.precond", 40, 90, 0), _span("cg.apply", 41, 89, 2),
         _span("cg.stop", 60, 70, 3), _span("lobpcg.stop", 95, 99, 0)]

EVENTS = [
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 12, "dur": 1,
     "args": {"correlation": 1}},
    {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 15, "dur": 10, "args": {"correlation": 1}},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 45, "dur": 1,
     "args": {"correlation": 2}},
    {"ph": "X", "cat": "kernel", "name": "mul", "ts": 50, "dur": 20, "args": {"correlation": 2}},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 35, "dur": 1,
     "args": {"correlation": 3}},
    {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 80, "dur": 10,
     "args": {"correlation": 3}},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 95, "dur": 5,
     "args": {"correlation": 99}},
]


def test_device_ops_keep_their_launch():
    ops = pt.device_ops(EVENTS)
    assert [(op.start, op.dur, op.launch) for op in ops] == [
        (15.0, 10.0, 12.0), (50.0, 20.0, 45.0), (80.0, 10.0, 35.0), (95.0, 5.0, None)]


def test_wait_share_of_the_stop_reads():
    # cg.stop 10 us and lobpcg.stop 4 us of solve's 100 us
    assert pt.wait_pct(SPANS) == pytest.approx(14.0)
    assert pt.wait_pct(SPANS[1:]) is None  # no solve span


def test_idle_share_inside_cg_apply():
    ops = pt.device_ops(EVENTS)
    assert pt.idle_gaps(ops) == [(25.0, 50.0), (70.0, 80.0), (90.0, 95.0)]
    # 40 us idle; inside cg.apply [41, 89]: 9 of [25, 50] and all of [70, 80]
    assert pt.idle_pct_inside(ops, SPANS, BASE, "cg.apply") == pytest.approx(100.0 * 19 / 40)
    assert pt.idle_pct_inside(ops, SPANS, BASE, "lobpcg.rr") == 0.0
    assert pt.idle_pct_inside(ops[:1], SPANS, BASE, "cg.apply") is None  # no gap


def test_device_share_by_innermost_span_at_the_launch():
    ops = pt.device_ops(EVENTS)
    at = pt.innermost(SPANS, BASE)
    assert [at(t) for t in (5, 12, 35, 45, 65, 89.5, 99.5, 101)] == [0, 1, 0, 3, 4, 2, 0, None]
    # 45 us of device time: gemm (10) launched in ortho, mul (20) inside
    # cg.apply, the memset (10) in solve alone, the copy (5) unlinked
    assert pt.device_pct_under(ops, SPANS, BASE, "lobpcg.ortho") == pytest.approx(100 * 10 / 45)
    assert pt.device_pct_under(ops, SPANS, BASE, "lobpcg.precond") == pytest.approx(100 * 20 / 45)
    assert pt.device_pct_under(ops, SPANS, BASE, "solve") == pytest.approx(100 * 40 / 45)
    assert pt.device_pct_under(ops, SPANS, BASE, "lobpcg.rr") == 0.0
    unlinked = [pt.Op(op.start, op.dur, None) for op in ops]
    assert pt.device_pct_under(unlinked, SPANS, BASE, "lobpcg.ortho") is None


def _run():
    return Run(ELAST, {}, {}, 1.0, 1.0, [0.5, 0.5], [3, 3], 0)


def test_readers_through_the_registry(monkeypatch):
    from dune_eigensolver_tpu_torch.factorize.cg import cg_solve_t

    monkeypatch.setattr(cg_solve_t, "calls", 4)
    monkeypatch.setattr(cg_solve_t, "steps", 90)
    run = _run()
    run.__dict__[pt._KEY] = pt.Measured(SPANS, SPANS, BASE, pt.device_ops(EVENTS))
    read = {name: registry.metric(name).read(run)
            for name in ("cg.steps", "solver.wait_pct", "cg.idle_pct", "ortho.device_pct",
                         "rr.device_pct")}
    assert read == {"cg.steps": 22.5, "solver.wait_pct": pytest.approx(14.0),
                    "cg.idle_pct": pytest.approx(47.5),
                    "ortho.device_pct": pytest.approx(100 / 4.5), "rr.device_pct": 0.0}
    run.__dict__[pt._KEY] = pt.Measured(SPANS, SPANS, BASE, [])
    monkeypatch.setattr(cg_solve_t, "calls", 0)
    assert registry.metric("cg.steps").read(run) is None  # no apply counted
    assert registry.metric("cg.idle_pct").read(run) is None  # no device operation


def test_a_program_without_spans_reads_nothing(monkeypatch, tmp_path):
    monkeypatch.setattr(pt, "available", lambda: False)
    run = _run()
    for name in ("solver.wait_pct", "cg.idle_pct", "ortho.device_pct", "rr.device_pct"):
        assert registry.metric(name).read(run) is None
    assert pt.measure(run, tmp_path) is None  # nothing set up: the folder is empty
    run = Run(ELAST, {}, {}, 1.0, 1.0, [], [], 0)
    monkeypatch.undo()
    assert pt.measure(run, tmp_path) is None  # no solve in the window


def test_the_tiny_cell_set_up_again_on_the_cpu(tmp_path):
    """In a process of its own: this process's CG counters do not move."""
    root = tiny_root(tmp_path)
    run = _run()
    before = pt.cg_counts()
    got = pt.measure(run, Path(root))
    assert pt.cg_counts() == before
    assert pt.measure(run, Path(root)) is got  # once a run
    names = {s.name for s in got.spans}
    assert {"solve", "lobpcg.ortho", "cg.apply", "cg.stop"} <= names
    assert sum(s.name == "solve" for s in got.spans) == pt.SOLVES
    assert 0.0 < pt.wait_pct(got.spans) < 100.0
    assert [s.name for s in got.profiled].count("solve") == 1
    assert got.ops == []  # no card: the profile holds the host's activity alone
    assert [s.name for s in got.spans if s.parent is None] == ["solve"] * pt.SOLVES


def test_the_measuring_process_runs_on_the_runs_device(tmp_path, monkeypatch):
    """The card where the run read its peak from the card, the CPU where it
    read 0; asked for the card, the process refuses to start without one."""
    import torch

    assert pt.device_of(_run()) == "cpu"
    assert pt.device_of(Run(ELAST, {}, {}, 1.0, 1.0, [0.5], [3], 505_500_000)) == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="sees none"):
        pt.main(["--workload", ELAST, "--root", str(tiny_root(tmp_path)),
                 "--out", str(tmp_path / "spans.json"), "--device", "cuda"])
    assert not (tmp_path / "spans.json").exists()
