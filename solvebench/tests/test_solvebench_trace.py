"""The reduction of a Chrome trace to device operations, their host stacks,
the busy seconds and the idle gaps, on a fixed trace."""

import pytest

from solvebench import registry
from solvebench.run import Run
from solvebench.trace import Profile, parse

EVENTS = [
    {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 10, "tid": 1},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 2, "dur": 1, "tid": 1,
     "args": {"correlation": 7}},
    {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 5, "dur": 20, "args": {"correlation": 7}},
    {"ph": "X", "cat": "user_annotation", "name": "solvebench.precond.mg", "ts": 30, "dur": 40,
     "tid": 1},
    {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 31, "dur": 5, "tid": 1},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 32, "dur": 1, "tid": 1,
     "args": {"correlation": 8}},
    {"ph": "X", "cat": "kernel", "name": "mul", "ts": 40, "dur": 10, "args": {"correlation": 8}},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 45, "dur": 10,
     "args": {"correlation": 99}},
    {"ph": "X", "cat": "gpu_user_annotation", "name": "solvebench.precond.mg", "ts": 40,
     "dur": 15},
]


def test_parse_links_and_stacks():
    ops = parse(EVENTS)
    assert [op.name for op in ops] == ["gemm", "mul", "Memcpy DtoH"]
    assert ops[0].stack == ("aten::mm",)
    assert ops[1].stack == ("solvebench.precond.mg", "aten::mul")
    assert ops[2].stack is None  # no launch in the trace


def test_busy_gaps_and_shares():
    p = Profile(wall_s=1e-4, ops=parse(EVENTS))
    assert p.busy_s() == pytest.approx(35e-6)  # [5, 25] and [40, 55]
    assert p.device_s() == pytest.approx(40e-6)
    assert p.under("solvebench.precond.mg") == pytest.approx(10e-6)
    assert p.idle_gaps() == [["solvebench.precond.mg / aten::mul", pytest.approx(15e-6)]]
    assert p.by_name()[0] == ["gemm", pytest.approx(20e-6)]
    run = Run("cell", {}, {}, 1.0, 1e-3, [1e-4] * 10, [3] * 10, 0)
    run.host_profile = run.device_profile = p
    assert registry.metric("mg.device_pct").read(run) == pytest.approx(25.0)
    assert registry.metric("cg.device_pct").read(run) is None
    assert registry.metric("device.idle_pct").read(run) == pytest.approx(65.0)
    assert registry.metric("device.ops").read(run) == 3.0
    assert registry.metric("solve_device_s").read(run) == pytest.approx(35e-6)
    run.device_profile = Profile(wall_s=1e-4, ops=[])  # no device operation: nothing to read
    assert registry.metric("solve_device_s").read(run) is None
