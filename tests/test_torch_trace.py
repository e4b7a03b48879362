"""The program's trace spans and counters (``utils/vlog.py``), on a small
``elasticity_2d`` pencil through ``lobpcg_generalized`` with Jacobi-CG:
nothing with the spans off, one ``solve`` holding every phase with them on,
one ``cg.stop`` read a CG step, the same bits either way, and the spans on
``torch.profiler``'s clock."""

import collections
import json
import os

import pytest
import torch

from dune_eigensolver_tpu_torch import cli
from dune_eigensolver_tpu_torch.factorize import cg as cgmod
from dune_eigensolver_tpu_torch.factorize import cg_inverse_factory
from dune_eigensolver_tpu_torch.kernels import dia_spmm as kd
from dune_eigensolver_tpu_torch.kernels import gather_spmm as kg
from dune_eigensolver_tpu_torch.solvers import lobpcg_generalized
from dune_eigensolver_tpu_torch.sparse import problems
from dune_eigensolver_tpu_torch.utils import vlog

torch.set_num_threads(2)  # as the other port test files: the suite runs 6 workers

PHASES = {"lobpcg.setup", "lobpcg.spmm", "lobpcg.precond", "lobpcg.ortho", "lobpcg.rr",
          "lobpcg.stop", "cg.apply", "cg.stop"}
#: each span's parent
PARENTS = {"lobpcg.setup": "solve", "lobpcg.spmm": "solve", "lobpcg.precond": "solve",
           "lobpcg.ortho": "solve", "lobpcg.rr": "solve", "lobpcg.stop": "solve",
           "cg.apply": "lobpcg.precond", "cg.stop": "cg.apply"}


def _solve(maxiter=25, seed=5):
    """A solve that sets up afresh (new operands: a memo miss)."""
    A, B = problems.elasticity_2d(12, dtype=torch.float32, device="cpu")
    pre = cg_inverse_factory(rtol=1e-2, maxiter=maxiter)
    return lobpcg_generalized(A, B, nev=8, tol=2e-3, maxiter=300, shift=1e-3, precond=pre,
                              seed=seed)


def _recording_cg(monkeypatch):
    """The ``k`` of every ``cg_solve_t`` call, in order (its loop's)."""
    ks, inner = [], cgmod._cg_loop

    def recording(*args, **kwargs):
        X, k = inner(*args, **kwargs)
        ks.append(k)
        return X, k

    monkeypatch.setattr(cgmod, "_cg_loop", recording)
    return ks


def _root(spans, i):
    """The index of the span at the root of span ``i``'s parent chain."""
    while spans[i].parent is not None:
        i = spans[i].parent
    return i


def test_spans_off_record_nothing(monkeypatch):
    import torch.profiler

    def refused(*_a, **_k):
        raise AssertionError("a span was opened with the spans off")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    monkeypatch.setattr(vlog, "_On", refused)
    res = _solve()
    assert int(res.iterations) > 3
    assert vlog._records is None and vlog._open == []
    assert vlog.span("lobpcg.ortho") is vlog._OFF


def test_spans_nest_inside_one_solve(monkeypatch):
    """... and open no ``record_function`` range while no profiler runs."""
    import torch.profiler

    def refused(*_a, **_k):
        raise AssertionError("a range was opened with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    with vlog.tracing() as spans:
        _solve()
    assert vlog._records is None and vlog._open == []
    (top,) = [s for s in spans if s.parent is None]
    assert (spans[0], top.name, top.attrs) == (top, "solve", {"entry": "lobpcg_generalized"})
    assert {s.name for s in spans} == PHASES | {"solve"}
    for i, s in enumerate(spans[1:], 1):
        parent = spans[s.parent]
        assert parent.name == PARENTS[s.name], s
        assert _root(spans, i) == 0  # the solve it ran in
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    with vlog.tracing() as again:
        _solve()
        _solve()
    roots = [i for i, s in enumerate(again) if s.parent is None]
    assert [again[i].name for i in roots] == ["solve", "solve"]
    assert {_root(again, i) for i in range(len(again))} == set(roots)


@pytest.mark.parametrize("maxiter", [25, 3])
def test_one_stop_read_a_cg_step(monkeypatch, maxiter):
    """``cg.stop`` spans per ``cg.apply``: k + 1 under the cap (the last read
    stops the loop), k at it (the cap stops the loop before a read); and
    the counters add up the returned ``k``."""
    cg = cgmod.cg_solve_t
    calls, steps = cg.calls, cg.steps
    ks = _recording_cg(monkeypatch)
    with vlog.tracing() as spans:
        _solve(maxiter=maxiter)
    reads = collections.Counter(spans[s.parent].start_ns for s in spans if s.name == "cg.stop")
    applies = [s for s in spans if s.name == "cg.apply"]
    assert len(applies) == len(ks) > 0
    assert [reads[s.start_ns] for s in applies] == [k + 1 if k < maxiter else k for k in ks]
    assert (maxiter in ks) == (maxiter == 3)
    assert (cg.calls - calls, cg.steps - steps) == (len(ks), sum(ks))


def test_every_operand_product_runs_inside_a_phase(monkeypatch):
    """Each ``spmm_t`` of the solve (the kernel launch on the card) runs with
    ``cg.apply``, ``lobpcg.spmm``, ``lobpcg.ortho`` or ``lobpcg.rr`` the
    innermost open span: the CPU side of the card test that holds every K3
    launch to these spans."""
    from dune_eigensolver_tpu_torch.solvers import lobpcg as lmod

    where = []

    def recording(inner):
        def spmm_t(A, X):
            where.append(vlog._records[vlog._open[-1]].name if vlog._open else None)
            return inner(A, X)

        return spmm_t

    for mod in (lmod, cgmod):
        monkeypatch.setattr(mod, "spmm_t", recording(mod.spmm_t))
    with vlog.tracing():
        _solve()
    assert set(where) == {"cg.apply", "lobpcg.spmm", "lobpcg.ortho", "lobpcg.rr"}


def test_spans_leave_the_bits():
    off = _solve()
    with vlog.tracing():
        on = _solve()
    assert torch.equal(off.eigenvalues, on.eigenvalues)
    assert torch.equal(off.eigenvectors, on.eigenvectors)
    assert int(off.iterations) == int(on.iterations)


def test_setup_span_marks_a_memo_miss():
    """``lobpcg.setup`` opens on the first solve of an operand pair (the
    set-up memo's miss) and not on the second (its hit)."""
    A, B = problems.elasticity_2d(8, dtype=torch.float32, device="cpu")
    pre = cg_inverse_factory(rtol=1e-2, maxiter=25)
    with vlog.tracing() as spans:
        for _ in range(2):
            lobpcg_generalized(A, B, nev=4, tol=1e-2, maxiter=50, shift=1e-3, precond=pre)
    solves = [i for i, s in enumerate(spans) if s.name == "solve"]
    assert len(solves) == 2
    setups = [i for i, s in enumerate(spans) if s.name == "lobpcg.setup"]
    assert [_root(spans, i) for i in setups] == solves[:1]


def test_tracing_nests_into_one_list():
    with vlog.tracing() as outer:
        with vlog.tracing() as inner:
            with vlog.span("a", x=1):
                pass
        with vlog.span("b"):
            pass
    assert inner is outer and [(s.name, s.attrs) for s in outer] == [("a", {"x": 1}), ("b", {})]
    assert vlog.span("c") is vlog._OFF


def test_spans_share_the_profiler_clock(tmp_path):
    """Each span holds its own ``record_function`` range of the Chrome
    trace (``baseTimeNanoseconds`` + ``ts`` * 1000) to 20 us at either end:
    its ``time.time_ns()`` stamps are taken outside the range's opening and
    closing, so a clock off by more than 20 us and the cheapest opening or
    closing of a range would put some range outside its span. (An opening
    costs 4-94 us under the CPU profiler, so a start is not held to the
    range's start itself.)"""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with vlog.tracing() as spans:
            _solve()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = int(trace["baseTimeNanoseconds"])
    ranges = collections.defaultdict(list)
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            start = base + round(float(e["ts"]) * 1000)
            ranges[e["name"]].append((start, start + round(float(e["dur"]) * 1000)))
    mine = collections.defaultdict(list)
    for s in spans:
        mine[s.name].append((s.start_ns, s.end_ns))
    assert set(mine) == set(ranges)
    for name, held in mine.items():
        theirs = sorted(ranges[name])
        assert len(theirs) == len(held), name
        for (start, end), (r0, r1) in zip(held, theirs):
            assert start - 20_000 <= r0 <= r1 <= end + 20_000, (name, r0 - start, end - r1)


def test_profile_dir_trace_names_the_phases(tmp_path, capsys):
    """The CLI's ``ev.profile_dir`` trace holds the program's spans as
    ranges."""
    logdir = tmp_path / "prof"
    assert cli.main(["--test", "eigenvalues", "ev.method=lobpcg", "ev.N=12", "ev.inverse=cg",
                     f"ev.profile_dir={logdir}", "ev.device=cpu"]) == 0
    capsys.readouterr()
    (name,) = os.listdir(logdir)
    events = json.loads((logdir / name).read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"solve", "lobpcg.ortho", "cg.apply"} <= names
    assert vlog._records is None


def test_kernel_wrappers_tally_calls_by_shape():
    """The CUDA wrappers' by-shape tallies (their launches run on the card:
    ``tests/test_torch_cuda.py``)."""
    for fn, key in ((kd.dia_spmm_t_cuda, kd.DiaCall), (kg.ell_spmm_t_cuda, kg.EllCall),
                    (kg.bsr_spmm_t_cuda, kg.BsrCall)):
        assert isinstance(fn.calls, collections.Counter)
        assert "dtype" in key._fields and "m" in key._fields
        assert not hasattr(fn, "by_dtype")
    assert kd.DiaCall._fields == ("n", "m", "dtype", "ndiag", "width")
    assert kg.EllCall._fields == ("n", "n_cols", "k", "m", "dtype", "index_bytes")
    assert kg.BsrCall._fields == ("n", "nbr", "k", "block", "m", "dtype")
    assert not hasattr(kd.dia_spmm_t_cuda, "taken")
