"""The trace spans and the level counter of the nested solve and the
multigrid V-cycle (``solvers/nested.py``, ``factorize/multigrid.py``), on
the north star's recipe at 24^3 (levels 6^3, 12^3, 24^3): a
``nested.coarse`` span a coarse level inside the ``solve``, holding that
level's iterations, the V-cycle's spans inside ``lobpcg.precond``, the
counter equal to the levels' own iterations, and with the spans off or on
the same aten operations and the same bits."""

import collections

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dune_eigensolver_tpu_torch.factorize import mg_inverse_factory
from dune_eigensolver_tpu_torch.solvers import nested as nmod
from dune_eigensolver_tpu_torch.sparse import problems
from dune_eigensolver_tpu_torch.sparse.formats import DIAMatrix
from dune_eigensolver_tpu_torch.utils import vlog

torch.set_num_threads(2)  # as the other port test files: the suite runs 6 workers

N = 24
#: the cell's recipe (solvebench/workloads/lap3d-216-ns.nested-nev24.json),
#: its nev and coarsening cut to the size
RECIPE = dict(nev=8, tol=2e-3, maxiter=300, shift=0.0, min_coarse=6, coarse_tol=2e-4,
              ortho_iterations=1, ortho_block=8, b_identity=True)


@pytest.fixture(scope="module")
def operands():
    A = problems.laplacian_dirichlet_3d(N, dtype=torch.float32, device="cpu")
    n = A.shape[0]
    B = DIAMatrix(data=torch.ones((1, n), dtype=A.dtype), offsets=(0,), shape=(n, n))
    pre = mg_inverse_factory(nu1=1, nu2=1, dtype=torch.bfloat16)
    nmod.lobpcg_nested(A, B, precond=pre, seed=3, **RECIPE)  # set-up memo filled
    return A, B, pre


def _solve(operands, seed=3):
    A, B, pre = operands
    return nmod.lobpcg_nested(A, B, precond=pre, seed=seed, **RECIPE)


def _chain(spans, i):
    """The indices on span ``i``'s parent chain, innermost first."""
    out = []
    while spans[i].parent is not None:
        i = spans[i].parent
        out.append(i)
    return out


def _ancestors(spans, i):
    """The names on span ``i``'s parent chain, innermost first."""
    return [spans[j].name for j in _chain(spans, i)]


def test_one_coarse_span_a_coarse_level_inside_the_solve(operands):
    with vlog.tracing() as spans:
        res = _solve(operands)
    assert [s.name for s in spans if s.parent is None] == ["solve"]
    assert spans[0].attrs == {"entry": "lobpcg_nested"}
    coarse = [(i, s) for i, s in enumerate(spans) if s.name == "nested.coarse"]
    assert [s.attrs for _, s in coarse] == [{"N": 6}, {"N": 12}]
    for i, s in coarse:
        assert spans[s.parent].name == "solve"
        assert spans[0].start_ns <= s.start_ns <= s.end_ns <= spans[0].end_ns
    (a, first), (b, second) = coarse
    assert first.end_ns <= second.start_ns
    # each coarse level's LOBPCG stops inside its span; the fine level's after
    stops = [i for i, s in enumerate(spans) if s.name == "lobpcg.stop"]
    inside = collections.Counter(spans[i].parent for i in stops)
    assert inside[a] > 0 and inside[b] > 0
    fine = [i for i in stops if "nested.coarse" not in _ancestors(spans, i)]
    assert len(fine) > 0 and all(spans[i].start_ns >= second.end_ns for i in fine)
    assert bool(res.converged)


def test_vcycle_spans_nest_inside_the_precond_span(operands):
    with vlog.tracing() as spans:
        _solve(operands)
    names = {"mg.apply", "mg.smooth", "mg.coarse"}
    assert names <= {s.name for s in spans}
    children = collections.defaultdict(list)
    for i, s in enumerate(spans):
        if s.name in names - {"mg.apply"}:
            assert spans[s.parent].name == "mg.apply", s
            children[s.parent].append(s.name)
        if s.name == "mg.apply":
            assert spans[s.parent].name == "lobpcg.precond"
            assert _ancestors(spans, i)[-1] == "solve"
    applies = [i for i, s in enumerate(spans) if s.name == "mg.apply"]
    assert applies
    for i in applies:
        level = next((spans[j].attrs["N"] for j in _chain(spans, i)
                      if spans[j].name == "nested.coarse"), N)
        # the V-cycle of the 6^3 level has no level below it (min_coarse 6)
        want = (["mg.smooth", "mg.smooth"] if level == 6
                else ["mg.smooth", "mg.coarse", "mg.smooth"])
        assert children[i] == want, (i, level)


def test_fine_products_run_in_the_smoothing_span(operands, monkeypatch):
    """Each ``spmm_t`` of a V-cycle (K1 on the card) runs with ``mg.smooth``
    the innermost open span."""
    from dune_eigensolver_tpu_torch.factorize import multigrid as mg

    where, inner = [], mg.spmm_t

    def spmm_t(A, X):
        where.append(vlog._records[vlog._open[-1]].name if vlog._open else None)
        return inner(A, X)

    monkeypatch.setattr(mg, "spmm_t", spmm_t)
    with vlog.tracing():
        _solve(operands)
    assert where and set(where) == {"mg.smooth"}


def test_each_coarse_span_holds_its_levels_iterations(operands, monkeypatch):
    """Each LOBPCG iteration preconditions once, so the ``lobpcg.precond``
    spans inside a ``nested.coarse`` span count that level's iterations,
    and those outside every one count the fine level's."""
    got, inner = [], nmod.lobpcg_generalized

    def recording(*args, **kwargs):
        res = inner(*args, **kwargs)
        got.append(int(res.iterations))
        return res

    monkeypatch.setattr(nmod, "lobpcg_generalized", recording)
    with vlog.tracing() as spans:
        res = _solve(operands, seed=7)
    assert len(got) == 3 and int(res.iterations) == got[2]
    coarse = [i for i, s in enumerate(spans) if s.name == "nested.coarse"]
    by_level = collections.Counter()
    for i, s in enumerate(spans):
        if s.name == "lobpcg.precond":
            by_level[next((j for j in _chain(spans, i) if j in coarse), None)] += 1
    assert [by_level[i] for i in coarse] + [by_level[None]] == got


def test_level_counter_is_the_levels_iterations(operands, monkeypatch):
    got, inner = [], nmod.lobpcg_generalized

    def recording(*args, **kwargs):
        res = inner(*args, **kwargs)
        got.append(int(res.iterations))
        return res

    monkeypatch.setattr(nmod, "lobpcg_generalized", recording)
    before = collections.Counter(nmod.lobpcg_nested.iterations)
    calls = nmod.lobpcg_nested.calls
    res = _solve(operands, seed=7)
    after = nmod.lobpcg_nested.iterations
    assert len(got) == 3 and nmod.lobpcg_nested.calls == calls + 1
    # depth below the fine grid: 2 the 6^3 level, 1 the 12^3, 0 the fine one
    assert {d: after[d] - before[d] for d in (2, 1, 0)} == {2: got[0], 1: got[1], 0: got[2]}
    assert int(res.iterations) == got[2]
    assert isinstance(nmod.lobpcg_nested.iterations, collections.Counter)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_spans_leave_the_operations_and_the_bits(operands, monkeypatch):
    with _Ops() as off_ops:
        off = _solve(operands)
    with vlog.tracing() as spans, _Ops() as on_ops:
        on = _solve(operands)
    assert {"nested.coarse", "mg.apply"} <= {s.name for s in spans}
    assert on_ops.ops == off_ops.ops and len(off_ops.ops) > 0
    assert torch.equal(off.eigenvalues, on.eigenvalues)
    assert torch.equal(off.eigenvectors, on.eigenvectors)
    assert int(off.iterations) == int(on.iterations)

    def refused(*_a, **_k):
        raise AssertionError("a span was opened with the spans off")

    monkeypatch.setattr(vlog, "_On", refused)
    with _Ops() as again:
        same = _solve(operands)
    assert again.ops == off_ops.ops and torch.equal(same.eigenvectors, off.eigenvectors)
