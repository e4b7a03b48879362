"""The port's paranoid mode against the JAX package's ``utils/paranoid.py``.

Both packages sample the centre 128 columns of a kernel's output and check
a ``b_identity=True`` assertion on a seeded random probe. The JAX package
prints its alarm from the device at once; the port keeps a flag on the
output's device and prints the same text when ``report`` reads the flags
(at the end of each solver entry point). The card test
(tests/test_torch_cuda.py) checks a kernel dispatch; on the CPU ``spmm_t``
runs the plain versions, which are not checked, as the JAX package checks
only its Pallas dispatches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dune_eigensolver_tpu.solvers import lobpcg_generalized as jlobpcg
from dune_eigensolver_tpu.sparse import problems as jproblems
from dune_eigensolver_tpu.sparse.formats import DIAMatrix as JDIA
from dune_eigensolver_tpu.utils import paranoid as jparanoid
from dune_eigensolver_tpu_torch.solvers import lobpcg_generalized as tlobpcg
from dune_eigensolver_tpu_torch.sparse import dia_from_numpy, spmm_t
from dune_eigensolver_tpu_torch.utils import paranoid

torch.set_num_threads(2)


@pytest.fixture
def paranoid_on():
    paranoid.set_paranoid(True)
    jparanoid.set_paranoid(True)
    try:
        yield
    finally:
        paranoid.set_paranoid(False)
        jparanoid.set_paranoid(False)


def _alarms(text):
    return [ln for ln in text.splitlines() if ln.startswith("PARANOID")]


def _pencils():
    Aj = jproblems.laplacian_dirichlet_2d(12, dtype=np.float32)
    n = Aj.shape[0]
    B_id = JDIA(data=jnp.ones((1, n), np.float32), offsets=(0,), shape=Aj.shape)
    B_mass = jproblems.laplacian_b_2d(12, 3, dtype=np.float32)
    port = [dia_from_numpy(np.asarray(M.data), M.offsets, M.shape, device="cpu")
            for M in (Aj, B_id, B_mass)]
    return (Aj, B_id, B_mass), port


def test_b_identity_check_matches_jax(paranoid_on, capfd):
    """tests/test_north_star.py's check in both packages: silent on the
    identity, the same alarm on the GenEO mass matrix, once a solve."""
    (Aj, Bj_id, Bj_mass), (At, Bt_id, Bt_mass) = _pencils()
    kw = dict(nev=4, tol=1e-3, maxiter=8, shift=1e-3, b_identity=True, precond=False)
    capfd.readouterr()
    tlobpcg(At, Bt_id, **kw)
    jlobpcg(Aj, Bj_id, **kw)
    jax.effects_barrier()
    assert _alarms(capfd.readouterr().out) == []
    tlobpcg(At, Bt_mass, **kw)
    t_alarm = _alarms(capfd.readouterr().out)
    jlobpcg(Aj, Bj_mass, **kw)
    jax.effects_barrier()
    j_alarm = _alarms(capfd.readouterr().out)
    assert len(t_alarm) == 1 and t_alarm == j_alarm
    assert "b_identity=True" in t_alarm[0]
    assert paranoid.report() == []  # the solve's report cleared the flag


def test_b_identity_check_is_off_without_paranoid(capfd):
    (_, _, _), (At, _, Bt_mass) = _pencils()
    tlobpcg(At, Bt_mass, nev=4, tol=1e-3, maxiter=8, shift=1e-3, b_identity=True,
            precond=False)
    assert _alarms(capfd.readouterr().out) == []
    assert paranoid._FLAGS == {}


def test_nan_check_alarm_matches_jax_and_report_clears(paranoid_on, capfd):
    Y = np.ones((3, 1000), np.float32)
    Y[1, 500] = np.inf  # inside the centre 128 columns
    assert paranoid.nan_check(torch.from_numpy(Y), "dia_spmm_t_cuda") is not None
    jparanoid.nan_check(jnp.asarray(Y), "dia_spmm_t_cuda")
    jax.effects_barrier()
    j_alarm = _alarms(capfd.readouterr().out)
    lines = paranoid.report()
    t_alarm = _alarms(capfd.readouterr().out)
    assert lines == t_alarm == j_alarm and len(lines) == 1
    assert paranoid.report() == []  # cleared
    assert _alarms(capfd.readouterr().out) == []


def test_nan_check_flags_are_sticky_per_tag(paranoid_on, capfd):
    """A flag raised once stays raised through clean dispatches until it is
    reported; each tag has its own."""
    bad = torch.ones((2, 300))
    bad[0, 150] = float("nan")
    good = torch.ones((2, 300))
    paranoid.nan_check(bad, "k1")
    paranoid.nan_check(good, "k1")
    paranoid.nan_check(good, "k2")
    lines = paranoid.report()
    assert len(lines) == 1 and "'k1'" in lines[0]


def test_nan_check_samples_the_centre_as_jax_does(paranoid_on, capfd):
    """A non-finite value outside the centre 128 columns is not seen, in
    either package."""
    Y = np.ones((2, 1000), np.float32)
    Y[0, 10] = np.inf
    out = paranoid.nan_check(torch.from_numpy(Y), "k")
    assert torch.equal(out, torch.from_numpy(Y))
    jparanoid.nan_check(jnp.asarray(Y), "k")
    jax.effects_barrier()
    assert paranoid.report() == [] and _alarms(capfd.readouterr().out) == []


def test_off_adds_nothing():
    """Paranoid mode off: ``nan_check`` returns its argument, makes no flag,
    and ``report`` reads nothing; turning it off drops unread flags."""
    Y = torch.full((2, 10), float("inf"))
    assert paranoid.nan_check(Y, "k") is Y
    assert paranoid._FLAGS == {} and paranoid.report() == []
    paranoid.set_paranoid(True)
    paranoid.nan_check(Y, "k")
    assert len(paranoid._FLAGS) == 1
    paranoid.set_paranoid(False)
    assert paranoid._FLAGS == {}


def test_cpu_products_are_not_checked(paranoid_on):
    """``spmm_t`` checks kernel dispatches only: the plain CPU product of an
    infinite X raises no flag (the JAX package checks only its Pallas
    dispatches)."""
    (_, _, _), (At, _, _) = _pencils()
    X = torch.full((2, At.shape[0]), float("inf"))
    spmm_t(At, X)
    assert paranoid._FLAGS == {}


def test_reporting_reports_once_per_outermost_call(paranoid_on, monkeypatch):
    calls = []
    monkeypatch.setattr(paranoid, "report", lambda: calls.append(1))

    @paranoid.reporting
    def inner():
        return 1

    @paranoid.reporting
    def outer():
        return inner() + inner()

    assert outer() == 2 and calls == [1]
    assert inner() == 1 and calls == [1, 1]
    paranoid.set_paranoid(False)
    outer()
    assert calls == [1, 1]
