"""The window arithmetic of ``host.solve_s`` and ``host.solve_p80_s`` on fixed times,
and the seed derivation."""

import pytest

from solvebench import registry, yardstick
from solvebench.run import Run

TIMES = [0.50 + 0.01 * k for k in range(50)]  # 0.50 .. 0.99 s


def _run(times, window_s):
    return Run("cell", {}, {}, 1.0, window_s, list(times), [3] * len(times), 0)


def test_solve_s_is_the_window_over_the_solves():
    window = sum(TIMES) + 0.2  # the host's own seconds between solves count too
    assert registry.metric("host.solve_s").read(_run(TIMES, window)) == pytest.approx(window / 50)
    with pytest.raises(ValueError):
        yardstick.per_solve(10.0, 0)


def test_p80_by_nearest_rank():
    # rank ceil(0.8 * 50) = 40: the 40th smallest, with ten solves beyond it
    assert registry.metric("host.solve_p80_s").read(_run(TIMES, 30.0)) == pytest.approx(0.89)
    assert yardstick.nearest_rank([3.0, 1.0, 2.0], 80) == 3.0
    assert yardstick.nearest_rank([1.0, 2.0, 3.0, 4.0, 5.0], 80) == 4.0
    assert yardstick.nearest_rank([7.0], 80) == 7.0
    shuffled = TIMES[25:] + TIMES[:25]
    assert yardstick.nearest_rank(shuffled, 80) == yardstick.nearest_rank(TIMES, 80)


def test_peak_and_iterations():
    run = _run(TIMES, 30.0)
    run.peak_bytes = 15_082_141_184
    run.iterations = [3, 3, 4, 3]
    assert registry.metric("peak_gb").read(run) == pytest.approx(15.082141184)
    assert registry.metric("solver.iterations").read(run) == pytest.approx(3.25)


def test_seeds_derive_per_solve_and_repeat():
    big = 2**31 + 12345
    a = [yardstick.derive_seed(big, 2, i) for i in range(100)]
    assert a == [yardstick.derive_seed(big, 2, i) for i in range(100)]
    assert len(set(a)) == 100
    assert all(0 <= s < 2**63 for s in a)
    assert yardstick.derive_seed(big, 2, 0) != yardstick.derive_seed(big + 1, 2, 0)
    assert yardstick.derive_seed(big, 1) != yardstick.derive_seed(big, 2, 0)
