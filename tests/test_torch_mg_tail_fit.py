"""The multigrid tail's fit rule and counters (``kernels/mg_tail.py``,
``factorize/multigrid.py``) on the CPU: where the V-cycle would enter the
kernel, from shapes, level type and a shared-memory limit alone, and that a
CPU block stays eager (the kernel's plain version) while the V-cycle counts
its applies."""

import pytest
import torch

from dune_eigensolver_tpu_torch.factorize import multigrid as tmg
from dune_eigensolver_tpu_torch.kernels import mg_tail as mt
from dune_eigensolver_tpu_torch.sparse import problems

torch.set_num_threads(2)

H100_OPTIN = 232_448  # the H100's opt-in shared memory a block, bytes


def test_tail_bytes_is_the_kernels_layout():
    """27^3 / 13^3 bf16 levels (three arrays each, on 16 bytes) and the 6^3
    coarsest (b in bf16, four f32 CG arrays, 256 bytes of the CG's partial
    sums): ~132 KiB a row."""
    dims = ((27, 27, 27), (13, 13, 13), (6, 6, 6))
    assert mt.tail_bytes(dims, torch.bfloat16) == 3 * 39_376 + 3 * 4_400 + 432 + 4 * 864 + 256
    assert mt.tail_bytes(dims, torch.float32) == 3 * 78_736 + 3 * 8_800 + 864 + 4 * 864 + 256
    assert mt.tail_bytes(((6, 6, 6),), torch.float64) == 1_728 + 4 * 864 + 256
    assert mt.tail_bytes(((5, 3),), torch.bfloat16) == 32 + 4 * 64 + 256


@pytest.mark.parametrize("N,dtype,limit,entry", [
    # the north star's bf16 levels on an H100: 27^3 in every nested level's cycle
    (54, torch.bfloat16, H100_OPTIN, (27, 27, 27)),
    (108, torch.bfloat16, H100_OPTIN, (27, 27, 27)),
    (216, torch.bfloat16, H100_OPTIN, (27, 27, 27)),
    # f32 and f64 levels leave 27^3 out (its three f32 arrays alone are 236 KB)
    (54, torch.float32, H100_OPTIN, (13, 13, 13)),
    (216, torch.float32, H100_OPTIN, (13, 13, 13)),
    (108, torch.float64, H100_OPTIN, (13, 13, 13)),
    # a smaller limit moves the entry down, a tiny one leaves the tail eager
    (216, torch.bfloat16, 100_000, (13, 13, 13)),
    (54, torch.bfloat16, 135_471, (13, 13, 13)),
    (54, torch.bfloat16, 135_472, (27, 27, 27)),
    (108, torch.bfloat16, 4_200, (6, 6, 6)),
    (216, torch.bfloat16, 1_000, None),
])
def test_fit_rule_picks_the_entry(N, dtype, limit, entry):
    levels = tmg._coarse_levels((N,) * 3, 6)
    start = mt.tail_start(levels, 1, dtype, limit)
    assert (None if start is None else levels[start]) == entry
    if start is not None:  # the first level that fits: the one above does not
        assert mt.fits(levels[start:], dtype, limit)
        assert start == 1 or not mt.fits(levels[start - 1:], dtype, limit)


def test_fit_rule_2d():
    """A 2D grid: 512^2 -> ... -> 4^2 in bf16 enters at 128^2 on an H100."""
    levels = tmg._coarse_levels((512, 512), 6)
    assert levels[mt.tail_start(levels, 1, torch.bfloat16, H100_OPTIN)] == (128, 128)


def test_fit_rule_caps_the_levels():
    levels = tuple((2 ** k,) * 2 for k in range(20, 0, -1))  # 20 levels of tiny 2D grids
    assert not mt.fits(levels, torch.bfloat16, 10 ** 12)
    assert len(levels[mt.tail_start(levels, 0, torch.bfloat16, 10 ** 12):]) == mt.MAX_LEVELS


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float64])
def test_cpu_blocks_stay_eager(dtype):
    levels = tmg._coarse_levels((27, 27, 27), 6)
    assert not mt.takes(torch.zeros((2, 27, 27, 27), dtype=dtype), levels, 0)


def test_wrapper_refuses_a_cpu_block():
    levels = tmg._coarse_levels((27, 27, 27), 6)
    a = torch.tensor(-1.0)
    with pytest.raises(TypeError, match="mg_tail_cuda"):
        mt.mg_tail_cuda(levels, 0, torch.zeros((2, 27, 27, 27)), (a, a, a), torch.tensor(0.0),
                        1, 1, 0.8, 48)


@pytest.mark.parametrize("cycles", [1, 2])
@pytest.mark.parametrize("dtype", [torch.bfloat16, None])
def test_counters_count_applies_and_no_tail_on_cpu(cycles, dtype):
    """Every V-cycle counts one apply of its coarse correction; on the CPU
    none goes through the kernel."""
    A = problems.laplacian_dirichlet_3d(16, dtype=torch.float32, device="cpu")
    aux, fn = tmg.mg_inverse_factory(cycles=cycles, nu1=1, nu2=1, dtype=dtype)(A)
    before = (tmg.coarse_correction.applies, mt.mg_tail_cuda.launches)
    fn(aux, torch.ones((3, 16 ** 3)))
    after = (tmg.coarse_correction.applies, mt.mg_tail_cuda.launches)
    assert [a - b for a, b in zip(after, before)] == [cycles, 0]


def test_counters_count_the_mg_cg_inverse():
    """The V-cycle-preconditioned CG counts one apply a CG step's
    preconditioning."""
    A = problems.laplacian_dirichlet_3d(12, dtype=torch.float64, device="cpu")
    aux, fn = tmg.mg_cg_inverse_factory(rtol=1e-6, maxiter=30)(A)
    before = tmg.coarse_correction.applies
    fn(aux, torch.ones((2, 12 ** 3), dtype=torch.float64))
    assert tmg.coarse_correction.applies - before >= 2
