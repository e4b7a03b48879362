"""The frozen byte models against hand counts at the two cells' shapes."""

import pytest
import torch

from solvebench import registry, yardstick

N216 = 216**3  # 10,077,696 rows
N512 = 522_242  # 2 * 511^2 dofs
NNZB512 = (3 * 511 - 2) ** 2  # every interior node and its interior neighbours: 2,343,961


def test_k1_bytes_at_the_north_star():
    # f32, 7 diagonals, 24 rows: (7 + 2 * 24) * n floats of 4 bytes
    assert yardstick.bytes_spmm_dia(N216, 7, 24, 4) == 4 * 55 * N216 == 2_217_093_120
    # the bf16 fine smoothing at 54^3: (7 + 48) * 157,464 values of 2 bytes
    assert yardstick.bytes_spmm_dia(54**3, 7, 24, 2) == 2 * 55 * 157_464 == 17_321_040


def test_k3_bytes_at_the_geneo_pencil():
    # 4 values and one int32 a block, X and Y of 8 rows once each, f32
    want = 4 * (4 * NNZB512 + 2 * N512 * 8) + 4 * NNZB512
    assert want == 80_302_708
    assert yardstick.bytes_bsr_least(NNZB512, N512, 8, 4, 2) == want
    # PERF.md's K3 bound at this shape: 0.0240 ms at 3.35 TB/s
    assert want / yardstick.HBM_BYTES_PER_S * 1e3 == pytest.approx(0.0240, abs=5e-5)
    # the lumped mass B: one block a row
    assert yardstick.bytes_bsr_least(N512 // 2, N512, 8, 4, 2) == 4 * (4 * 261_121 + 2 * N512 * 8) + 4 * 261_121


@pytest.mark.parametrize("N", [4, 8, 17])
def test_generator_block_count_follows_the_hand_count(N):
    arrays = registry.operands("elasticity2d_bsr").make({"N": N, "E": 1.0, "nu": 0.3,
                                                        "dtype": "float32"}, "cpu")
    assert arrays["nnzb"] == (3 * (N - 1) - 2) ** 2
    assert arrays["n"] == 2 * (N - 1) ** 2
    assert arrays["bdata"].dtype == torch.float32


def test_k1_reader_ties_records_to_calls():
    from solvebench.trace import DeviceOp, Profile

    run = _traced([("dia_spmm_t_cuda", dict(n=1000, ndiag=7, m=24, itemsize=4))],
                  [DeviceOp("void dia_spmm_t_vec_kernel<float, 4>(...)", 0.0, 10.0,
                            ("aten::x", "solvebench.launch.0"))])
    want = 100 * yardstick.bytes_spmm_dia(1000, 7, 24, 4) / yardstick.HBM_BYTES_PER_S / 10e-6
    assert registry.metric("k1.hbm_pct").read(run) == pytest.approx(want)
    assert registry.metric("k3.hbm_pct").read(run) is None
    run.host_profile = Profile(1.0, [])
    assert registry.metric("k1.hbm_pct").read(run) is None


def test_a_call_that_launches_two_records_counts_its_bytes_once():
    from solvebench.trace import DeviceOp

    call = dict(n=N512, m=8, itemsize=4, block=2, nnzb=NNZB512)
    run = _traced([("bsr_spmm_t_cuda", call)],
                  [DeviceOp("bsr_spmm_t_kernel<float>", 0.0, 20.0, ("solvebench.launch.0",)),
                   DeviceOp("bsr_spmm_t_kernel<float>", 30.0, 20.0, ("solvebench.launch.0",))])
    want = 100 * yardstick.bytes_bsr_least(NNZB512, N512, 8, 4, 2) / yardstick.HBM_BYTES_PER_S / 40e-6
    assert registry.metric("k3.hbm_pct").read(run) == pytest.approx(want)


def _traced(calls, ops):
    from solvebench.run import Run
    from solvebench.trace import Profile

    run = Run("cell", {}, {}, 1.0, 1.0, [1.0], [3], 0)
    run.launches = [dict(kernel=k, **d) for k, d in calls]
    run.host_profile = Profile(1.0, ops)
    run.device_profile = Profile(1.0, ops)
    return run
