"""The gather probes' plain versions against the JAX probes, on the CPU.

Each of the eleven probes of ``experiments/mosaic_gather_probe.py`` runs
its Pallas kernel in interpret mode through a monkeypatch of
``pl.pallas_call`` made here, which also records the kernel's inputs and
output; the port's plain version of the same probe is then given those
very inputs and must return that very output (exact: the kernels only move
values, and the widen-add is one f32 add). The port's CUDA kernels are held
to these plain versions on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

import experiments.mosaic_gather_probe as jprobe

from dune_eigensolver_tpu_torch.experiments import gather_probe as gp

torch.set_num_threads(2)

# JAX probe function -> the port's plain version on the recorded inputs
PLAIN = {
    "gather_1vreg": lambda x, i: gp.gather_lanes_reference(x, i, 128),
    "gather_2sublane": lambda x, i: gp.gather_lanes_reference(x, i, 128),
    "dyn_scratch_load": lambda x, p: gp.lane_slice_reference(x, p, 128),
    "dyn_input_load": gp.block_select_reference,
    "dyn_lane_slice": lambda x, p: gp.lane_slice_reference(x, p, 128),
    "dyn_roll": lambda x, s: gp.roll_lanes_reference(x, s, 256),
    "gather_2lane": lambda x, i: gp.gather_lanes_reference(x, i, 256),
    "gather_sublane_axis": gp.gather_axis0_reference,
    "vmem_scalar_index": lambda x, b: gp.block_select_reference(x, b[1, 2:3]),
    "int8_widen": gp.int8_widen_reference,
    "int8_gather_idx": lambda x, i: gp.gather_lanes_reference(x, i, 128),
}


@pytest.fixture
def recorded(monkeypatch):
    """Interpret mode for the probes' ``pl.pallas_call``; every call's
    inputs and output are appended to the returned list."""
    calls = []
    real = jprobe.pl.pallas_call

    def pallas_call(kernel, **kw):
        fn = real(kernel, interpret=True, **kw)

        def run(*args):
            out = fn(*args)
            calls.append(([np.array(a) for a in args], np.array(out)))
            return out

        return run

    monkeypatch.setattr(jprobe.pl, "pallas_call", pallas_call)
    return calls


@pytest.mark.parametrize("name", sorted(PLAIN))
def test_jax_probe_equals_port_plain_version(recorded, name):
    """Exact. A probe that raises before its kernel ran (the (8, 256)
    gather may, by design; ``int8_gather_idx`` builds an out-of-range int8
    on the host with a recent numpy) leaves nothing recorded: the port is
    then held to numpy on the probe's documented input."""
    try:
        verdict = np.asarray(getattr(jprobe, name)())
    except Exception:
        verdict = None
    if recorded:
        args, out = recorded[-1]
        assert verdict is not None and verdict.all()
        got = PLAIN[name](*(torch.from_numpy(a) for a in args)).numpy()
        assert got.dtype == out.dtype and np.array_equal(got, out)
    else:
        width = 256 if name == "gather_2lane" else 128
        x = np.arange(8 * width, dtype=np.float32).reshape(8, width)
        idx = np.broadcast_to(np.flip(np.arange(width)), (8, width))
        idx = idx.astype(np.int8 if name == "int8_gather_idx" else np.int32)
        got = PLAIN[name](torch.from_numpy(x), torch.from_numpy(idx.copy())).numpy()
        assert np.array_equal(got, np.take_along_axis(x, idx.astype(np.int64), axis=1))


@pytest.mark.parametrize("name,fn", gp.PROBES, ids=[n for n, _ in gp.PROBES])
def test_port_probe_is_ok_on_cpu(name, fn, capsys):
    """The port's own probe, same input as the reference's, through its
    plain version: every element equal, and the protocol line says OK."""
    assert gp.probe(name, lambda: fn(torch.device("cpu"))) == "OK"
    assert capsys.readouterr().out == f"PROBE {name}: OK\n"


def test_probe_protocol_lines(capsys):
    assert gp.probe("a", lambda: np.array([True, False])) == "WRONG-RESULT"

    def boom():
        raise RuntimeError("no\nsuch form")

    assert gp.probe("b", boom).startswith("FAIL RuntimeError('no")
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "PROBE a: WRONG-RESULT" and out[1].startswith("PROBE b: FAIL RuntimeError(")
    assert "\\n" in out[1] and len(out) == 2


def test_plain_versions_at_odd_shapes():
    """Segments, negative and large shifts, clamped indices: against numpy,
    exact."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 512)).astype(np.float32)
    xt = torch.from_numpy(x)
    idx = rng.integers(0, 64, (3, 512)).astype(np.int32)
    want = np.take_along_axis(x.reshape(3, 8, 64), idx.reshape(3, 8, 64).astype(np.int64),
                              axis=2).reshape(3, 512)
    assert np.array_equal(gp.gather_lanes_reference(xt, torch.from_numpy(idx), 64).numpy(), want)
    wild = torch.from_numpy(np.where(idx % 2 == 0, idx + 1000, -idx).astype(np.int32))
    clamped = wild.clamp(0, 63)
    assert torch.equal(gp.gather_lanes_reference(xt, wild, 64),
                       gp.gather_lanes_reference(xt, clamped, 64))
    for s in (-5, 0, 37, 130, 64):
        got = gp.roll_lanes_reference(xt, torch.tensor([s], dtype=torch.int32), 128).numpy()
        assert np.array_equal(got, np.roll(x.reshape(3, 4, 128), -s, axis=2).reshape(3, 512))
    rows = rng.integers(-2, 6, (3, 512)).astype(np.int32)
    got = gp.gather_axis0_reference(xt, torch.from_numpy(rows)).numpy()
    assert np.array_equal(got, np.take_along_axis(x, np.clip(rows, 0, 2).astype(np.int64), axis=0))
    x3 = torch.from_numpy(rng.standard_normal((4, 3, 128)).astype(np.float32))
    for p, q in ((-1, 0), (2, 2), (9, 3)):
        assert torch.equal(gp.block_select_reference(x3, torch.tensor([p], dtype=torch.int32)),
                           x3[q])
        assert torch.equal(gp.lane_slice_reference(xt, torch.tensor([p], dtype=torch.int32), 128),
                           xt[:, 128 * q:128 * (q + 1)])


def test_probe_wrappers_refuse_cpu_tensors():
    """No fallback: on a CPU tensor every kernel wrapper raises, before
    anything is built."""
    x = torch.ones((8, 128))
    i32 = torch.zeros((8, 128), dtype=torch.int32)
    p = torch.zeros((1,), dtype=torch.int32)
    calls = [
        lambda: gp.gather_lanes_smem(x, i32, 128),
        lambda: gp.gather_lanes_shfl(x, i32),
        lambda: gp.gather_lanes_global(x, i32, 128),
        lambda: gp.gather_lanes_int8(x, i32.to(torch.int8), 128),
        lambda: gp.block_select_scratch(x, p, 32),
        lambda: gp.lane_slice(x, p, 32),
        lambda: gp.block_select(x.reshape(4, 8, 32), p),
        lambda: gp.roll_lanes(x, p, 128),
        lambda: gp.gather_axis0(x, i32),
        lambda: gp.int8_widen(x, i32.to(torch.int8)),
        lambda: gp.lane_slice_first(x, p, 32),
        lambda: gp.block_select_first(x.reshape(4, 8, 32), p),
        lambda: gp.block_select_scratch_first(x, p, 32),
        lambda: gp.gather_axis0_first(x, i32),
    ]
    assert len(calls) == len(gp.KERNELS) + len(gp.FIRST_VERSIONS)
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert all(fn.launches == 0 for fn in (*gp.KERNELS.values(), *gp.FIRST_VERSIONS.values()))
    assert gp.gather_axis0.body is None and gp.gather_axis0_first.body is None


# (bw, row_stride, block_stride, align, width): lane_slice's strides are
# (nb * bw, bw), block_select's (bw, rows * bw)
WIDTH_CASES = [
    (128, 512, 128, 16, 4),        # the probes' blocks, aligned
    (1048576, 4194304, 1048576, 16, 4),  # form_table's lane_slice
    (1048576, 1048576, 8388608, 16, 4),  # form_table's block_select
    (128, 512, 128, 64, 4),        # more than 16 bytes of alignment is 16
    (128, 512, 128, 8, 1),         # a view 8 bytes off
    (128, 512, 128, 4, 1),         # a view one float off
    (127, 508, 127, 16, 1),        # bw not a multiple of 4: the scalar path
    (6, 6, 18, 16, 1),             # bw even, but rows of 6 floats break float4
    (4, 4, 12, 16, 4),             # one float4 a row, odd rows (3)
    (8, 8, 8, 16, 4),              # nb = 1, one row
    (8, 10, 8, 16, 1),             # a row stride off the 16-byte grid
    (8, 8, 6, 16, 1),              # a block stride off the 16-byte grid
]


@pytest.mark.parametrize("bw,row_stride,block_stride,align,width", WIDTH_CASES)
def test_slice_vector_width(bw, row_stride, block_stride, align, width):
    """The row copy's choice between float4 and scalar moves, from shapes,
    strides and alignment alone (the launcher refuses float4 elsewhere)."""
    assert gp.slice_vector_width(bw, row_stride, block_stride, align) == width


def test_probe_main_on_cpu(capsys):
    """``main`` with ``--device cpu``: eleven PROBE lines, ``probe done``,
    then the FORM table of the plain versions at a small shape."""
    assert gp.main(["--device", "cpu", "--width", "2048"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("device: cpu platform=cpu (plain versions")
    assert out[1:12] == [f"PROBE {name}: OK" for name, _ in gp.PROBES]
    assert out[12] == "probe done"
    forms = [ln.split()[1] for ln in out[13:]]
    assert all(ln.startswith("FORM name=") and "us=plain-only" in ln for ln in out[13:])
    assert forms == ["name=copy", "name=gather_lanes_shfl", "name=gather_lanes_smem",
                     "name=gather_lanes_global", "name=gather_lanes_int8", "name=gather_axis0",
                     "name=roll_lanes", "name=int8_widen", "name=block_select_scratch",
                     "name=lane_slice", "name=block_select"]


def test_form_table_rows_on_cpu():
    """The table's rows on the CPU (plain versions only): the bytes are those
    of the function, so the three block selections count one block in and
    one out; the scratch form now moves just that, and its first version's
    staging of all four is listed apart."""
    rows = list(gp.form_table("cpu", width=1024))
    names = [r["name"] for r in rows]
    assert names[0] == "copy" and sorted(names[1:]) == sorted(gp.KERNELS)
    f4 = 8 * 1024 * 4
    by = {r["name"]: r for r in rows}
    assert by["copy"]["nbytes"] == 2 * f4 and by["gather_axis0"]["nbytes"] == 3 * f4
    assert by["int8_widen"]["nbytes"] == 2 * f4 + f4 // 4
    assert by["lane_slice"]["nbytes"] == f4 // 2 and by["block_select"]["shape"] == (4, 8, 256)
    assert by["block_select_scratch"]["nbytes"] == by["lane_slice"]["nbytes"]
    assert all(r["streamed_bytes"] == r["nbytes"] for r in rows)
    assert by["block_select_scratch"]["first_streamed_bytes"] == f4 + f4 // 4
    assert all(r["first_streamed_bytes"] is None for r in rows
               if r["name"] != "block_select_scratch")
    assert all(r["us"] is None and r["max_abs_err"] is None and r["plain_us"] > 0
               and r["library_us"] > 0 and r["gbps"] > 0 for r in rows)
    assert all(r["first_us"] is None for r in rows)  # first versions are timed on the card
    assert by["gather_axis0"]["streamed_bytes"] == 3 * f4  # x, idx and out once
    assert "gather_axis0" in gp.FIRST_VERSIONS
    # so are the kernels, eager and by replay, and the library's eager chain
    assert all(r["eager_us"] is None and r["library_eager_us"] is None for r in rows)


# (bw, align, body): the scratch selection's choice between its bulk copies
# and the row copy of ``lane_slice``, one float a thread
SCRATCH_CASES = [
    (1048576, 16, "bulk"),   # form_table's block, aligned
    (128, 16, "bulk"),       # the probe's blocks
    (4, 64, "bulk"),         # one float4 a row; more than 16 bytes of alignment is 16
    (128, 8, "rows"),        # a view 8 bytes off
    (128, 4, "rows"),        # a view one float off
    (127, 16, "rows"),       # bw not a multiple of 4
    (4097, 16, "rows"),      # nor here, with several chunks a row
    (6, 16, "rows"),         # bw even, but rows of 6 floats break the 16-byte grid
]


@pytest.mark.parametrize("bw,align,body", SCRATCH_CASES)
def test_scratch_body(bw, align, body):
    """The scratch selection's chooser, from the block width and the
    alignment alone (the launcher refuses the bulk body elsewhere)."""
    assert gp.scratch_body(bw, align) == body



# (rows, width, align, body): the gather across rows' choice between its
# bulk copies and its first version, one float a thread through L1/L2
AXIS0_CASES = [
    (8, 4194304, 16, "bulk"),   # the timed shape, aligned
    (1, 4, 16, "bulk"),         # one float4 of one row
    (3, 1000, 64, "bulk"),      # a last chunk of 488 columns; more than 16 bytes is 16
    (16, 8192, 16, "bulk"),     # 32 KB a block
    (113, 512, 16, "bulk"),     # the most rows whose block fits in shared memory
    (114, 512, 16, "first"),    # one row more than fits
    (8, 1001, 16, "first"),     # a width off the 16-byte grid
    (8, 1002, 16, "first"),     # even, but rows of 1,002 floats break it
    (8, 4096, 8, "first"),      # a tensor 8 bytes off
    (8, 4096, 4, "first"),      # a tensor one float off
]


@pytest.mark.parametrize("rows,width,align,body", AXIS0_CASES)
def test_axis0_body(rows, width, align, body):
    """The gather across rows' chooser, from shape and alignment alone (the
    launcher refuses the bulk body elsewhere)."""
    assert gp.axis0_body(rows, width, align) == body


def test_axis0_bodies_are_the_launchers_flags():
    """Each body has its own flag of ``gather_axis0_launch``, the chooser
    picks each at some shape, and the row limit is the one a 227 KB block
    with its 16-byte barrier gives at 512 columns."""
    assert gp.AXIS0_BODIES == {"first": 0, "bulk": 1}
    assert {gp.axis0_body(r, w, a) for r, w, a, _ in AXIS0_CASES} == set(gp.AXIS0_BODIES)
    assert gp.AXIS0_TILE == 512 and gp.AXIS0_MAX_ROWS == 113
    assert 16 + 113 * 512 * 4 <= 227 * 1024 < 16 + 114 * 512 * 4
