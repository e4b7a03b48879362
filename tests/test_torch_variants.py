"""The kernel experiments' plain versions and the column-layout wrappers
against the JAX package, on the CPU.

The JAX staging variants (``experiments/kernel_variants.py``: ``spmm_c``,
``spmm_b``, ``spmm_d``) and copy probes (``experiments/pipeline_probe.py``)
run their Pallas kernels in interpret mode, through a monkeypatch of
``pl.pallas_call`` made in this file (nothing in ``experiments/`` is
edited); all of them, manual DMA included, run that way on the CPU. The port's
CUDA kernels cannot run here: what is held to the JAX kernels is their plain
version, ``dia_spmm_t_reference`` (one for all three variants, which
compute one function) and ``ident_reference``/``identd_reference``; the
kernels themselves are held to those plain versions on the card
(tests/test_torch_cuda.py). Inputs come from numpy seeds.
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import experiments.kernel_variants as jkv
import experiments.pipeline_probe as jpp
from dune_eigensolver_tpu.kernels.dia_spmm import PaddedLayout, _round_up
from dune_eigensolver_tpu.ops import ortho as jortho
from dune_eigensolver_tpu.sparse import formats as jformats
from dune_eigensolver_tpu.sparse import problems as jproblems
from dune_eigensolver_tpu.sparse.spmm import spmm as jspmm

from dune_eigensolver_tpu_torch.experiments import kernel_variants as tkv
from dune_eigensolver_tpu_torch.experiments import pipeline_probe as tpp
from dune_eigensolver_tpu_torch.kernels.dia_spmm import dia_spmm_t_reference
from dune_eigensolver_tpu_torch.ops import ortho as tortho
from dune_eigensolver_tpu_torch.solvers.standard import random_multivector, random_multivector_t
from dune_eigensolver_tpu_torch.sparse import (
    bsr_from_numpy,
    dia_from_numpy,
    ell_from_numpy,
    spmm,
)
from dune_eigensolver_tpu_torch.sparse.spmm import bsr_spmm, dia_spmm, ell_spmm

torch.set_num_threads(2)


@pytest.fixture
def interpret(monkeypatch):
    """Run every ``pl.pallas_call`` of the two experiment modules in
    interpret mode (they share the ``pl`` module object)."""
    assert jkv.pl is jpp.pl
    monkeypatch.setattr(jkv.pl, "pallas_call",
                        functools.partial(jkv.pl.pallas_call, interpret=True))


def _dia_case(N, m, seed):
    """2D 5-point pattern with seeded coefficients, f32; n = N^2 <= 2,000."""
    rng = np.random.default_rng(seed)
    A = jproblems.laplacian_dirichlet_2d(N, dtype=np.float32)
    n = A.shape[0]
    data = np.asarray(A.data) * rng.uniform(0.5, 1.5, (5, n)).astype(np.float32)
    Aj = jformats.DIAMatrix(data=jnp.asarray(data), offsets=A.offsets, shape=A.shape)
    At = dia_from_numpy(data, A.offsets, A.shape, device="cpu")
    X = rng.standard_normal((m, n)).astype(np.float32)
    return Aj, At, X


def _jax_variant(name, Aj, X, T):
    """The JAX variant's result on (m, n), through the operand layout its
    ``main`` gives it."""
    m, n = X.shape
    Xt = jnp.asarray(X)
    if name == "c":
        halo = max(abs(o) for o in Aj.offsets)
        H = _round_up(max(halo, 128), 128)
        n_pad = _round_up(n, T)
        Xp = jnp.pad(Xt, ((0, 0), (H, H + n_pad - n)))
        data = jnp.pad(Aj.data, ((0, 0), (0, n_pad - n)))
        return np.asarray(jkv.spmm_c(Aj.offsets, Aj.shape, T, data, Xp))[:, :n]
    L = PaddedLayout(n, m, Aj.offsets, tile=T)
    Ap, Xp = L.pad_operator(Aj), L.pad(Xt)
    if name.startswith("b"):
        s, q = int(name[1]), int(name[2])
        Y = jkv.spmm_b(Aj.offsets, L.T, L.G, L.width, Ap.data, Xp, nslots=s, depth=q)
    else:
        Y = jkv.spmm_d(Aj.offsets, L.T, L.width, Ap.data, Xp, alias=name == "d_alias")
    return np.asarray(L.unpad(Y))


@pytest.mark.parametrize("name", ["c", "b21", "b32", "b43", "d", "d_alias"])
@pytest.mark.parametrize("N,T", [(40, 256), (44, 512)])
def test_jax_variant_equals_port_plain_version(interpret, name, N, T):
    """f32, the same five products per entry summed in offset order by both:
    1e-5 of max|Y|. n = 1,600 and 1,936 are no multiples of the tile."""
    Aj, At, X = _dia_case(N, 8, seed=N)
    Y = dia_spmm_t_reference(At, torch.from_numpy(X)).numpy()
    J = _jax_variant(name, Aj, X, T)
    assert J.shape == Y.shape
    assert np.abs(J - Y).max() <= 1e-5 * np.abs(Y).max()


def test_jax_variant_d_two_chain_equals_port_plain_version(interpret):
    """The reference's in-place 2-chain check, against the plain version
    applied twice."""
    Aj, At, X = _dia_case(40, 8, seed=7)
    L = PaddedLayout(X.shape[1], 8, Aj.offsets, tile=256)
    Ap, Xp = L.pad_operator(Aj), L.pad(jnp.asarray(X))
    once = jkv.spmm_d(Aj.offsets, L.T, L.width, Ap.data, Xp, alias=True)
    twice = np.asarray(L.unpad(jkv.spmm_d(Aj.offsets, L.T, L.width, Ap.data, once, alias=True)))
    Xt = torch.from_numpy(X)
    Y2 = dia_spmm_t_reference(At, dia_spmm_t_reference(At, Xt)).numpy()
    assert np.abs(twice - Y2).max() <= 1e-5 * np.abs(Y2).max()


# offset sets for variant B's geometry: the table's 2D N=2048 and the
# phase-11 N=45 Laplacians, a 3D stencil, and one-sided and shifted sets
# whose fl_base is not -(max|off|) rounded
RING_OFFSETS = [(-2048, -1, 0, 1, 2048), (-45, -1, 0, 1, 45),
                (-1369, -37, -1, 0, 1, 37, 1369), (0, 3, 200), (-300, -5), (-130, 7)]


def _reference_ring(monkeypatch, offsets, T, nslots, depth):
    """(fl_base, W) as the reference's ``spmm_b`` hands them to its kernel:
    ``pl.pallas_call`` is replaced by a recorder, so nothing runs."""
    seen = {}

    def record(kernel, **kw):
        seen["args"] = kernel.args
        return lambda *a: None

    monkeypatch.setattr(jkv.pl, "pallas_call", record)
    jkv.spmm_b(offsets, T, 1, 4 * T, None, np.zeros((8, 1), np.float32), nslots=nslots,
               depth=depth)
    fl_base, _, T_, W = seen["args"][:4]
    assert T_ == T and seen["args"][6:8] == (nslots, depth)
    return fl_base, W


@pytest.mark.parametrize("offsets", RING_OFFSETS)
@pytest.mark.parametrize("T", [256, 2048, 4096, 8192, 16384])
def test_ring_geometry_window_is_the_references(monkeypatch, offsets, T):
    """The port's W and fl_base are those the reference's ``spmm_b``
    computes (experiments/kernel_variants.py:145-147), every ring alike;
    W / T is the bytes of X a window stages per byte its tile consumes."""
    for s, q in tkv.B_RINGS:
        fl_base, W = _reference_ring(monkeypatch, offsets, T, s, q)
        g = tkv.ring_geometry(offsets, 4 * T, T, 1, s, q, check=False)
        assert (g.fl_base, g.window) == (fl_base, W)
        assert g.fl_base <= min(offsets) and T + max(offsets) - g.fl_base <= g.window
        assert g.staged_per_consumed == W / T and g.nslots == s and g.depth == q


@pytest.mark.parametrize("n,route", [(4194304, "bulk"), (2116, "bulk"), (40000, "bulk"),
                                     (2025, "first"), (40401, "first"), (4194306, "first"),
                                     (4194307, "first")])
def test_ring_geometry_route_is_a_rule_on_n(n, route):
    """Bulk copies need 16-byte sizes and addresses: n % 4 == 0 takes them,
    any other n the first version's cp.async. The bulk body's two
    coefficient tiles (5 diagonals of the tile) and its six barriers add to
    its shared memory; ``route="first"`` asks for the first version's
    geometry on any n."""
    offsets = (-45, -1, 0, 1, 45)
    g = tkv.ring_geometry(offsets, n, 2048, 2, 3, 2)
    assert g.route == route
    assert g.slot_bytes == 2 * g.window * 4
    assert g.smem_bytes == 3 * g.slot_bytes + (2 * 5 * 2048 * 4 + 48 if route == "bulk" else 0)
    first = tkv.ring_geometry(offsets, n, 2048, 2, 3, 2, route="first")
    assert first.route == "first" and first.smem_bytes == 3 * g.slot_bytes


@pytest.mark.parametrize("rows", tkv.RING_ROWS)
@pytest.mark.parametrize("T", tkv.RING_TILES)
@pytest.mark.parametrize("ring", tkv.B_RINGS)
def test_ring_geometry_fits_or_refuses(ring, T, rows):
    """Every setting of the sweep on the table's operand either fits a
    block's 227 KB (232,448 bytes) or is refused with ``ValueError`` before
    any launch; ``ring_settings`` lists it either way."""
    offsets, n = (-2048, -1, 0, 1, 2048), 2048 * 2048
    s, q = ring
    g = tkv.ring_geometry(offsets, n, T, rows, s, q, check=False)
    assert g.fits == (g.smem_bytes <= 232_448)
    assert ((s, q, T, rows), g) in list(tkv.ring_settings(offsets, n))
    if g.fits:
        assert tkv.ring_geometry(offsets, n, T, rows, s, q) == g
    else:
        with pytest.raises(ValueError, match="shared memory"):
            tkv.ring_geometry(offsets, n, T, rows, s, q)


def test_ring_sweep_fits_sixteen_settings_and_reaches_1_27():
    """On the 2D N=2048 operand the bulk body stages two (5, T) coefficient
    tiles beside the ring, so 5 of the 24 settings fit where the first
    compute body's 16 did: T = 2048 at every ring (two rows at (2, 1) only)
    and T = 4096 one row at (2, 1); W / T falls from 3.125 at T = 2048 to
    2.06 at T = 4096. The first version, which stages no coefficients,
    still fits 16 and reaches 1.266 at T = 16384 (one row, ring (2, 1))."""
    offsets, n = (-2048, -1, 0, 1, 2048), 2048 * 2048
    settings = list(tkv.ring_settings(offsets, n))
    assert len(settings) == 24 and sum(g.fits for _, g in settings) == 5
    assert [k for k, g in settings if g.fits] == [
        (2, 1, 2048, 1), (2, 1, 2048, 2), (2, 1, 4096, 1), (3, 2, 2048, 1), (4, 3, 2048, 1)]
    ratios = {T: g.staged_per_consumed for (s, q, T, r), g in settings if g.fits}
    assert ratios == {2048: 6400 / 2048, 4096: 8448 / 4096}
    first = [(k, tkv.ring_geometry(offsets, n, k[2], k[3], k[0], k[1], check=False,
                                   route="first")) for k, _ in settings]
    assert sum(g.fits for _, g in first) == 16
    assert [k for k, g in first if g.fits and k[2] == 16384] == [(2, 1, 16384, 1)]
    assert dict(first)[(2, 1, 16384, 1)].staged_per_consumed == 20736 / 16384
    assert tkv.table_ring_rows(offsets, n, 2048, 2) == {(2, 1): 2, (3, 2): 1, (4, 3): 1}


@pytest.mark.parametrize("offsets,ring,T,rows,threads", [
    ((-2048, -1, 0, 1, 2048), (2, 1), 2048, 1, 512),
    ((-2048, -1, 0, 1, 2048), (2, 1), 2048, 2, 512),
    ((-2048, -1, 0, 1, 2048), (4, 3), 2048, 1, 512),
    ((-2048, -1, 0, 1, 2048), (3, 2), 1024, 1, 256),
    ((-64, -1, 0, 1, 64), (2, 1), 2048, 1, 256),
    ((-64, -1, 0, 1, 64), (3, 2), 2048, 1, 256),
    ((-64, -1, 0, 1, 64), (4, 3), 2048, 1, 512),
    ((-64, -1, 0, 1, 64), (4, 3), 1024, 2, 256),
])
def test_ring_threads_fill_the_sm(offsets, ring, T, rows, threads):
    """The bulk body's threads all compute: where its shared memory (the
    ring and the coefficient tiles) leaves one block an SM (two would need
    more than 228 KB with the 1 KB each block keeps back) a block takes 512
    threads, else 256; the first version, whose threads stage, keeps 256 at
    every setting."""
    n = 2048 * 2048
    g = tkv.ring_geometry(offsets, n, T, rows, *ring)
    assert g.threads == threads
    assert (2 * (g.smem_bytes + 1024) <= 233_472) == (threads == 256)
    assert tkv.ring_geometry(offsets, n + 1, T, rows, *ring).threads == 256


@pytest.mark.parametrize("n,T,walkers,tpc", [(4194304, 2048, 264, 8), (4194304, 16384, 132, 2),
                                             (2116, 256, 1000, 1), (2116, 256, 3, 3),
                                             (40000, 16384, 5, 1)])
def test_ring_tiles_per_chunk(n, T, walkers, tpc):
    """A row group's tiles are dealt to at most one block a tile, in
    chunks of consecutive tiles that cover them all."""
    g = tkv.ring_geometry((-1, 0, 1), n, T, 1, 2, 1, check=False)
    assert g.tiles_per_chunk(n, walkers) == tpc
    ntiles = -(-n // T)
    assert -(-ntiles // tpc) <= min(walkers, ntiles)


def test_ring_geometry_refuses_bad_rings():
    for s, q in ((2, 2), (1, 1), (5, 4), (3, 0)):
        with pytest.raises(ValueError, match="depth < nslots"):
            tkv.ring_geometry((-1, 0, 1), 1024, 256, 1, s, q)
    with pytest.raises(ValueError, match="multiple of 4"):
        tkv.ring_geometry((-1, 0, 1), 1024, 254, 1, 2, 1)


# the table's operand: the 2D N=2048 Laplacian
TABLE_OFFSETS, TABLE_N = (-2048, -1, 0, 1, 2048), 2048 * 2048


@pytest.mark.parametrize("variant,tiles", [("c", tkv.C_TILES), ("d", tkv.D_TILES)])
def test_stage_geometry_fits_or_refuses(variant, tiles):
    """Every setting of the staged C's and D's sweeps either fits a block's
    227 KB (232,448 bytes: the X slots, two (5, T) coefficient tiles and the
    bulk body's barriers) or is refused with ``ValueError`` before any
    launch; ``stage_settings`` lists them all in order."""
    settings = list(tkv.stage_settings(variant, TABLE_OFFSETS, TABLE_N))
    assert [k for k, _ in settings] == [(T, r) for T in tiles for r in tkv.STAGE_ROWS]
    bars = {"c": 32, "d": 96}[variant]
    for (T, rows), g in settings:
        slots, W = (2, T + 2 * 2048) if variant == "c" else (4, T)
        assert g.dynamic_bytes == (slots * rows * W + 2 * 5 * T) * 4
        assert g.smem_bytes == g.dynamic_bytes + bars
        assert g.fits == (g.smem_bytes <= 232_448)
        assert (g.route, g.width) == ("bulk", 4)
        assert g.threads == (256 if 2 * (g.smem_bytes + 1024) <= 233_472 else 512)
        if g.fits:
            assert tkv.stage_geometry(variant, TABLE_OFFSETS, TABLE_N, T, rows) == g
        else:
            with pytest.raises(ValueError, match="shared memory"):
                tkv.stage_geometry(variant, TABLE_OFFSETS, TABLE_N, T, rows)


def test_stage_sweeps_fit_ten_settings():
    """On the table's operand the halo of 2048 and the coefficient tiles
    leave C six settings of twelve and D four of eight, none at 8 rows:
    C's window re-reads (T + 2H) / T = 5, 3 and 2 times X at T = 1024, 2048
    and 4096; D stages 1 + 2 / (tiles a chunk)."""
    c = [k for k, g in tkv.stage_settings("c", TABLE_OFFSETS, TABLE_N) if g.fits]
    d = [k for k, g in tkv.stage_settings("d", TABLE_OFFSETS, TABLE_N) if g.fits]
    assert c == [(1024, 1), (1024, 2), (1024, 4), (2048, 1), (2048, 2), (4096, 1)]
    assert d == [(2048, 1), (2048, 2), (2048, 4), (4096, 1)]
    ratios = {T: g.staged_per_consumed() for (T, r), g in
              tkv.stage_settings("c", TABLE_OFFSETS, TABLE_N)}
    assert ratios == {1024: 5.0, 2048: 3.0, 4096: 2.0}
    g = tkv.stage_geometry("d", TABLE_OFFSETS, TABLE_N, 2048, 2)
    assert g.staged_per_consumed(8) == 1.25 and g.staged_per_consumed(1) == 3.0
    # 2048 tiles dealt to 264 walkers a row group: 8 tiles a chunk
    assert g.tiles_per_chunk(TABLE_N, 264) == 8 and g.halo == 2048


@pytest.mark.parametrize("N,T,halo,window", [(45, 256, 64, 384), (46, 1024, 64, 1152),
                                             (200, 2048, 224, 2496), (20, 64, 32, 128)])
def test_stage_geometry_c_halo(N, T, halo, window):
    """C's halo is max|off| rounded up to 32 (at least 32), its window
    T + 2H, the same H the first version takes."""
    g = tkv.stage_geometry("c", (-N, -1, 0, 1, N), N * N, T, 2)
    assert (g.halo, g.window, g.slots) == (halo, window, 2)
    assert g.staged_per_consumed() == window / T


def test_stage_geometry_refuses():
    with pytest.raises(ValueError, match="exceeds the tile"):
        tkv.stage_geometry("d", (-64, -1, 0, 1, 64), 4096, 32, 1)
    with pytest.raises(ValueError, match="multiple of 4"):
        tkv.stage_geometry("c", (-1, 0, 1), 4096, 254, 1)
    with pytest.raises(ValueError, match="variant"):
        tkv.stage_geometry("b", (-1, 0, 1), 4096, 256, 1)
    with pytest.raises(ValueError, match="shared memory"):
        tkv.stage_geometry("c", TABLE_OFFSETS, TABLE_N, 4096, 2)


# (offsets, n, tile, width): the 2D and 3D stencils whose far offsets are
# multiples of 4 take 4 on the 16-byte grid and a tile on 128; offsets off
# 4, odd n, n = 2 mod 4, a tile off 128, three or nine diagonals, and a
# stencil whose middle is not (-1, 0, 1) take 1
WIDTH_CASES = [
    ((-2048, -1, 0, 1, 2048), 2048 * 2048, 2048, 4),
    ((-2048, -1, 0, 1, 2048), 2048 * 2048, 4096, 4),
    ((-48, -1, 0, 1, 48), 2304, 2560, 4),
    ((-46656, -216, -1, 0, 1, 216, 46656), 216**3, 2048, 4),
    ((-46, -1, 0, 1, 46), 2116, 256, 1),
    ((-45, -1, 0, 1, 45), 2025, 256, 1),
    ((-48, -1, 0, 1, 48), 2306, 256, 1),
    ((-48, -1, 0, 1, 48), 2304, 192, 1),
    ((-1, 0, 1), 4096, 256, 1),
    ((-8, -4, -2, -1, 0, 1, 2, 4, 8), 4096, 256, 1),
    ((-8, -2, 0, 2, 8), 4096, 256, 1),
]


@pytest.mark.parametrize("offsets,n,tile,width", WIDTH_CASES)
def test_stage_width_rule(offsets, n, tile, width):
    """The staged body's columns a thread: K1's rule for 4
    (``dia_vector_width`` on 16-byte aligned f32 operands) and a tile on
    128; the route: bulk copies on the 16-byte grid, cp.async off it, width
    1 there."""
    from dune_eigensolver_tpu_torch.kernels.dia_spmm import dia_vector_width

    assert tkv.stage_width(offsets, n, tile) == width
    if tile % 128 == 0:
        assert (width == 4) == (dia_vector_width(offsets, n, torch.float32) == 4)
    route = tkv.stage_route(n)
    assert route == ("bulk" if n % 4 == 0 else "async")
    for variant in ("c", "d"):
        if variant == "d" and max(abs(o) for o in offsets) > tile:
            continue
        g = tkv.stage_geometry(variant, offsets, n, tile, 1, check=False)
        assert (g.route, g.width) == (route, width if route == "bulk" else 1)


def test_variant_steps_pair_each_variant_with_its_first_version():
    """The table times each staged variant in turns with its first version
    at the same setting; B's rings take the rows ``table_ring_rows`` gives
    them."""
    steps = tkv.variant_steps(2048, 2, {(3, 2): 1})
    assert [label for label, _, _ in steps] == [
        "A shipped", "D rolling", "D in-place", "B s=2 d=1", "B s=3 d=2", "B s=4 d=3",
        "C r1-style"]
    assert steps[0][2] is None and all(first is not None for _, _, first in steps[1:])


@pytest.mark.parametrize("T", [256, 512])
def test_jax_copy_probes_equal_port_plain_versions(interpret, T):
    """One f32 add per element on both sides: exact."""
    rng = np.random.default_rng(T)
    x = rng.standard_normal((8, 2048)).astype(np.float32)
    d = rng.standard_normal((5, 2048)).astype(np.float32)
    xt, dt = torch.from_numpy(x), torch.from_numpy(d)
    assert np.array_equal(np.asarray(jpp.pallas_ident(T, jnp.asarray(x))),
                          tpp.ident_reference(xt).numpy())
    assert np.array_equal(np.asarray(jpp.pallas_identd(T, jnp.asarray(d), jnp.asarray(x))),
                          tpp.identd_reference(dt, xt).numpy())


def test_kernel_wrappers_refuse_cpu_tensors():
    """No fallback: on a CPU tensor every kernel wrapper raises, before
    anything is built; only the ``main``s choose the plain version."""
    _, At, X = _dia_case(12, 8, seed=0)
    Xt = torch.from_numpy(X)
    for fn in (tkv.spmm_c, tkv.spmm_b, tkv.spmm_d, *tkv.FIRST_VERSIONS.values()):
        with pytest.raises(ValueError, match="CUDA"):
            fn(At, Xt)
        assert fn.launches == 0
    assert sum(tkv.spmm_b.taken.values()) == 0
    assert sum(tkv.spmm_c.taken.values()) == sum(tkv.spmm_d.taken.values()) == 0
    assert tkv.FIRST_VERSIONS == {"spmm_b": tkv.spmm_b_first, "spmm_c": tkv.spmm_c_first,
                                  "spmm_d": tkv.spmm_d_first}
    for fn in (tkv.spmm_d, tkv.spmm_d_first):
        with pytest.raises(ValueError, match="CUDA"):
            fn(At, Xt, alias=True)
    with pytest.raises(ValueError, match="CUDA"):
        tpp.ident(256, Xt)
    with pytest.raises(ValueError, match="CUDA"):
        tpp.ident_alias(256, Xt)
    with pytest.raises(ValueError, match="CUDA"):
        tpp.identd(256, Xt[:5].contiguous(), Xt)
    assert tpp.ident.launches == tpp.identd.launches == tpp.ident_alias.launches == 0


def test_first_wrappers_refuse_cpu_tensors():
    """The first versions of the two Y = X + 1 launches are kernel wrappers
    too: on a CPU tensor each raises before anything is built, and nothing
    is counted."""
    Xt = torch.from_numpy(np.ones((8, 256), np.float32))
    for fn in (tpp.ident_first, tpp.ident_alias_first):
        with pytest.raises(ValueError, match="CUDA"):
            fn(256, Xt)
        assert fn.launches == 0 and fn.body is None
    assert tpp.FIRST_VERSIONS == {"ident": tpp.ident_first, "ident_alias": tpp.ident_alias_first}


# (width, tile, align, body): the copy kernel's choice between its bulk
# copies and its first version, which takes any shape
COPY_BODY_CASES = [
    (4259840, 16384, 16, "bulk"),   # the timed multivector, aligned
    (4259840, 1024, 256, "bulk"),   # more than 16 bytes of alignment is 16
    (4100, 1000, 16, "bulk"),       # a tile that does not divide the width
    (2052, 512, 16, "bulk"),        # a last tile that is not full
    (100003, 1000, 16, "first"),    # an odd width
    (4096, 1022, 16, "first"),      # a tile off the 16-byte grid
    (4096, 1024, 8, "first"),       # a view 8 bytes off
    (4096, 1024, 4, "first"),       # a view one float off
]


@pytest.mark.parametrize("width,tile,align,body", COPY_BODY_CASES)
def test_copy_body(width, tile, align, body):
    """The copy kernel's chooser, from shape, tile and alignment alone (the
    launcher refuses the bulk body elsewhere)."""
    assert tpp.copy_body(width, tile, align) == body


def test_copy_bodies_are_the_launchers_flags():
    """Each body of Y = X + 1 has its own flag of ``copy_add1_launch``, and
    the chooser picks each of them at some shape."""
    assert tpp.BODIES == {"first": 0, "bulk": 1}
    picked = {tpp.copy_body(w, t, a) for w, t, a, _ in COPY_BODY_CASES}
    assert picked == set(tpp.BODIES)


@pytest.mark.parametrize("n", [2, 3])
def test_in_turns_times_forth_and_back(n):
    """``in_turns`` times each function twice, in the order given and then
    reversed (kernel, first, first, kernel for two), and returns the best
    of each in the order given."""
    from dune_eigensolver_tpu_torch.bench.timing import in_turns

    fns = [f"f{i}" for i in range(n)]
    calls = []
    clock = iter([5.0, 7.0, 9.0, 4.0, 6.0, 8.0][: 2 * n])

    def time_fn(fn):
        calls.append(fn)
        return next(clock)

    times = in_turns(fns, time_fn)
    assert calls == fns + fns[::-1]
    stamps = [5.0, 7.0, 9.0, 4.0, 6.0, 8.0][: 2 * n]
    want = [min(stamps[i], stamps[2 * n - 1 - i]) for i in range(n)]
    assert times == want


def test_copy_table_rows_on_cpu():
    """On the CPU the copy table times the library's copies and the plain
    versions only: no first-version row, whose turns run on the card."""
    rows = list(tpp.copy_table("cpu", T=1024, width=8192, mb=1))
    kinds = {label: kind for label, _, _, kind in rows}
    assert set(kinds.values()) == {"library", "plain"}
    assert [label for label, kind in kinds.items() if kind == "plain"] == [
        "ident", "ident+d T=1024", "ident ALIASED T=1024"]
    assert all(t > 0 and g > 0 for _, t, g, _ in rows)


# what ``cuobjdump -sass`` prints for two kernels of a library (cut short)
SASS_DUMP = """
Fatbin elf code:
================
arch = sm_90a
code version = [1,8]

\tcode for sm_90a
\t\tFunction : _Z19copy_add_row_kernelILb1ELb1EEvPKfS1_Pfixiiy
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0080*/                   LDG.E.EF.128 R4, desc[UR4][R2.64] ;
        /*0090*/               @P0 LDG.E.128.CONSTANT R8, desc[UR4][R6.64] ;
        /*00a0*/                   LDGSTS.E [R1], desc[UR4][R2.64] ;
        /*00b0*/                   LDGDEPBAR ;
        /*00c0*/                   STG.E.128 desc[UR4][R2.64], R4 ;
\t\t..........

\t\tFunction : _Z19copy_add_row_kernelILb1ELb0EEvPKfS1_Pfixiiy
        /*0080*/                   LDG.E.128 R4, desc[UR4][R2.64] ;
\t\t..........

\t\tFunction : _Z16copy_add1_kernelILb1EEvPKfPfixi
        /*0080*/                   LDG.E.128 R4, desc[UR4][R2.64] ;
"""


def test_sass_global_loads_counts_ldg_per_kernel(monkeypatch):
    """The SASS check's parser: one entry per kernel whose mangled name holds
    the name asked for, counting the global loads (``LDG``) and not
    cp.async's ``LDGSTS`` or its barrier."""
    from dune_eigensolver_tpu_torch.utils import native

    seen = []

    def sass_text(tool, lib, name):
        seen.append((tool, lib, name))
        return SASS_DUMP

    monkeypatch.setattr(native, "cuobjdump", lambda: "/toolkit/bin/cuobjdump")
    monkeypatch.setattr(native, "_sass_text", sass_text)
    loads = native.sass_global_loads("copy_add_row_kernel", path="lib.so")
    assert loads == {"_Z19copy_add_row_kernelILb1ELb1EEvPKfS1_Pfixiiy": 2,
                     "_Z19copy_add_row_kernelILb1ELb0EEvPKfS1_Pfixiiy": 1}
    assert seen == [("/toolkit/bin/cuobjdump", "lib.so", "copy_add_row_kernel")]
    monkeypatch.setattr(native, "cuobjdump", lambda: None)
    with pytest.raises(RuntimeError, match="cuobjdump not found"):
        native.sass("copy_add_row_kernel", path="lib.so")


def test_coefficient_loads_keys_by_instantiation(monkeypatch):
    """``identd``'s SASS counts by (float4 body, coefficient stream), read
    from the template arguments of the mangled names."""
    from dune_eigensolver_tpu_torch.utils import native

    monkeypatch.setattr(native, "cuobjdump", lambda: "/toolkit/bin/cuobjdump")
    monkeypatch.setattr(native, "_sass_text", lambda tool, lib, name: SASS_DUMP)
    assert tpp.coefficient_loads("lib.so") == {(True, True): 2, (True, False): 1}


#: cuobjdump -sass of K2's body (csrc/ell_body.cuh), a function each for
#: K2 (variant 0 at (8, 9), f32), the three degraded variants, a setting of
#: the sweep and the f64 body; only the first kind count for ``slot_loads``
ELL_SASS_DUMP = """
\t\tFunction : _Z17ell_spmm_t_kernelILi0ELi8ELi9ELi5EfsEvPKT4_PKT5_PKiS2_PS0_iiiiy
        /*0080*/                   LDG.E.CONSTANT R4, desc[UR4][R2.64] ;
        /*0090*/                   LDG.E.S16.CONSTANT R5, desc[UR4][R2.64] ;
        /*00a0*/                   LDG.E.CONSTANT R6, desc[UR4][R8.64] ;
\t\t..........
\t\tFunction : _Z17ell_spmm_t_kernelILi0ELi8ELi9ELi6EfiEvPKT4_PKT5_PKiS2_PS0_iiiiy
        /*0080*/                   LDG.E.CONSTANT R4, desc[UR4][R2.64] ;
        /*0090*/                   LDG.E.CONSTANT R5, desc[UR4][R2.64] ;
\t\t..........
\t\tFunction : _Z17ell_spmm_t_kernelILi1ELi8ELi9ELi5EfsEvPKT4_PKT5_PKiS2_PS0_iiiiy
        /*0080*/                   LDG.E.CONSTANT R4, desc[UR4][R2.64] ;
        /*00a0*/                   LDG.E.CONSTANT R6, desc[UR4][R8.64] ;
\t\t..........
\t\tFunction : _Z17ell_spmm_t_kernelILi3ELi8ELi9ELi6EfiEvPKT4_PKT5_PKiS2_PS0_iiiiy
        /*0080*/                   LDG.E.CONSTANT R4, desc[UR4][R2.64] ;
\t\t..........
\t\tFunction : _Z17ell_spmm_t_kernelILi0ELi4ELi9ELi5EfsEvPKT4_PKT5_PKiS2_PS0_iiiiy
        /*0080*/                   LDG.E.CONSTANT R4, desc[UR4][R2.64] ;
\t\t..........
\t\tFunction : _Z17ell_spmm_t_kernelILi0ELi4ELi9ELi3EdiEvPKT4_PKT5_PKiS2_PS0_iiiiy
        /*0080*/                   LDG.E.64.CONSTANT R4, desc[UR4][R2.64] ;
"""


def test_slot_loads_keys_by_instantiation(monkeypatch):
    """The ablation's SASS counts by (variant, index bytes), read from the
    template arguments of the mangled names: K2's setting (8, 9) in f32
    alone, not the sweep's other settings or the f64 body."""
    from dune_eigensolver_tpu_torch.experiments import gather_ablate as ga
    from dune_eigensolver_tpu_torch.utils import native

    seen = []
    monkeypatch.setattr(native, "cuobjdump", lambda: "/toolkit/bin/cuobjdump")
    monkeypatch.setattr(native, "_sass_text",
                        lambda tool, lib, name: seen.append(name) or ELL_SASS_DUMP)
    assert ga.slot_loads("lib.so") == {("full", 2): 3, ("full", 4): 2, ("nogather", 2): 2,
                                       ("nofma", 4): 1}
    assert seen == ["ell_spmm_t_kernel"]


@pytest.mark.parametrize("case,faults", [
    ("kept", 0),
    ("index loads gone", 2),   # nogather below K2 at both widths
    ("slot loop gone", 2),     # nofma at its epilogue's 6 at both widths
    ("one width missing", 1),
])
def test_slot_load_rule(case, faults):
    """The rule the card holds the built library to: ``nogather`` exactly
    K2's global loads, ``nofma`` at least two beyond its epilogue's six,
    at each index width; a missing instantiation is a fault too. The counts
    are those of the built library on sm_90a, before and after the repair
    (1,261 for K2, 334 and 6 for the first ``nogather`` and ``nofma``)."""
    from dune_eigensolver_tpu_torch.experiments import gather_ablate as ga

    kept = {("full", 2): 1261, ("full", 4): 1261, ("nogather", 2): 1261, ("nogather", 4): 1261,
            ("nodyn", 2): 1126, ("nodyn", 4): 1126, ("nofma", 2): 65, ("nofma", 4): 65}
    loads = dict(kept)
    if case == "index loads gone":
        loads.update({("nogather", 2): 334, ("nogather", 4): 334})
    elif case == "slot loop gone":
        loads.update({("nofma", 2): 6, ("nofma", 4): 6})
    elif case == "one width missing":
        del loads[("nodyn", 4)]
    found = ga.slot_load_faults(loads)
    assert len(found) == faults, found
    assert ga.NOFMA_EPILOGUE_LOADS == 6
    if case == "kept":  # the rule's edge: two loads beyond the epilogue
        assert ga.slot_load_faults({**loads, ("nofma", 2): 8, ("nofma", 4): 8}) == []
        assert len(ga.slot_load_faults({**loads, ("nofma", 2): 7})) == 1


@pytest.mark.parametrize("index_bytes", [2, 4])
def test_variant_streamed_bytes_counts_slots_to_the_warp_counts(index_bytes):
    """What each ablation body moves, against a hand count on n = 70 rows
    (warps of 32, 32 and 6 rows) whose warp counts are 4, 0 and 5 of k = 5
    slots: 158 slots in all; ``nofma`` reads ``data[i, 0]`` in the empty
    warp too (32 more coefficients); X and Y once at m = 3."""
    from dune_eigensolver_tpu_torch.experiments import gather_ablate as ga

    n, k, m = 70, 5, 3
    own = np.arange(n)
    data = np.zeros((n, k), np.float32)
    cols = np.repeat(own[:, None], k, axis=1)
    data[:32, 0] = 1.0  # warp 0: one entry a row, and row 3 four
    data[3, :4] = 2.0
    cols[3, 1:4] = [10, 20, 30]
    data[66, :] = 3.0  # warp 2: row 66 five
    cols[66, 1:] = [1, 2, 3, 4]
    A = ell_from_numpy(data, cols, (n, n), nnz=int((data != 0).sum()), device="cpu")
    assert A.warp_slots.tolist() == [4, 0, 5]
    slots, xy = 32 * 4 + 6 * 5, m * (n + n)
    want = {"full": 4 * (slots + xy) + index_bytes * slots,
            "nogather": 4 * (slots + xy) + index_bytes * slots,
            "nodyn": 4 * (slots + xy),
            "nofma": 4 * (slots + 32 + xy) + index_bytes * slots}
    for variant in ga.VARIANTS:
        got = ga.variant_streamed_bytes(A, m, variant, index_bytes)
        assert got == want[variant], variant
        assert got >= ga.variant_bytes(A, m, variant, index_bytes) or variant == "full"
    with pytest.raises(ValueError, match="unknown variant"):
        ga.variant_streamed_bytes(A, m, "nothing")


def _asm_load_faults(texts):
    """Inline-asm loads whose value nothing reads, in ``{file: source}``: an
    ``asm volatile("ld.`` whose output is neither read later in its
    function nor returned, or a helper that returns it called as a
    statement of its own. ptxas removes such a load, volatile or not."""
    import re

    faults, helpers = [], []
    for path, text in texts.items():
        for m in re.finditer(r'asm\s+volatile\s*\(\s*"ld\.[^"]*"[^;]*;', text):
            out = re.search(r'"=\w+"\s*\(\s*(\w+)\s*\)', m.group(0))
            heads = [h for h in re.finditer(r"\b(\w+)\s*\([^;{}]*\)\s*\{", text[:m.start()])
                     if h.group(1) not in ("if", "for", "while", "switch")]
            end = text.find("\n}", m.end())
            rest = text[m.end():end if end >= 0 else len(text)]
            where = f"{os.path.basename(path)}:{text.count(chr(10), 0, m.start()) + 1}"
            if out is None or not heads:
                faults.append(f"{where}: an asm load with no output")
            elif re.search(rf"\breturn\s+{out.group(1)}\s*;", rest):
                helpers.append(heads[-1].group(1))
            elif not re.search(rf"\b{out.group(1)}\b", rest):
                faults.append(f"{where}: the value of an asm load is never read")
    for name in set(helpers):
        for path, text in texts.items():
            for c in re.finditer(rf"\b{name}\s*\(", text):
                before = text[:c.start()].rstrip()
                if not before or before[-1] in ";{})" or before.endswith("else"):
                    line = text.count("\n", 0, c.start()) + 1
                    faults.append(f"{os.path.basename(path)}:{line}: {name}'s value dropped")
    return faults


def test_no_discarded_inline_asm_loads_in_the_sources():
    """No source of the port's kernels loads through inline asm without
    reading the value: the fault that left ``identd``'s coefficient rows
    and the ablation's slot loads out of the SASS."""
    from dune_eigensolver_tpu_torch.utils import native

    csrc = os.path.dirname(native._headers()[0])
    texts = {}
    for root, _, files in os.walk(csrc):
        for f in files:
            if f.endswith((".cu", ".cuh", ".h")):
                with open(os.path.join(root, f)) as fh:
                    texts[os.path.join(root, f)] = fh.read()
    assert any(p.endswith("ell_body.cuh") for p in texts)
    assert _asm_load_faults(texts) == []


@pytest.mark.parametrize("body,faults", [
    # a helper that returns the value, called as a statement (the fault)
    ("__device__ float kept(const float* p) {\n  float v;\n"
     '  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));\n  return v;\n}\n'
     "__global__ void k(const float* p, float* y) {\n  kept(p);\n"
     "  for (int j = 0; j < 4; ++j) {\n    if (j) kept(p + j);\n  }\n}\n", 2),
    # the same helper whose value is read
    ("__device__ float kept(const float* p) {\n  float v;\n"
     '  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));\n  return v;\n}\n'
     "__global__ void k(const float* p, float* y) {\n  y[0] = kept(p) + 1.f;\n}\n", 0),
    # a load in the kernel whose register nothing reads, and one that is read
    ("__global__ void k(const float* p, float* y) {\n  float v, w;\n"
     '  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));\n'
     '  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(w) : "l"(p));\n  y[0] = w;\n}\n', 1),
], ids=["helper-dropped", "helper-read", "inline-one-dropped"])
def test_asm_load_scan_finds_dropped_values(body, faults):
    """The source scan flags the forms ptxas removes (the first ``identd``
    and ablation bodies used the first) and passes loads whose value is
    read."""
    assert len(_asm_load_faults({"k.cu": body})) == faults


def test_lib_path_hashes_headers(tmp_path):
    """The library's name changes when a header the sources include
    changes, not only when a source does, so an edited ``bulk_copy.cuh`` is
    never served from a stale build."""
    from dune_eigensolver_tpu_torch.utils import native

    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    (tmp_path / "notes.txt").write_text("not a source\n")
    sources, headers = native._sources(str(tmp_path)), native._headers(str(tmp_path))
    assert [os.path.basename(f) for f in sources] == ["a.cu"]
    assert [os.path.basename(f) for f in headers] == ["h.cuh"]
    before = native._lib_path(sources, headers)
    assert native._lib_path(sources, headers) == before
    (tmp_path / "h.cuh").write_text("// two\n")
    after = native._lib_path(sources, headers)
    assert after != before and os.path.dirname(after) == native.BUILD_DIR
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n// edited\n')
    assert native._lib_path(sources, headers) not in (before, after)
    # the package's own headers are hashed
    assert "bulk_copy.cuh" in [os.path.basename(f) for f in native._headers()]


def test_experiment_mains_on_cpu(capsys):
    """``main`` with ``--device cpu`` times the plain versions at a small
    size and says that no rate is the card's."""
    assert tpp.main(["1024", "--device", "cpu", "--width", "8192", "--mb", "1"]) == 0
    out = capsys.readouterr().out
    assert "device: cpu" in out and "[plain]" in out and "[kernel]" not in out
    for label in ("1d copy 1MB", "1d copy_ 1MB", "2d copy (  8,8192)", "2d copy ( 64,1024)",
                  "ident+d T=1024", "ident ALIASED T=1024"):
        assert label in out, label
    assert tkv.main(["256", "--device", "cpu", "--N", "32", "--mb", "1"]) == 0
    out = capsys.readouterr().out
    assert "device: cpu (plain version only" in out
    assert "copy:" in out and "plain:" in out and "GB/s" in out and "shipped" not in out
    assert tkv.spmm_c.launches == tkv.spmm_b.launches == tkv.spmm_d.launches == 0
    assert all(fn.launches == 0 for fn in tkv.FIRST_VERSIONS.values())


# ---------------------------------------------------------------------------
# Column-layout wrappers
# ---------------------------------------------------------------------------


def _operand(kind, dtype):
    import scipy.sparse as sp

    if kind == "dia":
        J = jproblems.laplacian_dirichlet_2d(20, dtype=dtype)
        return J, dia_from_numpy(np.asarray(J.data), J.offsets, J.shape, device="cpu")
    if kind == "ell":
        S = jproblems.unstructured_laplacian(500, extra_edges=25, seed=3, fmt="scipy")
        J = jformats.ell_from_scipy(sp.csr_matrix(S), dtype=dtype)
        return J, ell_from_numpy(np.asarray(J.data), np.asarray(J.cols), J.shape, J.nnz,
                                 device="cpu")
    J = jproblems.elasticity_2d(9, dtype=dtype)[0]
    return J, bsr_from_numpy(np.asarray(J.bdata), np.asarray(J.bcols), J.shape, J.block, J.nnz,
                             device="cpu")


@pytest.mark.parametrize("kind", ["dia", "ell", "bsr"])
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 1e-5)])
def test_column_layout_spmm(kind, dtype, tol):
    J, T = _operand(kind, dtype)
    X = np.random.default_rng(1).standard_normal((J.shape[1], 8)).astype(dtype)
    Yj = np.asarray(jspmm(J, jnp.asarray(X)))
    Yt = spmm(T, torch.from_numpy(X))
    assert Yt.shape == (J.shape[0], 8) and Yt.dtype == torch.from_numpy(X).dtype
    assert np.abs(Yt.numpy() - Yj).max() <= tol * np.abs(Yj).max()
    named = {"dia": dia_spmm, "ell": ell_spmm, "bsr": bsr_spmm}
    assert torch.equal(named[kind](T, torch.from_numpy(X)), Yt)
    other = "ell" if kind == "dia" else "dia"
    with pytest.raises(TypeError):
        named[other](T, torch.from_numpy(X))
    with pytest.raises(ValueError, match="shape mismatch"):
        spmm(T, torch.from_numpy(X[:-1]))
    with pytest.raises(TypeError):
        spmm(object(), torch.from_numpy(X))


@pytest.mark.parametrize("block", [1, 8])
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 1e-5)])
def test_orthonormalize_blocked_column_layout(block, dtype, tol):
    X = np.random.default_rng(block).standard_normal((700, 16)).astype(dtype)
    Qj = np.asarray(jortho.orthonormalize_blocked(jnp.asarray(X), block=block))
    Qt = tortho.orthonormalize_blocked(torch.from_numpy(X), block=block).numpy()
    assert Qt.shape == X.shape
    assert np.abs(Qt - Qj).max() <= tol * 50  # entries O(1/sqrt(n)); Gram conditioning O(10)
    G = Qt.T.astype(np.float64) @ Qt.astype(np.float64)
    assert np.abs(G - np.eye(16)).max() <= (1e-10 if dtype == np.float64 else 1e-4)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 1e-5)])
def test_dot_products_column_layout(dtype, tol):
    rng = np.random.default_rng(5)
    Q1 = rng.standard_normal((900, 8)).astype(dtype)
    Q2 = rng.standard_normal((900, 8)).astype(dtype)
    t1, t2 = torch.from_numpy(Q1), torch.from_numpy(Q2)
    Gj = np.asarray(jortho.dot_products_all(jnp.asarray(Q1), jnp.asarray(Q2)))
    Gt = tortho.dot_products_all(t1, t2).numpy()
    scale = np.abs(Q1).T @ np.abs(Q2)  # each entry's sum of magnitudes
    assert (np.abs(Gt - Gj) <= tol * scale).all()
    dj = np.asarray(jortho.dot_products_diagonal(jnp.asarray(Q1), jnp.asarray(Q2)))
    dt = tortho.dot_products_diagonal(t1, t2).numpy()
    assert (np.abs(dt - dj) <= tol * np.diag(scale)).all()
    assert np.allclose(dt, np.diag(Gt), rtol=0, atol=float(tol * np.diag(scale).max()))


def test_random_multivector_layouts_agree():
    """Column k of the column layout is row k of the transposed one from
    the same generator state; N(0, 1) entries."""
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    X = random_multivector(g1, 4000, 8, torch.float64, "cpu")
    Xt = random_multivector_t(g2, 4000, 8, torch.float64, "cpu")
    assert X.shape == (4000, 8) and torch.equal(X, Xt.T)
    assert abs(X.mean().item()) < 0.05 and abs(X.std().item() - 1.0) < 0.05
