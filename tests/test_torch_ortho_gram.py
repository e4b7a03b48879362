"""The orthonormalization's tall-skinny products (``ops/ortho.py::
gram_product``, ``kernels/ortho_gram.py``, ``csrc/ortho_gram.cu``).

On the CPU: the helper takes the plain version and counts its calls, the
plain version is ``Y @ X.T`` in the Gram's type, the sweeps' results are the
plain products' bits, the kernel's shape rule, and the error gate
(``bench/ortho_gram.py::GATE``) passing a correctly rounded product and
refusing faulty ones. On the card (``cuda`` marker, skipped without one; no
JAX import, so it runs there with
``python -m pytest --noconftest -m cuda tests/test_torch_ortho_gram.py``):
the kernel at each shape of the benchmark's cells and of the GenEO
flagship, against an f64 Gram within the gate (an entry's error beyond
its own rounding over ``u * sum_k |y_ik x_jk|``, at most the larger of
``GATE`` and cuBLAS's f32 product's), where cuBLAS in TF32, bf16 operands
and a dropped block are refused, bit for bit from launch to launch, on row slices
at their own strides, and one launch a product on the sweeps' path.
"""

import pytest
import torch

from dune_eigensolver_tpu_torch.bench import ortho_gram as bo
from dune_eigensolver_tpu_torch.kernels import ortho_gram as og
from dune_eigensolver_tpu_torch.ops import ortho


def _rows(shape, dtype=torch.float64, device="cpu", seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=dtype, device=device)


# --- the CPU: the plain version and the routing -----------------------------------


@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.float32, None), (torch.float32, torch.float64), (torch.float64, None),
])
def test_reference_is_the_matmul(dtype, out_dtype):
    Y, X = _rows((16, 301), dtype, seed=1), _rows((8, 301), dtype, seed=2)
    C = og.ortho_gram_reference(Y, X, out_dtype)
    dt = out_dtype or dtype
    assert C.dtype == dt and C.shape == (16, 8)
    assert torch.equal(C, Y.to(dt) @ X.to(dt).T)


def test_helper_takes_the_plain_version_on_the_cpu():
    """On CPU rows ``gram_product`` is the plain version, bit for bit, counts
    its call and launches nothing; a row slice goes at its own stride."""
    buf = _rows((24, 517), torch.float32, seed=3)
    calls, launches = ortho.gram_product.calls, og.ortho_gram_cuda.launches
    for Y, X, dt in ((buf[:16], buf[16:24], None), (buf[8:16], buf[8:16], torch.float64),
                     (buf[:8], buf[1:9], None)):
        assert not og.takes(Y, X, dt)
        assert torch.equal(ortho.gram_product(Y, X, dt), og.ortho_gram_reference(Y, X, dt))
    assert ortho.gram_product.calls == calls + 3
    assert og.ortho_gram_cuda.launches == launches


@pytest.mark.parametrize("block,iterations", [(8, 2), (24, 1)])
def test_sweeps_route_every_product_through_the_helper(block, iterations, monkeypatch):
    """Both sweeps make all their Grams and projections through
    ``gram_product``: (m / b) Grams and (m / b - 1) projections a sweep,
    and the result is the plain products' (the sweep before the helper)."""
    m, n = 24, 411
    Xt = _rows((m, n), torch.float64, seed=4)
    seen = []
    plain = og.ortho_gram_reference

    def counted(Y, X, dtype=None):
        seen.append((Y.shape[0], X.shape[0]))
        return plain(Y, X, dtype)

    calls = ortho.gram_product.calls
    monkeypatch.setattr(og, "ortho_gram_reference", counted)
    nb = m // block
    Z, _ = ortho.b_orthonormalize_blocked_t(lambda V: 2.0 * V, Xt, block=block,
                                            iterations=iterations)
    assert len(seen) == iterations * (2 * nb - 1)
    assert sorted(set(seen)) == sorted({(block, block)} | {(k, block)
                                                           for k in range(block, m, block)})
    seen.clear()
    W = ortho.orthonormalize_blocked_t(Xt, block=block, iterations=iterations)
    assert len(seen) == iterations * (2 * nb - 1)
    assert ortho.gram_product.calls == calls + 2 * len(seen)
    monkeypatch.undo()
    # the sweep written with the plain products is the same bits
    for sweep, args in ((ortho.b_orthonormalize_blocked_t, (lambda V: 2.0 * V,)),
                        (ortho.orthonormalize_blocked_t, ())):
        monkeypatch.setattr(ortho, "gram_product", lambda Y, X, dtype=None: (
            Y.to(dtype or Y.dtype) @ X.to(dtype or Y.dtype).T))
        again = sweep(*args, Xt, block=block, iterations=iterations)
        monkeypatch.undo()
        got = Z if args else W
        assert torch.equal(again[0] if args else again, got)


@pytest.mark.parametrize("a,b,dtype,out_dtype,fits", [
    (8, 8, torch.float32, torch.float32, True),      # elasticity's Gram
    (16, 8, torch.float32, torch.float32, True),     # its second projection
    (24, 24, torch.float32, torch.float32, True),    # the north star's Gram
    (48, 24, torch.float32, torch.float32, True),    # its second projection
    (120, 8, torch.float32, torch.float32, True),    # the flagship's last projection
    (160, 8, torch.float32, torch.float32, True),    # 20 tiles
    (168, 8, torch.float32, torch.float32, False),   # 21
    (72, 72, torch.float32, torch.float64, False),   # ortho_block='full'
    (16, 8, torch.float32, torch.float64, False),    # an f64 Gram
    (16, 16, torch.float64, torch.float64, False),   # f64 rows
    (8, 8, torch.bfloat16, torch.bfloat16, False),
    (8, 8, torch.float64, torch.float32, False),
])
def test_the_kernels_shape_rule(a, b, dtype, out_dtype, fits):
    assert og.fits(a, b, 522_242, dtype, out_dtype) is fits


def test_short_rows_stay_with_cublas():
    """Below ``MIN_N`` the kernel's fixed cost loses to cuBLAS's one launch."""
    f32 = torch.float32
    assert og.MIN_N > 1
    assert not og.fits(8, 8, og.MIN_N - 1, f32, f32)
    assert og.fits(8, 8, og.MIN_N, f32, f32) and og.fits(120, 8, og.MIN_N, f32, f32)
    assert og.MIN_N <= 157_464  # the north star's coarsest level takes the kernel


def _tf32_rounded(t):
    """``t`` (f32) rounded to TF32's 10-bit mantissa, to nearest."""
    bits = t.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("a,b,gram", [(8, 8, False), (8, 8, True), (16, 8, False),
                                      (24, 24, True), (48, 24, False)])
def test_the_gate_refuses_faulty_products(a, b, gram):
    """``bench/ortho_gram.py``'s gate on the CPU, at n = 100,003, against
    the CPU's f32 product as the library's: the exact product rounded once
    to f32 reads 0; the products of TF32-rounded and bf16-rounded operands
    and the exact product short one block's columns (of 264) are refused,
    each by a wide margin."""
    n = 100_003
    Y = _rows((a, n), torch.float32, seed=a + 50)
    X = Y if gram else _rows((b, n), torch.float32, seed=b + 60)
    exact = Y.double() @ X.double().T
    assert bo.error_ratio(exact.float(), Y, X) == 0
    limit = bo.gate(bo.error_ratio(Y @ X.T, Y, X))
    faulty = {
        "tf32": _tf32_rounded(Y).double() @ _tf32_rounded(X).double().T,
        "bf16": Y.bfloat16().double() @ X.bfloat16().double().T,
        "dropped": bo.dropped_block(Y, X),
    }
    for name, C in faulty.items():
        assert bo.error_ratio(C.float(), Y, X) > 4 * limit, name


def test_the_helper_counts_on_the_cpu_only_calls():
    """No CPU product moves the launch counter, so ``ortho.gram_pct`` reads 0
    where a solve runs on the CPU."""
    launches = og.ortho_gram_cuda.launches
    X = _rows((16, 64), torch.float32, seed=5)
    ortho.orthonormalize_blocked_t(X, block=8)
    assert og.ortho_gram_cuda.launches == launches


# --- the card -----------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _check(Y, X, controls=False):
    """The kernel's C against the f64 Gram, entry by entry, within the gate
    (cuBLAS's f32 product the library's), and the same bits from a second
    launch; with ``controls``, cuBLAS in TF32, bf16 operands and a dropped
    block each refused by the gate. Returns C."""
    launches = og.ortho_gram_cuda.launches
    C = og.ortho_gram_cuda(Y, X)
    assert og.ortho_gram_cuda.launches == launches + 1
    assert C.dtype == torch.float32 and C.shape == (Y.shape[0], X.shape[0])
    assert C.is_contiguous()
    exact = Y.double() @ X.double().T
    scale = Y.double().abs() @ X.double().abs().T
    ratio = bo.error_ratio(C, Y, X, exact, scale)
    limit = bo.gate(bo.error_ratio(Y @ X.T, Y, X, exact, scale))
    assert ratio <= limit, f"{ratio:.3g} of u sum |y x| > the gate {limit:.3g}"
    if controls:
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = Y @ X.T
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        for name, F in (("tf32", tf32), ("bf16", Y.bfloat16().float() @ X.bfloat16().float().T),
                        ("dropped", bo.dropped_block(Y, X))):
            assert bo.error_ratio(F, Y, X, exact, scale) > limit, name
    again = og.ortho_gram_cuda(Y, X)
    assert torch.equal(C, again)  # a fixed order: the same bits every launch
    return C


@pytest.mark.cuda
@pytest.mark.parametrize("a,b,gram", [(8, 8, False), (8, 8, True), (16, 8, False)])
def test_elasticity_shapes_on_an_odd_row_start(cuda, a, b, gram):
    """The elasticity cell's products at n = 522,242: every other row starts
    off 16 bytes, so the copies take 8 bytes; Y and X are slices of one
    buffer starting at an odd row, as ``bufp[:k]`` and ``Xt[k:k+b]`` are, or
    one slice's Gram with itself."""
    n = 522_242
    buf = _rows((a + b + 1, n), torch.float32, cuda, seed=a)
    Y = buf[1:1 + a]
    X = Y if gram else buf[1 + a:1 + a + b]
    C = _check(Y, X, controls=True)
    assert torch.equal(C, og.ortho_gram_cuda(Y.clone(), X.clone()))  # strides change no bit


@pytest.mark.cuda
@pytest.mark.parametrize("n", [157_464, 1_259_712, 10_077_696])
@pytest.mark.parametrize("a,b,gram", [(24, 24, True), (24, 24, False), (48, 24, False)])
def test_north_star_shapes(cuda, n, a, b, gram):
    """The north star's Grams (a block with itself: B is the identity) and
    projections on its three levels (54^3, 108^3, 216^3): 16-byte copies."""
    buf = _rows((72, n), torch.float32, cuda, seed=n % 97)
    Y = buf[:a]
    _check(Y, Y if gram else buf[48:72], controls=True)
    del buf, Y
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_flagship_products(cuda):
    """The GenEO flagship's (8, 8) and (120, 8) at n = 18,050: 15 tiles."""
    buf = _rows((128, 18_050), torch.float32, cuda, seed=7)
    _check(buf[:8], buf[120:], controls=True)
    _check(buf[:120], buf[120:], controls=True)


@pytest.mark.cuda
@pytest.mark.parametrize("a,b,extra", [
    (13, 5, 1),     # partial tiles, n odd: 4-byte copies
    (1, 1, 0),
    (3, 40, 77),    # a last chunk mostly past n
    (160, 8, 2),    # 20 tiles, one warp each
])
def test_other_shapes(cuda, a, b, extra):
    n = og.MIN_N + extra
    _check(_rows((a, n), torch.float32, cuda, seed=a), _rows((b, n), torch.float32, cuda,
                                                               seed=b + 100))


@pytest.mark.cuda
def test_the_wrapper_refuses_what_it_does_not_take(cuda):
    n = og.MIN_N
    Y = _rows((8, n), torch.float32, cuda)
    for args in ((Y.T.contiguous().T, Y),                      # rows not contiguous
                 (_rows((168, n), torch.float32, cuda), Y),     # 21 tiles
                 (Y, Y, torch.float64),                         # an f64 Gram
                 (Y.double(), Y.double()),                      # f64 rows
                 (Y, Y.double()),
                 (Y[:, :n - 1], Y[:, :n - 1])):                 # rows shorter than MIN_N
        with pytest.raises(ValueError):
            og.ortho_gram_cuda(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("m,block,n", [(24, 8, 522_242), (72, 24, 157_464)])
def test_the_sweep_launches_the_kernel_for_every_product(cuda, m, block, n):
    """The cells' sweeps on the card: one launch a ``gram_product`` call, and
    the result as B-orthonormal as with cuBLAS's products."""
    Xt = _rows((m, n), torch.float32, cuda, seed=m)
    calls, launches = ortho.gram_product.calls, og.ortho_gram_cuda.launches
    Z, _ = ortho.b_orthonormalize_blocked_t(lambda V: 2.0 * V, Xt, block=block, iterations=2)
    made = ortho.gram_product.calls - calls
    assert made == 2 * (2 * (m // block) - 1)
    assert og.ortho_gram_cuda.launches - launches == made
    G = 2.0 * (Z.double() @ Z.double().T)
    assert (G - torch.eye(m, dtype=torch.float64, device=cuda)).abs().max().item() < 1e-5


@pytest.mark.cuda
def test_shapes_in_turns(cuda):
    """Products of other shapes, and so other shared memory, in turns: each
    launch after a larger or a smaller one still runs (the kernel keeps the
    shared memory it opted in to for every later launch)."""
    buf = _rows((72, 522_242), torch.float32, cuda, seed=11)
    for a, b in ((16, 8), (8, 8), (48, 24), (8, 8), (24, 24), (16, 8)):
        _check(buf[:a], buf[a:a + b])
