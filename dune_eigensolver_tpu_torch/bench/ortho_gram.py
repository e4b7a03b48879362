"""Device time and error of the orthonormalization's tall-skinny products as
one hand-written kernel (``kernels/ortho_gram.py``) beside cuBLAS's, at the
shapes of the benchmark's cells and of the GenEO flagship.

    python -m dune_eigensolver_tpu_torch.bench.ortho_gram [--out FILE] [--crossover]

On the card only. Each shape is a product ``C = Y X^T`` of two row slices
of one seeded f32 buffer, as the block sweep takes them (``bufp[:k]``,
``Xt[k:k+b]``), or a block's Gram with itself (``gram``: Y = X, as the north
star's ``Xk @ Xk.T``, whose diagonal is a sum of squares): the elasticity
cell's (8, 8) and (16, 8) at n = 522,242 on an odd row start, the north
star's (24, 24) and (48, 24) on its three levels, and the flagship's (8, 8)
and (120, 8). ``route`` is what ``gram_product`` takes there (``kernel`` or
``plain``, by ``ortho_gram.takes``).

Error: ``error_ratio``, an entry's largest error against the f64 Gram
beyond its own rounding to f32, over ``u * sum_k |y_ik x_jk|`` (u = 2^-24):
the kernel's (``ratio``) held to ``gate(plain_ratio)``, the larger of
``GATE`` and the plain version's (``plain_ratio``); and three faulty
products that the gate must refuse: cuBLAS with TF32 (``tf32_ratio``), bf16
operands (``bf16_ratio``) and the exact Gram less the columns one block of
264 would add (``dropped_ratio``). The kernel's bits equal from launch to launch.

Time: in turns, the kernel's device time by CUDA-graph replay, the plain
version's (``Y @ X.T``, one ``torch.matmul``: cuBLAS, TF32 off, so also the
library's yardstick) and a split-n cuBLAS (``split_ms``: one batched GEMM
over p chunks of n and a sum over them, the best p of ``SPLITS``); the
kernel's launched in place (a loop of launches between two events).
``bytes`` is the least the product moves, Y and X read once; ``bound_ms``
over 3.35 TB/s, ``copy_bound_ms`` over the card's copy rate measured first
(``copy_gbps``: ``v + 1.0`` on 256 MB, ``bench/timing.py::copy_rate``).
``--crossover`` adds the kernel and the plain version by replay at short n
(``CROSSOVER``), where ``ortho_gram.MIN_N`` comes from. One JSON line a
shape, on stdout and appended to ``--out``; the first names the card and its
power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess

import torch

#: (cell, a, b, n, first row of Y in its buffer, Y = X)
SHAPES = (
    ("elast2d-512", 8, 8, 522_242, 1, False),
    ("elast2d-512", 8, 8, 522_242, 1, True),
    ("elast2d-512", 16, 8, 522_242, 1, False),
    ("lap3d-216-ns 54^3", 24, 24, 157_464, 0, True),
    ("lap3d-216-ns 54^3", 48, 24, 157_464, 0, False),
    ("lap3d-216-ns 108^3", 24, 24, 1_259_712, 0, True),
    ("lap3d-216-ns 108^3", 48, 24, 1_259_712, 0, False),
    ("lap3d-216-ns 216^3", 24, 24, 10_077_696, 0, True),
    ("lap3d-216-ns 216^3", 24, 24, 10_077_696, 0, False),
    ("lap3d-216-ns 216^3", 48, 24, 10_077_696, 0, False),
    ("flagship elast2d-96", 8, 8, 18_050, 0, False),
    ("flagship elast2d-96", 120, 8, 18_050, 0, False),
)

#: (a, b) and the short n at which ``--crossover`` times both versions
CROSSOVER = ((8, 8), (16, 8), (24, 24), (48, 24), (120, 8))
CROSSOVER_N = (8_192, 18_050, 32_768, 65_536, 131_072)

#: the chunks of n the split-n cuBLAS tries
SPLITS = (33, 132, 264)

#: the gate on ``error_ratio``: a product passes where it reads at most
#: ``gate(plain_ratio)``, the larger of GATE and cuBLAS's f32 product's own
#: reading on the same operands: no less accurate than the library product
#: it replaces, or within u sum |y x|. A sum of n products in any order with
#: a tree of depth d is within d u sum |y x| of the exact one, before the
#: result's own rounding to f32 (up to u |C|, which ``error_ratio`` leaves
#: out). Off the diagonal, rounding errors of random sign leave f32 sums far
#: below 1 (the kernel 0.009-0.036, cuBLAS 0.05-0.13 at the cells' shapes,
#: H100); on a Gram's diagonal (a sum of squares) they add up (the kernel
#: 0.29-2.55, cuBLAS 4.2-23.9). A product rounded to TF32 (7.8 or more) or
#: bf16 (59 or more), or short one block's columns (1,700 or more), fails it
#: (``measure``'s faulty products; tests/test_torch_ortho_gram.py).
GATE = 1.0


def gate(plain_ratio: float) -> float:
    """The largest ``error_ratio`` a product passes where cuBLAS's f32
    product reads ``plain_ratio``."""
    return max(GATE, plain_ratio)


#: the unit roundoff of f32
U32 = 2.0**-24


def error_ratio(C: torch.Tensor, Y: torch.Tensor, X: torch.Tensor, exact=None,
                scale=None) -> float:
    """The largest error of an f32 entry of C beyond its own rounding to f32,
    over u sum_k |y_ik x_jk|: max over (i, j) of (|C_ij - (Y X^T)_ij| - ulp(C_ij)
    / 2)+ / (u sum_k |y_ik x_jk|), the exact product in f64 (``exact`` and
    ``scale``, the f64 ``Y X^T`` and ``|Y| |X|^T``, where the caller has
    them). A correctly rounded C reads 0."""
    if exact is None:
        exact = Y.double() @ X.double().T
    if scale is None:
        scale = Y.double().abs() @ X.double().abs().T
    C = C.double()
    half_ulp = torch.ldexp(torch.ones_like(C), torch.frexp(C).exponent - 25)
    beyond = ((C - exact).abs() - half_ulp).clamp(min=0)
    return (beyond / (U32 * scale)).max().item()


def dropped_block(Y: torch.Tensor, X: torch.Tensor, blocks: int = 264,
                  cols: int = 1024) -> torch.Tensor:
    """The exact product, in f32, less the columns of the chunks that block
    0 of ``blocks`` would take (chunks of ``cols`` columns, grid-strided): a
    kernel that lost one block's partial sum."""
    n = Y.shape[1]
    keep = torch.ones(n, dtype=torch.bool, device=Y.device)
    for c0 in range(0, n, blocks * cols):
        keep[c0:c0 + cols] = False
    return (Y.double()[:, keep] @ X.double()[:, keep].T).float()


def split_gemm(Y: torch.Tensor, X: torch.Tensor, p: int) -> torch.Tensor:
    """``Y @ X.T`` as one batched cuBLAS GEMM over p chunks of n (views at
    the rows' own strides) and a sum over the chunks, the n % p last columns
    by one more GEMM."""
    n = Y.shape[1]
    c = n // p
    Yc = Y[:, :p * c].unflatten(1, (p, c)).transpose(0, 1)   # (p, a, c)
    Xc = X[:, :p * c].unflatten(1, (p, c)).permute(1, 2, 0)  # (p, c, b)
    C = torch.bmm(Yc, Xc).sum(0)
    if p * c < n:
        C = C + Y[:, p * c:] @ X[:, p * c:].T
    return C


def _emit(out, rec):
    line = json.dumps(rec)
    print(line, flush=True)
    if out:
        with open(out, "a") as fh:
            fh.write(line + "\n")


def _card():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"


def _inplace_ms(fn, calls=20):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def _operands(dev, a, b, n, row0, gram):
    g = torch.Generator(device=dev).manual_seed(a * 1000 + n % 1000)
    buf = torch.randn((row0 + a + (0 if gram else b), n), generator=g, device=dev)
    Y = buf[row0:row0 + a]
    return Y, (Y if gram else buf[row0 + a:row0 + a + b])


@contextlib.contextmanager
def _tf32():
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def measure(shapes=SHAPES, copy_gbps=None, splits=SPLITS):
    """The records described above, one a shape of ``shapes``; the split-n
    cuBLAS at each p of ``splits`` (none: no ``split_ms``)."""
    from dune_eigensolver_tpu_torch.bench.timing import copy_rate, in_turns, replay_ms
    from dune_eigensolver_tpu_torch.kernels import ortho_gram as og

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    if copy_gbps is None:
        copy_gbps = copy_rate(dev)
    recs = []
    for cell, a, b, n, row0, gram in shapes:
        Y, X = _operands(dev, a, b, n, row0, gram)
        exact = Y.double() @ X.double().T
        scale = Y.double().abs() @ X.double().abs().T

        def ratio(C):
            return error_ratio(C, Y, X, exact, scale)

        def plain():
            return og.ortho_gram_reference(Y, X)

        with _tf32():
            tf32 = ratio(Y @ X.T)
        rec = {"cell": cell, "a": a, "b": b, "n": n, "row0": row0, "gram": gram,
               "dtype": "float32", "route": "kernel" if og.takes(Y, X) else "plain",
               "plain_ratio": ratio(plain()), "tf32_ratio": tf32,
               "bf16_ratio": ratio(Y.bfloat16().float() @ X.bfloat16().float().T),
               "dropped_ratio": ratio(dropped_block(Y, X))}
        fns = [plain] + [lambda p=p: split_gemm(Y, X, p) for p in splits]
        if rec["route"] == "kernel":
            def kernel():
                return og.ortho_gram_cuda(Y, X)

            C, C2 = kernel(), kernel()
            rec.update(ratio=ratio(C), equal_bits=bool(torch.equal(C, C2)))
            times = in_turns([kernel] + fns, replay_ms)
            rec.update(replay_ms=times.pop(0),
                       inplace_ms=min(_inplace_ms(kernel) for _ in range(2)))
        else:
            times = in_turns(fns, replay_ms)
        rec["plain_ms"] = times.pop(0)
        if splits:
            best = min(range(len(splits)), key=times.__getitem__)
            rec.update(split_ms=times[best], split_p=splits[best],
                       split_ratio=ratio(split_gemm(Y, X, splits[best])))
        nbytes = (a + (0 if gram else b)) * n * 4
        rec.update(bytes=nbytes, bound_ms=nbytes / 3.35e12 * 1e3,
                   copy_bound_ms=nbytes / (copy_gbps * 1e9) * 1e3, copy_gbps=copy_gbps)
        if "replay_ms" in rec:
            rec["copy_share"] = rec["copy_bound_ms"] / rec["replay_ms"]
        recs.append(rec)
        del Y, X, exact, scale
        torch.cuda.empty_cache()
    return recs


def crossover(pairs=CROSSOVER, ns=CROSSOVER_N):
    """The kernel (with ``MIN_N`` lifted) and the plain version by replay,
    in turns, at each (a, b) of ``pairs`` and n of ``ns``: one record each."""
    from dune_eigensolver_tpu_torch.bench.timing import in_turns, replay_ms
    from dune_eigensolver_tpu_torch.kernels import ortho_gram as og

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    recs, floor = [], og.MIN_N
    og.MIN_N = 1
    try:
        for a, b in pairs:
            for n in ns:
                Y, X = _operands(dev, a, b, n, 0, False)
                k, p = in_turns([lambda: og.ortho_gram_cuda(Y, X), lambda: Y @ X.T], replay_ms)
                recs.append({"crossover": True, "a": a, "b": b, "n": n, "kernel_ms": k,
                             "plain_ms": p})
    finally:
        og.MIN_N = floor
    return recs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="")
    ap.add_argument("--crossover", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ortho_gram: needs a CUDA device")
    _emit(args.out, {"card": _card(), "torch": torch.__version__})
    for rec in measure():
        _emit(args.out, rec)
    if args.crossover:
        for rec in crossover():
            _emit(args.out, rec)


if __name__ == "__main__":
    main()
