"""Copy-rate probe: what a copy reaches on this card, the rate the SpMM
kernels' GB/s are put against.

Counterpart of ``experiments/pipeline_probe.py``. Phases, as there:

  1  1-D copy (v + 1.0) on 256 MB             the library's rate
  2  2-D copy (x + 1.0) on (8, width)         the multivector's shape
  3  2-D copy on (16, width/2), (32, ...)     the row-count sweep
  4  the hand-written copy, over its tile sizes
  5  the hand-written copy + the (5, width) coefficient stream
  6  the hand-written copy in place

``ident``, ``identd`` and ``ident_alias`` wrap the CUDA kernels of
``csrc/copy_probe.cu`` (they replace ``pallas_ident``, ``pallas_identd``
and ``pallas_ident_alias``), count their launches and have no fallback: a
CPU tensor raises. ``ident_reference``/``identd_reference`` are their plain
versions; ``main`` takes those, and only for ``--device cpu``.

    python -m dune_eigensolver_tpu_torch.experiments.pipeline_probe [T]
        [--device cpu] [--width W] [--mb MB]

``identd`` loads all rows of ``d`` (the kernel discards rows 1.., see the
source), so its bytes are ``2 * x + d``, as the reference counts them.
"""

from __future__ import annotations

import argparse

import torch

from dune_eigensolver_tpu_torch.bench.timing import bench_loop
from dune_eigensolver_tpu_torch.utils.device import resolve

WIDTH = 4259840  # the reference's multivector width (a padded 2D N=2048)
TILES = (1024, 2048, 4096, 8192, 16384, 32768, 65536)


def ident_reference(x: torch.Tensor) -> torch.Tensor:
    """Y = X + 1 in plain PyTorch."""
    return x + 1.0


def identd_reference(d: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Y = X + d[0][None, :] in plain PyTorch."""
    return x + d[0][None, :]


def _check(what: str, T: int, x: torch.Tensor, *others: torch.Tensor) -> None:
    if x.ndim != 2 or T < 1:
        raise ValueError(f"{what}: x {tuple(x.shape)} must be 2-D and the tile positive")
    for t in (x, *others):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(
                f"{what}: tensor on {t.device}; the kernel takes tensors of one "
                "CUDA device (the plain version is *_reference)"
            )
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: dtype {t.dtype}; the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")


def _run(name: str, x: torch.Tensor, *args) -> None:
    from dune_eigensolver_tpu_torch.utils import native

    lib = native.load()
    with torch.cuda.device(x.device):
        err = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    native.check(err, name)


def ident(T: int, x: torch.Tensor) -> torch.Tensor:
    """Y = X + 1 by the CUDA copy kernel; a block owns T columns per step."""
    _check("ident", T, x)
    y = torch.empty_like(x)
    _run("copy_add1_launch", x, x.data_ptr(), y.data_ptr(), x.shape[0], x.shape[1], T)
    ident.launches += 1
    return y


def ident_alias(T: int, x: torch.Tensor) -> torch.Tensor:
    """X += 1 in place by the CUDA kernel; returns ``x`` itself."""
    _check("ident_alias", T, x)
    _run("copy_add1_inplace_launch", x, x.data_ptr(), x.shape[0], x.shape[1], T)
    ident_alias.launches += 1
    return x


def identd(T: int, d: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Y = X + d[0] by the CUDA kernel, which streams all of ``d``."""
    _check("identd", T, x, d)
    if d.ndim != 2 or d.shape[1] != x.shape[1]:
        raise ValueError(f"identd: d {tuple(d.shape)} beside x {tuple(x.shape)}")
    y = torch.empty_like(x)
    _run("copy_add_row_launch", x, d.data_ptr(), x.data_ptr(), y.data_ptr(), x.shape[0],
         x.shape[1], d.shape[0], T)
    identd.launches += 1
    return y


ident.launches = 0
ident_alias.launches = 0
identd.launches = 0


def copy_table(device, T: int = 32768, width: int = WIDTH, mb: int = 256):
    """Run the probe's phases; yield ``(label, seconds, GB/s, kind)`` as each
    ends, with kind ``library`` (one PyTorch call), ``kernel`` or ``plain``
    (the kernel's plain version, taken on the CPU only)."""
    device = resolve(device)
    on_cpu = device.type == "cpu"
    kind = "plain" if on_cpu else "kernel"
    K = 30  # applications per timed chain, as in the reference

    def row(label, t, nbytes, kind_):
        return label, t, nbytes / t / 1e9, kind_

    buf = torch.ones((mb * 1024 * 1024 // 4,), dtype=torch.float32, device=device)
    nbytes = 2 * buf.numel() * 4
    yield row(f"1d copy {mb}MB", bench_loop(lambda v: v + 1.0, buf, K=K), nbytes, "library")
    out = torch.empty_like(buf)

    def copy_into(v):  # Tensor.copy_, with the source handed on so the chain repeats it
        out.copy_(v)
        return v

    yield row(f"1d copy_ {mb}MB", bench_loop(copy_into, buf, K=K), nbytes, "library")
    del buf, out
    for mm in (8, 16, 32, 64):
        w = width * 8 // mm
        x = torch.ones((mm, w), dtype=torch.float32, device=device)
        yield row(f"2d copy ({mm:3d},{w})", bench_loop(lambda v: v + 1.0, x, K=K),
                  2 * x.numel() * 4, "library")
        del x

    x = torch.ones((8, width), dtype=torch.float32, device=device)
    d = torch.ones((5, width), dtype=torch.float32, device=device)
    xbytes = 2 * x.numel() * 4
    if on_cpu:  # the plain versions have no tile
        yield row("ident", bench_loop(ident_reference, x, K=K), xbytes, kind)
        t_d = bench_loop(lambda v, dd: identd_reference(dd, v), x, K=K, op_args=(d,))
        t_a = bench_loop(lambda v: v.add_(1.0), x, K=K)
    else:
        for TT in (T, *(t for t in TILES if t != T)):
            yield row(f"ident T={TT}", bench_loop(lambda v, TT=TT: ident(TT, v), x, K=K),
                      xbytes, kind)
        t_d = bench_loop(lambda v, dd: identd(T, dd, v), x, K=K, op_args=(d,))
        t_a = bench_loop(lambda v: ident_alias(T, v), x, K=K)
    yield row(f"ident+d T={T}", t_d, xbytes + d.numel() * 4, kind)
    yield row(f"ident ALIASED T={T}", t_a, xbytes, kind)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("T", nargs="?", type=int, default=32768, help="tile (columns per block step)")
    ap.add_argument("--device", default=None, help="cpu for the plain versions; default the card")
    ap.add_argument("--width", type=int, default=WIDTH)
    ap.add_argument("--mb", type=int, default=256, help="size of the 1-D buffer")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    if device.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(device)}", flush=True)
    else:
        print("device: cpu (plain versions; no rate here is the card's)", flush=True)
    for label, t, gbps, kind in copy_table(device, args.T, args.width, args.mb):
        print(f"{label:<28s}: {t * 1e6:9.1f}us {gbps:8.1f} GB/s [{kind}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
