"""Build and load the package's CUDA kernels (counterpart of the JAX
package's ``utils/native.py`` ctypes bridge to ``native/libdunetpu.so``).

The sources under ``csrc/`` are compiled with ``nvcc`` for sm_90a, one
``nvcc`` process per source, all started together, and linked into one
shared library with a plain C interface, at first use, into the package's
``_build/`` directory (ignored by git), and loaded with ctypes. The
library's file name carries a hash of the sources and flags, so an edited
kernel is rebuilt and a stale one is never loaded. Nothing is built or
loaded when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIB = None


def _sources():
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cu")
    )


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        with open(src, "rb") as fh:
            h.update(os.path.basename(src).encode() + fh.read())
    return os.path.join(BUILD_DIR, f"libdune_kernels_{h.hexdigest()[:16]}.so")


def _run_all(cmds):
    """Run the commands together; return their outputs in order. Raises
    with every output once all have ended if any failed."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    outs = [p.communicate()[0] for p in procs]
    failed = [(c, p.returncode, o) for c, p, o in zip(cmds, procs, outs) if p.returncode]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{' '.join(c)} -> {rc}\n{o}" for c, rc, o in failed))
    return outs


def build():
    """Compile ``csrc/*.cu`` unless the library for these sources exists.
    Returns ``(library path, nvcc's output)``, the output empty when the
    library was already built. Raises with nvcc's output on failure."""
    sources = _sources()
    path = _lib_path(sources)
    if os.path.exists(path):
        return path, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in sources]
    log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, s] for s, o in zip(sources, objs)])
    log += _run_all([[nvcc, "-shared", "-o", tmp, *objs]])
    for o in objs:
        os.remove(o)
    os.replace(tmp, path)
    return path, "".join(log)


def load() -> ctypes.CDLL:
    """The kernel library, built if needed, with every entry point's
    ``argtypes``/``restype`` declared."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(build()[0])
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dia_spmm_t_launch.restype = i32
    lib.dia_spmm_t_launch.argtypes = [
        i32, vp, vp, vp, i64, i32, i32, ctypes.POINTER(i32), vp,
    ]
    # (data_t, cols_t, n, k, ncols, x, y, m, stream)
    lib.ell_spmm_t_launch.restype = i32
    lib.ell_spmm_t_launch.argtypes = [vp, vp, i64, i32, i64, vp, vp, i32, vp]
    # (b, bdata_t, bcols_t, nbr, k, ncols, x, y, m, stream)
    lib.bsr_spmm_t_launch.restype = i32
    lib.bsr_spmm_t_launch.argtypes = [i32, vp, vp, i64, i32, i64, vp, vp, i32, vp]
    # copy probe: (x, y, rows, width, tile, stream), (x, rows, width, tile,
    # stream), (d, x, y, rows, width, nd, tile, stream)
    lib.copy_add1_launch.restype = i32
    lib.copy_add1_launch.argtypes = [vp, vp, i32, i64, i32, vp]
    lib.copy_add1_inplace_launch.restype = i32
    lib.copy_add1_inplace_launch.argtypes = [vp, i32, i64, i32, vp]
    lib.copy_add_row_launch.restype = i32
    lib.copy_add_row_launch.argtypes = [vp, vp, vp, i32, i64, i32, i32, vp]
    # DIA staging variants, each (data, x, y, [side,] n, m, ndiag, offsets, ...)
    offs = ctypes.POINTER(i32)
    lib.dia_c_launch.restype = i32  # ..., T, H, rows, nwalk, stream
    lib.dia_c_launch.argtypes = [vp, vp, vp, i64, i32, i32, offs, i32, i32, i32, i32, vp]
    lib.dia_b_launch.restype = i32  # ..., T, lo, W, rows, tpc, nslots, depth, stream
    lib.dia_b_launch.argtypes = [
        vp, vp, vp, i64, i32, i32, offs, i32, i32, i32, i32, i32, i32, i32, vp,
    ]
    lib.dia_d_launch.restype = i32  # ..., T, rows, tpc, stream
    lib.dia_d_launch.argtypes = [vp, vp, vp, vp, i64, i32, i32, offs, i32, i32, i32, vp]
    # (variant, ndiag, slots, rows, window) -> blocks per SM, 0, or -error
    lib.dia_variant_blocks_per_sm.restype = i32
    lib.dia_variant_blocks_per_sm.argtypes = [i32, i32, i32, i32, i32]
    lib.dune_cuda_error_string.restype = ctypes.c_char_p
    lib.dune_cuda_error_string.argtypes = [i32]
    _LIB = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = load().dune_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
