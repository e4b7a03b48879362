"""Build and load the package's native code: the CUDA kernels and the
host-setup helper (counterpart of the JAX package's ``utils/native.py``
ctypes bridge to ``native/libdunetpu.so``).

The CUDA sources make two libraries, one a directory: the solver's kernels
(``csrc/*.cu``, ``SOLVER``) and the kernel studies' (``csrc/experiments/
*.cu``, ``STUDIES``). Each is compiled with ``nvcc`` for sm_90a, one
``nvcc`` process per source, all started together, and linked into one
shared library with a plain C interface, at first use, into the package's
``_build/`` directory (ignored by git), and loaded with ctypes. A library's
file name carries a hash of the flags, its sources and the headers they may
include (the ``*.cuh`` of its directory and of the directories above it up
to ``csrc/``), so an edited kernel or header is rebuilt and a stale one is
never loaded, and an edit to a study never renames the solver's library.
Nothing is built or loaded when the module is imported, and a solve builds
the solver's library alone.

Each kernel wrapper module declares the entry points it launches beside the
calls that pass their arguments (``Launchers``); this module names none but
``dune_cuda_error_string``, which each library defines for ``check``.

The host helper, ``csrc/host/dunetpu.cpp`` (a copy of the JAX package's
``native/dunetpu.cpp``), is compiled the same way with ``g++`` and the
reference Makefile's flags; its name also carries g++'s resolved
``-march=native`` target, so a build directory shared between machines
never loads another CPU's build. ``levels_from_csr``, ``chunk_schedule``,
``lu_banded`` and ``csr_to_ell`` keep the JAX module's names, arguments and
results. Unlike the JAX module's, they never return ``None`` for a missing
library: a failed build raises with g++'s output (``available()`` reports
whether the helper builds and loads). Every build compiles to a temporary
file and renames it onto the final name, so concurrent processes never load
a half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
#: the two kernel libraries' source directories: the solver's and the studies'
SOLVER = CSRC
STUDIES = os.path.join(CSRC, "experiments")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

HOST_SRC = os.path.join(CSRC, "host", "dunetpu.cpp")
HOST_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared")

_LIBS = {}  # source directory -> its loaded library
_HOST_LIB = None


def _files(directory: str, suffix: str):
    return sorted(os.path.join(directory, f) for f in os.listdir(directory) if f.endswith(suffix))


def _sources(csrc: str = SOLVER):
    """A library's CUDA sources, one ``nvcc`` each: the ``*.cu`` of its
    directory."""
    return _files(csrc, ".cu")


def _headers(csrc: str = SOLVER, root: str = CSRC):
    """The headers a library's sources may include: not compiled on their
    own, but part of the library's hash. The ``*.cuh`` of its directory and
    of each directory above it up to ``root`` (the studies include the
    solver's ``ell_body.cuh``; the solver includes none of the studies')."""
    d, root = os.path.abspath(csrc), os.path.abspath(root)
    headers = _files(d, ".cuh")
    while d != root and os.path.dirname(d) != d:
        d = os.path.dirname(d)
        headers += _files(d, ".cuh")
    return headers


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(sources, headers=(), name: str = "kernels") -> str:
    """A library's file name: ``name`` and a hash of the flags, the sources
    and the headers they may include, so an edited header is rebuilt too."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*sources, *headers):
        with open(src, "rb") as fh:
            h.update(os.path.basename(src).encode() + fh.read())
    return os.path.join(BUILD_DIR, f"libdune_{name}_{h.hexdigest()[:16]}.so")


def _lib_name(csrc: str) -> str:
    """``kernels`` for the solver's library (``csrc/``), ``experiments`` for
    the studies'."""
    name = os.path.basename(os.path.abspath(csrc))
    return "kernels" if name == "csrc" else name


def _run_all(cmds, tool="nvcc"):
    """Run the commands together; return their outputs in order. Raises
    with every output once all have ended if any failed."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    outs = [p.communicate()[0] for p in procs]
    failed = [(c, p.returncode, o) for c, p, o in zip(cmds, procs, outs) if p.returncode]
    if failed:
        raise RuntimeError(f"{tool} failed:\n" + "\n".join(
            f"{' '.join(c)} -> {rc}\n{o}" for c, rc, o in failed))
    return outs


def build(csrc: str = SOLVER):
    """Compile the library of ``csrc`` (``SOLVER`` or ``STUDIES``) unless it
    exists for these sources and headers. Returns ``(library path, nvcc's
    output)``, the output empty when the library was already built. Raises
    with nvcc's output on failure."""
    sources = _sources(csrc)
    path = _lib_path(sources, _headers(csrc), _lib_name(csrc))
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


def load(csrc: str = SOLVER) -> ctypes.CDLL:
    """The library of ``csrc``, built if needed; of its entry points only
    the error string is declared here (``Launchers`` declares the rest)."""
    lib = _LIBS.get(csrc)
    if lib is None:
        lib = ctypes.CDLL(build(csrc)[0])
        lib.dune_cuda_error_string.restype = ctypes.c_char_p
        lib.dune_cuda_error_string.argtypes = [ctypes.c_int]
        _LIBS[csrc] = lib
    return lib


class Launchers:
    """The entry points a wrapper module launches, ``{name: argtypes}``, each
    returning a C int (a ``cudaError_t``, or a count), in the library of
    ``csrc``. Calling it returns that library, built and loaded at the first
    call, which also declares the entry points."""

    def __init__(self, signatures: dict, csrc: str = SOLVER):
        self.signatures, self.csrc = dict(signatures), csrc
        self._lib = None

    def __call__(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = load(self.csrc)
            for name, argtypes in self.signatures.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = ctypes.c_int, argtypes
            self._lib = lib
        return self._lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        # every library defines the error string; a launch has loaded one
        lib = next(iter(_LIBS.values()), None) or load()
        msg = lib.dune_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")


def cuobjdump() -> Optional[str]:
    """The CUDA toolkit's ``cuobjdump``, or None where it is missing."""
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "cuobjdump"),
        shutil.which("cuobjdump"),
        "/usr/local/cuda/bin/cuobjdump",
    ):
        if cand and os.path.isfile(cand):
            return cand
    return None


def _sass_text(tool: str, lib: str, name: str) -> str:
    """``cuobjdump -sass`` of the cubins in ``lib`` whose symbols hold
    ``name``: each source's cubin is extracted first (``-xelf all``, no
    disassembly), so only the sources asked about are disassembled, not the
    whole library."""
    with tempfile.TemporaryDirectory() as tmp:
        subprocess.run([tool, "-xelf", "all", os.path.abspath(lib)], cwd=tmp, check=True,
                       capture_output=True)
        picked = []
        for f in sorted(os.listdir(tmp)):
            with open(os.path.join(tmp, f), "rb") as fh:
                if name.encode() in fh.read():
                    picked.append(os.path.join(tmp, f))
        return "".join(_run_all([[tool, "-sass", c] for c in picked], tool="cuobjdump"))


def sass(name: str, path: Optional[str] = None, csrc: str = SOLVER) -> dict:
    """The SASS of each kernel of the library at ``path`` (by default the
    built library of ``csrc``) whose mangled name holds ``name``:
    ``{mangled name: text}``, as ``cuobjdump -sass`` prints it. What ptxas
    kept, which the sources alone cannot show (a load whose result nothing
    reads is dead to it). Raises where ``cuobjdump`` is missing."""
    tool = cuobjdump()
    if tool is None:
        raise RuntimeError("cuobjdump not found: set CUDA_HOME or put it on PATH")
    funcs = {}
    for part in _sass_text(tool, path or build(csrc)[0], name).split("Function : ")[1:]:
        head, _, body = part.partition("\n")
        if name in head:
            funcs[head.strip()] = body
    return funcs


_LDG = re.compile(r"\bLDG\b")  # a global load (not LDGSTS, cp.async)


def sass_global_loads(name: str, path: Optional[str] = None, csrc: str = SOLVER) -> dict:
    """The global-load instructions (``LDG``) in the SASS of each kernel
    whose mangled name holds ``name``: ``{mangled name: count}``."""
    return {f: len(_LDG.findall(text)) for f, text in sass(name, path, csrc).items()}


# ---------------------------------------------------------------------------
# The host-setup helper (g++)
# ---------------------------------------------------------------------------


def _cxx() -> str:
    for cand in (os.environ.get("CXX", ""), shutil.which("g++"), "/usr/bin/g++"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("g++ not found: set CXX or put g++ on PATH")


def _host_lib_path(cxx: str, source: str, build_dir: str) -> str:
    target = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True, check=True).stdout
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode() + target.encode())
    with open(source, "rb") as fh:
        h.update(fh.read())
    return os.path.join(build_dir, f"libdunetpu_host_{h.hexdigest()[:16]}.so")


def build_host(source: str = HOST_SRC, build_dir: str = BUILD_DIR):
    """Compile the host helper unless the library for this source, these
    flags and this CPU exists. Returns ``(library path, g++'s output)``,
    the output empty when the library was already built. Raises with g++'s
    output on failure."""
    cxx = _cxx()
    path = _host_lib_path(cxx, source, build_dir)
    if os.path.exists(path):
        return path, ""
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    log = _run_all([[cxx, *HOST_FLAGS, "-o", tmp, source]], tool="g++")
    os.replace(tmp, path)
    return path, "".join(log)


def _ndptr(dtype):
    return np.ctypeslib.ndpointer(dtype, flags="C_CONTIGUOUS")


def _bind_host(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    i64 = ctypes.c_int64
    p64, p32 = _ndptr(np.int64), _ndptr(np.int32)
    lib.levels_from_csr.restype = None
    lib.levels_from_csr.argtypes = [i64, p64, p64, p32]
    lib.chunk_schedule.restype = i64
    lib.chunk_schedule.argtypes = [i64, i64, p64, p64, p32, p32, p64]
    for suffix, fp in (("f32", _ndptr(np.float32)), ("f64", _ndptr(np.float64))):
        fn = getattr(lib, "pack_chunks_" + suffix)
        fn.restype = None
        fn.argtypes = [i64, i64, i64, i64, p64, p64, fp, p32, p64, p32, p32, fp]
        fn = getattr(lib, "csr_to_ell_" + suffix)
        fn.restype = None
        fn.argtypes = [i64, i64, i64, p64, p64, fp, p32, fp]
    lib.lu_banded_f64.restype = i64
    lib.lu_banded_f64.argtypes = [i64, i64, _ndptr(np.float64)]
    return lib


def load_host() -> ctypes.CDLL:
    """The host helper, built if needed, with its ``argtypes`` declared."""
    global _HOST_LIB
    if _HOST_LIB is None:
        _HOST_LIB = _bind_host(build_host()[0])
    return _HOST_LIB


def available() -> bool:
    """Whether the host helper builds and loads here (the JAX module's
    ``available``). The routes that use it call ``load_host`` and raise."""
    try:
        load_host()
    except (RuntimeError, OSError, subprocess.CalledProcessError):
        return False
    return True


def _as64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def _checked_csr(indptr, indices, n: int, ncols: int):
    """int64 copies of a CSR pattern, checked so that the helper reads and
    writes in bounds: n + 1 nondecreasing offsets from 0, columns in
    [0, ncols)."""
    indptr, indices = _as64(indptr), _as64(indices)
    if indptr.shape != (n + 1,) or indptr[0] != 0 or np.any(np.diff(indptr) < 0):
        raise ValueError(f"CSR offsets: expected {n + 1} nondecreasing values from 0")
    if indices.shape[0] < indptr[-1]:
        raise ValueError(f"CSR columns: {indices.shape[0]} < {indptr[-1]} entries")
    used = indices[: indptr[-1]]
    if used.size and (used.min() < 0 or used.max() >= ncols):
        raise ValueError(f"CSR columns outside [0, {ncols})")
    return indptr, indices


def levels_from_csr(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Dependency level of each row of a strict lower-triangular CSR:
    lev[i] = 1 + max(lev[j] for j in row i), 0 for a row without entries."""
    n = len(indptr) - 1
    indptr, indices = _checked_csr(indptr, indices, n, n)
    lev = np.zeros(n, dtype=np.int32)
    load_host().levels_from_csr(n, indptr, indices, lev)
    return lev


def chunk_schedule(
    indptr: np.ndarray,
    indices: np.ndarray,
    data: np.ndarray,
    n: int,
    chunk: int,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, int, int]]:
    """The chunk schedule of a strict lower-triangular CSR: (rows, cols,
    vals, kmax, nlev), or None for a dtype other than float32/float64.
    rows (nchunk, chunk) int32 padded with n; cols/vals (nchunk, chunk,
    kmax) padded with n / 0. Rows are taken in a stable sort by level, and
    a chunk never spans two levels or more than ``chunk`` rows: the port's
    ``factorize/host_lu.py::_chunk_schedule_numpy`` bit for bit."""
    suffix = {np.dtype(np.float32): "f32", np.dtype(np.float64): "f64"}.get(data.dtype)
    if suffix is None:
        return None
    if chunk < 1:
        raise ValueError(f"chunk_schedule: chunk {chunk} < 1")
    indptr, indices = _checked_csr(indptr, indices, n, n)
    data = np.ascontiguousarray(data)
    if data.shape[0] < indptr[-1]:
        raise ValueError(f"CSR values: {data.shape[0]} < {indptr[-1]} entries")
    lib = load_host()
    lev = np.zeros(n, dtype=np.int32)
    order = np.zeros(n, dtype=np.int32)
    boundaries = np.zeros(n + 1, dtype=np.int64)
    nchunk = int(lib.chunk_schedule(n, chunk, indptr, indices, lev, order, boundaries))
    kmax = max(int(np.diff(indptr).max()) if n else 0, 1)
    rows = np.full((nchunk, chunk), n, dtype=np.int32)
    cols = np.full((nchunk, chunk, kmax), n, dtype=np.int32)
    vals = np.zeros((nchunk, chunk, kmax), dtype=data.dtype)
    getattr(lib, "pack_chunks_" + suffix)(n, chunk, kmax, nchunk, indptr, indices, data,
                                           order, boundaries, rows, cols, vals)
    nlev = int(lev.max() + 1) if n else 0
    return rows, cols, vals, kmax, nlev


def lu_banded(work: np.ndarray, n: int, bw: int) -> int:
    """No-pivot banded LU in place on the column-band float64 array
    ``work[bw + r, i] = A[i + r, i]``, shape (2 bw + 1, n). Returns the
    first zero pivot's row, or -1. It multiplies by 1/pivot where the numpy
    loop divides, and g++ may contract the update into an FMA, so L and U
    agree with ``factorize/banded.py::_lu_banded_numpy`` to rounding, not
    bit for bit."""
    if (work.dtype != np.float64 or not work.flags["C_CONTIGUOUS"]
            or work.shape != (2 * bw + 1, n)):
        raise ValueError(f"lu_banded: expected a C-contiguous float64 ({2 * bw + 1}, {n}) "
                         f"array, got {work.dtype} {work.shape}")
    return int(load_host().lu_banded_f64(n, bw, work))


def csr_to_ell(
    indptr: np.ndarray,
    indices: np.ndarray,
    data: np.ndarray,
    kmax: int,
    pad_col: int,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """CSR -> ELL packing: (cols (n, kmax) int32, vals (n, kmax)), each row
    padded with ``pad_col`` and 0; None for a dtype other than
    float32/float64."""
    suffix = {np.dtype(np.float32): "f32", np.dtype(np.float64): "f64"}.get(data.dtype)
    if suffix is None:
        return None
    n = len(indptr) - 1
    indptr, indices = _checked_csr(indptr, indices, n, np.iinfo(np.int32).max)
    data = np.ascontiguousarray(data)
    if data.shape[0] < indptr[-1] or (n and np.diff(indptr).max() > kmax):
        raise ValueError(f"csr_to_ell: a row holds more than kmax={kmax} entries, "
                         f"or the values are short")
    cols = np.empty((n, kmax), dtype=np.int32)
    vals = np.empty((n, kmax), dtype=data.dtype)
    getattr(load_host(), "csr_to_ell_" + suffix)(n, kmax, pad_col, indptr, indices, data,
                                                  cols, vals)
    return cols, vals
