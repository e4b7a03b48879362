"""ParameterTree-style configuration: INI file + dotted-key CLI overrides.

The reference configures everything through ``Dune::ParameterTree`` — an INI
file read first, then overridden by ``key=value`` command-line arguments
(src/dune-eigensolver.cc:751-754), with hierarchical dotted keys like
``ev.tol``. This reproduces those semantics on ``configparser``.

Default keys mirror src/dune-eigensolver.ini:13-31 (sections [grid] [mv]
[ev] [parallel] [mgs]), with the additions kept in their own keys so a
reference ini file parses unchanged.

Copy of the JAX package's ``config.py`` (that package's ``__init__``
imports jax, so the port keeps its own), without the TPU-only key
``ev.compile_cache[_dir]`` and with one new key, ``ev.device``: empty (the
default) is the current CUDA device, ``cpu`` runs the plain versions on the
CPU (``utils/device.py``).
"""

from __future__ import annotations

import configparser
from typing import Any, Dict, Iterable, Optional

#: defaults mirroring src/dune-eigensolver.ini (values quoted at SURVEY.md §2
#: "Config system"); additions: ev.dtype, ev.inverse, ev.block,
#: parallel.ndevices, ev.n3d (3D problem switch), ev.problem
#: (geneo|elasticity operand pair), ev.dist_inner (schwarz|cg for the
#: general distributed solvers), ev.device ("" = the card | cpu)
DEFAULTS: Dict[str, Dict[str, Any]] = {
    "grid": {"N": 200, "overlap": 3},
    "mv": {"n": 32, "m": 16},
    "ev": {
        "N": 200,
        "m": 4,
        "maxiter": 4000,
        "shift": 1e-3,
        "regularization": 0.0,
        "tol": 2e-3,
        "threshold": 0.0,  # adaptive GenEO coverage threshold (0 = no growth)
        "growth": 1.3,  # adaptive nev growth factor (arpack_geneo_wrapper.hh:748)
        "verbose": 0,
        "overlap": 3,
        "method": "raes",
        "seed": 123,
        "dtype": "float32",
        "inverse": "auto",  # auto | banded | cg | lu
        "block": 8,
        "dim": 2,  # 2 -> N x N grid, 3 -> N^3 grid
        "rr": False,  # Rayleigh-Ritz rotation (beyond-reference accelerator)
        "device": "",  # "" = the current CUDA device; "cpu" = plain versions
    },
    "parallel": {"numthreads": 1, "ndevices": 0},  # 0 = all visible devices
    "mgs": {"n": 20, "m": 16, "n_iter": 15},
}


def _convert(value: str) -> Any:
    """INI/CLI strings to int/float/bool/str, most specific first."""
    s = value.strip()
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            pass
    if s.lower() in ("true", "false"):
        return s.lower() == "true"
    return s


class ParameterTree:
    """Hierarchical config with ``tree["ev.tol"]``-style dotted access."""

    def __init__(self, data: Optional[Dict[str, Dict[str, Any]]] = None):
        self._data: Dict[str, Dict[str, Any]] = {
            sec: dict(keys) for sec, keys in (data or DEFAULTS).items()
        }

    def __getitem__(self, dotted: str) -> Any:
        sec, _, key = dotted.partition(".")
        if not key:
            raise KeyError(f"expected dotted key 'section.key', got {dotted!r}")
        return self._data[sec][key]

    def get(self, dotted: str, default: Any = None) -> Any:
        try:
            return self[dotted]
        except KeyError:
            return default

    def __setitem__(self, dotted: str, value: Any) -> None:
        sec, _, key = dotted.partition(".")
        if not key:
            raise KeyError(f"expected dotted key 'section.key', got {dotted!r}")
        self._data.setdefault(sec, {})[key] = value

    def section(self, name: str) -> Dict[str, Any]:
        return dict(self._data.get(name, {}))

    def read_ini(self, path: str) -> "ParameterTree":
        cp = configparser.ConfigParser()
        cp.optionxform = str  # preserve key case (N vs n)
        with open(path) as fh:
            cp.read_file(fh)
        for sec in cp.sections():
            for key, raw in cp[sec].items():
                self[f"{sec}.{key}"] = _convert(raw)
        return self

    def read_cli(self, args: Iterable[str]) -> "ParameterTree":
        """Apply ``section.key=value`` overrides (reference: readOptions,
        src/dune-eigensolver.cc:754). Unknown args raise."""
        for arg in args:
            if "=" not in arg:
                raise ValueError(
                    f"expected key=value override, got {arg!r} "
                    "(dotted keys, e.g. ev.tol=1e-4)"
                )
            key, _, raw = arg.partition("=")
            self[key] = _convert(raw)
        return self

    def __repr__(self) -> str:
        lines = []
        for sec in sorted(self._data):
            lines.append(f"[{sec}]")
            for key in sorted(self._data[sec]):
                lines.append(f"{key} = {self._data[sec][key]}")
        return "\n".join(lines)
