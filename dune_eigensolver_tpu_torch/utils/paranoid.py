"""Debug-mode NaN tripwire on the kernel dispatches, and a check of the
``b_identity=True`` assertion.

Counterpart of the JAX package's ``utils/paranoid.py``:

    from dune_eigensolver_tpu_torch.utils.paranoid import set_paranoid
    set_paranoid(True)          # or ev.paranoid=1 on the command line

then every ``spmm_t`` dispatch to a kernel (``sparse/spmm.py``) samples the
centre 128 columns of its (m, n) output and ORs "non-finite" into a flag
that lives on the output's device, one flag per kernel (tag). Nothing is
read back per dispatch. ``report`` reads the flags once, prints the JAX
package's alarm text for each one raised and clears them; the solver entry
points call it when they return (``reporting``), once per outermost call,
and the CLI after each test. So the alarm comes at the end of a solve, not
at the dispatch that raised it, as the JAX package's ``jax.debug.print``
does (a deliberate difference: one host read a solve instead of a device
callback per dispatch). With paranoid mode off a dispatch adds no device
operation and no host read.
"""

from __future__ import annotations

import functools

import torch

_PARANOID = False
_DEPTH = 0  # entry points running; the outermost one reports
# (kind, tag or tolerance, device) -> 0-d bool tensor on that device
_FLAGS: dict = {}


def set_paranoid(on: bool) -> None:
    """Enable or disable the tripwire. Disabling drops the flags unread."""
    global _PARANOID
    _PARANOID = bool(on)
    if not _PARANOID:
        _FLAGS.clear()


def paranoid_enabled() -> bool:
    return _PARANOID


def _raise_flag(key, bad: torch.Tensor) -> None:
    flag = _FLAGS.get(key)
    if flag is None:
        _FLAGS[key] = bad.clone()
    else:
        flag.logical_or_(bad)


def nan_check(Y: torch.Tensor, tag: str) -> torch.Tensor:
    """Identity pass-through that, in paranoid mode, ORs "the centre 128
    columns of Y hold a non-finite value" into ``tag``'s flag on Y's device.
    Returns Y unchanged either way."""
    if not _PARANOID:
        return Y
    ncheck = min(128, Y.shape[-1])
    # the array's centre, as the JAX package samples it: solver loops smear
    # any NaN across all columns within one orthonormalization anyway
    start = (Y.shape[-1] - ncheck) // 2
    bad = ~torch.isfinite(Y.narrow(-1, start, ncheck)).all()
    _raise_flag(("nan", tag, Y.device), bad)
    return Y


def b_identity_check(B, tol: float = 1e-6) -> None:
    """Paranoid-mode check of the caller's ``b_identity=True`` assertion:
    applies B to a random probe (``torch.Generator(device).manual_seed(7)``,
    one ``spmm_t``) and raises a flag if ``max |B v - v|`` exceeds
    ``tol * max|v|``. The probe is random, not all-ones: a unit-row-sum
    matrix passes the ones probe while being far from the identity. No-op
    when paranoid mode is off or B is None."""
    if not _PARANOID or B is None:
        return
    from dune_eigensolver_tpu_torch.sparse.spmm import spmm_t

    gen = torch.Generator(device=B.device).manual_seed(7)
    v = torch.randn((1, B.shape[0]), generator=gen, dtype=B.dtype, device=B.device)
    bad = (spmm_t(B, v) - v).abs().max() > tol * v.abs().max()
    _raise_flag(("b_identity", tol, B.device), bad)


def _alarm(kind, what) -> str:
    """The JAX package's alarm text, word for word."""
    if kind == "nan":
        return (f"PARANOID: non-finite values after kernel '{what}' (first-lane block); "
                "suspect the far-group VMEM corruption mode - see "
                "experiments/vmem_nan_repro.py")
    return (f"PARANOID: b_identity=True but max |B@v - v| on a random probe exceeds {what} "
            "* max|v| - the caller's identity assertion is WRONG and all B-applies are "
            "being skipped")


def report() -> list:
    """Read every flag (one host read per device), print the alarm of each
    one raised, clear them all. Returns the alarm lines printed; nothing is
    read when paranoid mode is off or no flag was made."""
    if not _PARANOID or not _FLAGS:
        return []
    keys = list(_FLAGS)
    raised = {}
    for dev in {k[2] for k in keys}:
        mine = [k for k in keys if k[2] == dev]
        values = torch.stack([_FLAGS[k] for k in mine]).cpu().tolist()
        raised.update(zip(mine, values))
    _FLAGS.clear()
    lines = [_alarm(k[0], k[1]) for k in keys if raised[k]]
    for line in lines:
        print(line, flush=True)
    return lines


def reporting(fn):
    """Decorate a solver entry point: when the outermost decorated call
    returns (or raises), ``report`` runs if paranoid mode is on. Off, the
    wrapper costs a counter and nothing on the device."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        global _DEPTH
        _DEPTH += 1
        try:
            return fn(*args, **kwargs)
        finally:
            _DEPTH -= 1
            if _DEPTH == 0 and _PARANOID:
                report()

    return wrapper
