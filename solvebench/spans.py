"""The harness's own spans around the calls into the program's layers.

They are opened only in the traced run's profiled solve (``on``), as
``torch.profiler.record_function`` ranges, so the timed window runs the
program as it is:

* ``solvebench.precond.<kind>`` around each preconditioner apply that the
  harness hands the solver (``wrap_inverse``);
* ``solvebench.launch.<i>`` around each call of a kernel wrapper that the
  program's SpMM dispatch routes to, with the call's shapes kept in
  ``launches[i]`` (``kernel_launches``), so that a kernel's device records
  can be tied to the operand and block it streamed.
"""

from __future__ import annotations

import contextlib
import functools


class Spans:
    def __init__(self):
        self.on = False
        self.launches = []

    def wrap_inverse(self, kind: str, factory):
        """A factory like ``factory`` whose applies run inside the range
        ``solvebench.precond.<kind>`` while ``on``. The solver memoizes its
        set-up on the factory's identity, so the timed solves and the
        profiled one share this one object."""
        name = f"solvebench.precond.{kind}"
        spans = self

        def inverse(A_int):
            pair = factory(A_int)
            if not (isinstance(pair, tuple) and len(pair) == 2 and callable(pair[1])):
                raise TypeError(f"{kind}: the factory returned {type(pair)}, not (aux, fn)")
            aux, fn = pair

            def apply(aux_, X):
                if not spans.on:
                    return fn(aux_, X)
                from torch.profiler import record_function

                with record_function(name):
                    return fn(aux_, X)

            apply.layout_t = getattr(fn, "layout_t", False)
            return aux, apply

        return inverse

    @contextlib.contextmanager
    def kernel_launches(self):
        """Route the program's SpMM dispatch through recording wrappers for
        the duration, and restore it after."""
        import importlib

        from torch.profiler import record_function

        # the module, not the function ``spmm`` that the package exports
        dispatch = importlib.import_module("dune_eigensolver_tpu_torch.sparse.spmm")

        saved = dict(dispatch._ROUTES)

        def recording(kernel):
            @functools.wraps(kernel)
            def launch(A, Xt):
                i = len(self.launches)
                self.launches.append(_describe(kernel.__name__, A, Xt))
                with record_function(f"solvebench.launch.{i}"):
                    return kernel(A, Xt)

            return launch

        try:
            for kind, (kernel, plain) in saved.items():
                dispatch._ROUTES[kind] = (recording(kernel), plain)
            yield self.launches
        finally:
            dispatch._ROUTES.clear()
            dispatch._ROUTES.update(saved)


def _describe(kernel: str, A, Xt) -> dict:
    """What a kernel call streams: its operand's rows, stored entries and
    layout, the block's rows and the item size."""
    m, n = Xt.shape
    out = {"kernel": kernel, "n": n, "m": m, "itemsize": Xt.element_size(),
           "dtype": str(Xt.dtype).replace("torch.", "")}
    if hasattr(A, "offsets"):
        out["ndiag"] = len(A.offsets)
    if hasattr(A, "block"):
        br, bc = A.block
        out.update(block=br, nnzb=A.nnz // (br * bc))
    return out
