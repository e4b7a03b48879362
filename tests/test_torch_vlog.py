"""The port's verbosity logger, fallback warning and profiler trace against
the JAX package's ``utils/vlog.py``."""

import json
import os
import re

import torch

from dune_eigensolver_tpu.utils import vlog as jvlog
from dune_eigensolver_tpu_torch.utils import vlog as tvlog


def _drive(mod, prefix):
    log = mod.VLog(verbose=1, prefix=prefix)
    log(1, "visible", 3)
    log(2, "hidden")
    with log.span("phase", level=1):
        pass
    with log.span("deep", level=2):
        pass


def test_vlog_prints_what_jax_prints(capsys):
    """The same calls print the same lines, but for the span's seconds."""
    for prefix in ("", "[solver]"):
        outs = []
        for mod in (tvlog, jvlog):
            _drive(mod, prefix)
            outs.append(re.sub(r"\d+\.\d{4}s", "<s>", capsys.readouterr().out))
        assert outs[0] == outs[1]
        head = f"{prefix} " if prefix else ""
        assert outs[0] == f"{head}visible 3\n{head}phase: <s>\n"


def test_warn_fallback_matches_jax(capfd):
    tvlog.warn_fallback("unit probe")
    t = capfd.readouterr()
    jvlog.warn_fallback("unit probe")
    j = capfd.readouterr()
    assert t.err == j.err == "FALLBACK: unit probe\n" and t.out == j.out == ""


def test_profiler_trace_writes_a_chrome_trace_on_cpu(tmp_path):
    logdir = tmp_path / "trace"
    with tvlog.profiler_trace(str(logdir)):
        x = torch.randn(64, 64)
        (x @ x).sum()
    (name,) = os.listdir(logdir)
    assert name.startswith("trace_") and name.endswith(".json")
    with open(logdir / name) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("aten::mm" in str(e.get("name", "")) for e in events)


def test_profiler_trace_falsy_is_a_no_op(tmp_path):
    for logdir in (None, ""):
        with tvlog.profiler_trace(logdir):
            torch.ones(3).sum()
    assert os.listdir(tmp_path) == []
