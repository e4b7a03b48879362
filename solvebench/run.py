"""One run of one cell: set-up, a closed-loop window of solves, the traced
measurements (``--trace 1``), the comparison with the plain reference, and
one JSON line.

    python3 -m solvebench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The caller solves the cell's eigenproblem again and again until
``--seconds`` have passed. Each solve is a whole call of the cell's entry
point and ends by reading its eigenvalues to the host. Its start block is
the program's draw from one seed of the workload's fixed pool of starts,
which every run cycles through in an order drawn from ``--seed``: every run
does the same work, as a code that solves the same set of subdomains does,
and the seed changes its order (the warm solve starts from a seed of its
own, the traced solves from the pool's first start). The operand, the preconditioner and the
program's set-up memo are built once, in set-up, with one warm solve of the
cell's own recipe, so every kernel is built and every shape seen before the
window opens.

The eigenvalues of every solve in the window are kept on the host, and the
eigenvectors of a sample of solves drawn from the seed are copied into host
buffers allocated in set-up. Once the window has closed and the peak memory
has been read, one more solve runs under the profiler with the card's
activity alone (``solve_device_s``), and with ``--trace 1`` the traced
solves run; then the program's state is freed and the operand family's
plain reference judges them. The lower-precision control that the limits are held against runs
in ``readings.py``, never here.

Exit codes: 0 with a result line; 2 when the card (or the cell's number of
cards) is missing; 3 when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

from solvebench import registry, yardstick
from solvebench.spans import Spans

#: top-level module names a run may not load (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "dune_eigensolver_tpu")
#: the caches a run keeps, at a fixed path inside the checkout (beside the
#: benchmark's folder)
CACHE_DIR = ".solvebench_cache"


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m solvebench", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="length of the window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules(modules=None) -> list:
    """The top-level names in ``sys.modules`` that a run may not load."""
    names = {k.split(".")[0] for k in (sys.modules if modules is None else modules)}
    return sorted(n for n in names if n in FORBIDDEN)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Run:
    """What one run measured; the metric readers take their numbers from it."""

    cell: str
    workload: dict
    config: dict
    setup_s: float
    window_s: float
    solve_times: list
    iterations: list
    peak_bytes: int
    syncs: object = None  # host syncs of one solve (traced run)
    device_profile: object = None  # trace.Profile of a solve, card activity only
    host_profile: object = None  # trace.Profile of a solve with host ranges
    launches: list = dataclasses.field(default_factory=list)  # spans.Spans.launches


class Card:
    """The card the run measures, or the CPU for the harness's own tests."""

    def __init__(self, torch, device: str):
        self.torch, self.device = torch, torch.device(device)
        self.cuda = self.device.type == "cuda"

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def reset_peak(self):
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats()

    def peak(self) -> int:
        return int(self.torch.cuda.max_memory_allocated()) if self.cuda else 0

    def host_buffer(self, shape, dtype):
        return self.torch.empty(shape, dtype=dtype, pin_memory=self.cuda)

    def describe(self) -> dict:
        if not self.cuda:
            return {"platform": "cpu", "kind": "cpu", "count": 1}
        return {"platform": "gpu", "kind": self.torch.cuda.get_device_name(self.device),
                "count": 1}


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def set_precision(torch, cfg: dict, control: str = "none") -> None:
    """TF32 as the configuration states it, or on for the control
    (``readings.py``)."""
    tf32 = bool(cfg.get("tf32", False)) or control == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def free_program_state(torch) -> None:
    """Drop the program's set-up memo (it holds the operands it is keyed on)
    and return the card's cached blocks."""
    from dune_eigensolver_tpu_torch.solvers import engine

    engine._SETUP_MEMO.clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


@dataclasses.dataclass
class Window:
    """The solves of one window: the seconds and iterations of each that
    returned, its answers, and the count of those that failed."""

    seconds: float
    attempted: int
    times: list
    iterations: list
    answers: list
    failed: int
    peak_bytes: int


class Failures:
    """Solves that raised: each is counted as failed, an answer that never
    came; the first traceback goes to standard error and the run goes on."""

    def __init__(self):
        self.count = 0

    def attempt(self, solve, seed):
        try:
            res = solve(seed)
            return res, res.eigenvalues.cpu()
        except Exception:  # a solve that raises is a failed answer, not a crash
            self.count += 1
            if self.count == 1:
                log("solvebench: a solve raised:\n" + traceback.format_exc())
            return None, None


class Cell:
    """One cell set up once in a process: the operand made from the
    configuration and handed over, the preconditioner, the entry point, one
    warm solve from ``seed`` and the host buffers of the sampled
    eigenvectors. ``setup_s`` is counted from ``t0``."""

    def __init__(self, name: str, seed: int, *, device: str = "cuda",
                 root: Path = registry.ROOT, t0: float = None):
        t0 = time.perf_counter() if t0 is None else t0
        import torch

        self.cache = Path(root).parent / CACHE_DIR
        for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
            os.environ[var] = str(self.cache / sub)
        self.torch, self.name, self.root = torch, name, root
        self.wl = registry.workload(name, root)
        self.cfg = registry.config(self.wl["config"], root)
        self.card = Card(torch, device)
        set_precision(torch, self.cfg)
        family = registry.operands(self.cfg["family"], root)
        self.arrays = family.make(self.cfg, self.card.device)
        ops = family.to_port(self.arrays, self.cfg)
        self.spans = Spans()
        pre = self.wl["precond"]
        factory = self.spans.wrap_inverse(pre["kind"],
                                          registry.precond(pre["kind"], root).factory(pre))
        self.solve = registry.entry(self.wl["entry"], root).build(ops, self.wl["options"], factory)
        self.failures = Failures()
        warm, _ = self.failures.attempt(self.solve, yardstick.derive_seed(seed, 1))
        self.buffers = []
        if warm is not None:
            shape, dtype = tuple(warm.eigenvectors.T.shape), warm.eigenvectors.dtype
            self.buffers = [self.card.host_buffer(shape, dtype)
                            for _ in range(int(self.wl["check"]["vectors"]))]
        del warm
        self.card.sync()
        self.setup_s = time.perf_counter() - t0
        self.reference = None

    def sample(self, seed: int) -> set:
        """The solves of a window whose eigenvectors the reference judges."""
        check = self.wl["check"]
        rng = np.random.default_rng(yardstick.derive_seed(seed, 4))
        return set(rng.choice(int(check["within"]), size=int(check["vectors"]),
                              replace=False).tolist())

    def starts(self, seed: int, shuffle: bool = True):
        """The start seeds of the window's solves, endless: the workload's
        pool of ``pool`` starts (the same for every ``--seed``, so every
        run does the same work), each cycle in an order drawn from
        ``seed`` (in the pool's own order without ``shuffle``)."""
        pool = self.wl["seeding"]
        members = [yardstick.derive_seed(int(pool["pool_seed"]), j) for j in range(int(pool["pool"]))]
        rng = np.random.default_rng(yardstick.derive_seed(seed, 2))
        while True:
            for j in rng.permutation(len(members)) if shuffle else range(len(members)):
                yield members[j]

    def window(self, seed: int, seconds: float) -> Window:
        """Solve again and again until ``seconds`` have passed; every solve
        that starts is run to its end."""
        sampled, buffers = self.sample(seed), list(self.buffers)
        starts = self.starts(seed)
        raised0 = self.failures.count
        times, iters, answers, converged = [], [], [], []
        card = self.card
        card.reset_peak()
        card.sync()
        w0 = time.perf_counter()
        i = 0
        while True:
            t = time.perf_counter()
            res, ev = self.failures.attempt(self.solve, next(starts))
            t1 = time.perf_counter()
            if res is not None:
                times.append(t1 - t)
                iters.append(int(res.iterations))
                converged.append(res.converged)
                ans = {"eigenvalues": ev.numpy().astype(np.float64)}
                if i in sampled:
                    buf = buffers.pop() if buffers else None
                    if buf is not None and tuple(res.eigenvectors.T.shape) == tuple(buf.shape):
                        buf.copy_(res.eigenvectors.T)
                        ans["eigenvectors"] = buf.T
                    else:
                        ans["eigenvectors"] = res.eigenvectors.detach().cpu()
                answers.append(ans)
                del res
            i += 1
            if t1 - w0 >= seconds:
                break
        card.sync()
        failed = self.failures.count - raised0 + sum(1 for a, c in zip(answers, converged)
                              if not (bool(c) and np.isfinite(a["eigenvalues"]).all()))
        w = Window(t1 - w0, i, times, iters, answers, failed, card.peak())
        log(f"window {w.seconds:.3f} s: {i} solves, {len(times)} returned, {failed} failed, "
            f"peak {w.peak_bytes} B")
        return w

    def device_solve(self, run: Run) -> None:
        """One more solve from the pool's first start (the same solve in
        every run), profiled with the card's activity alone: the device
        seconds of ``solve_device_s`` and of the traced run's shares."""
        from solvebench import trace as tr

        solve, s = self.solve, next(self.starts(0, shuffle=False))
        tr.warm_profiler(self.torch)
        run.device_profile = tr.profile_solve(self.torch, lambda: solve(s), cpu=False)
        p = run.device_profile
        log(f"card-only profile: {p.count} device operations, busy {p.busy_s():.6f} s "
            f"of {p.wall_s:.4f} s")

    def traced(self, run: Run) -> None:
        """The traced run's measurements, each on one more solve from the
        pool's first start: its host syncs, and its card activity with the
        host's operations and the harness's ranges."""
        from solvebench import trace as tr

        torch, solve, spans = self.torch, self.solve, self.spans
        s = next(self.starts(0, shuffle=False))
        if self.card.cuda:
            run.syncs = yardstick.count_syncs(torch, lambda: solve(s))
        spans.on = True
        try:
            with spans.kernel_launches():
                run.host_profile = tr.profile_solve(torch, lambda: solve(s), cpu=True)
        finally:
            spans.on = False
        run.launches = spans.launches
        p2 = run.host_profile
        log(f"traced: syncs {run.syncs}; host profile {p2.count} ({p2.linked} linked to a "
            f"launch), wall {p2.wall_s:.3f} s; {len(run.launches)} kernel calls recorded")

    def release(self) -> None:
        """Free the program's state: the entry point, its operands and the
        program's set-up memo. The benchmark's own arrays stay."""
        del self.solve, self.spans
        free_program_state(self.torch)

    def judge(self, w: Window):
        """The checks of a window's answers, each reading of the operand
        family's reference that the workload limits beside its limit, and
        the failed solves; and every reading."""
        ref = registry.reference(self.cfg["family"], self.root)
        t = time.perf_counter()
        readings = ref.check(self.reference_state(), int(self.wl["report"]), self.arrays,
                             w.answers)
        log(f"reference {time.perf_counter() - t:.3f} s over {len(w.answers)} solves, "
            f"{sum('eigenvectors' in a for a in w.answers)} with vectors")
        checks = {"failed": {"value": w.failed, "limit": 0}}
        for name, limit in self.wl["limits"].items():
            checks[name] = {"value": readings.get(name, float("inf")), "limit": limit}
        return checks, readings

    def reference_state(self):
        if self.reference is None:
            ref = registry.reference(self.cfg["family"], self.root)
            self.reference = ref.prepare(self.cfg, int(self.wl["report"]), self.arrays,
                                         self.cache / "reference")
        return self.reference


def is_correct(w: Window, checks: dict) -> bool:
    """Every check within its limit, and some eigenvectors judged."""
    return (any("eigenvectors" in a for a in w.answers)
            and all(c["value"] <= c["limit"] for c in checks.values()))


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             root: Path = registry.ROOT, t0: float = None) -> dict:
    """One run of ``cell``; returns the result line's object (with a
    ``checks`` key last) and leaves nothing of the program on the card."""
    c = Cell(cell, seed, device=device, root=root, t0=t0)
    log(f"setup {c.setup_s:.3f} s; window {seconds} s; sampled solves {sorted(c.sample(seed))}")
    w = c.window(seed, seconds)
    run = Run(cell, c.wl, c.cfg, c.setup_s, w.seconds, w.times, w.iterations, w.peak_bytes)
    if w.times and (trace or c.card.cuda):
        c.device_solve(run)
    if trace and w.times:
        c.traced(run)
    c.release()
    checks, readings = c.judge(w)

    metrics = {}
    for m in registry.cell_metrics(registry.benchmark(root), cell, trace):
        value = registry.metric(m["name"], root).read(run)
        if value is None:
            log(f"solvebench: {m['name']} read nothing")
        else:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = dict(c.card.describe(), memory_peak_bytes=w.peak_bytes)
    out = {"correct": is_correct(w, checks), "attempted": w.attempted, "failed": w.failed,
           "metrics": metrics, "device": dev}
    if trace and run.host_profile is not None:
        dev.update(busy_s=run.device_profile.busy_s(), window_s=run.device_profile.wall_s)
        out["breakdown"] = {"device_ops": run.device_profile.by_name()[:10],
                            "idle_gaps": run.host_profile.idle_gaps()[:10]}
    if c.card.cuda:
        dev["power"] = power_limit()
    out["readings"] = readings  # every reading of the reference, limited or not
    out["checks"] = checks
    return out


def main(argv=None, t0: float = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    import torch

    torch.set_num_threads(1)
    wl = registry.workload(args.workload)
    chips = int(wl.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"solvebench: the cell needs {chips} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t0=t0)
    found = forbidden_modules()  # the window has closed: what the run loaded
    if found:
        log(f"solvebench: JAX or the JAX package was loaded: {', '.join(found)}")
        return 3
    for name, c in out["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}")
    print(json.dumps(out), flush=True)
    return 0
