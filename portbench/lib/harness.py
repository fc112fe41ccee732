"""One run of one cell: inputs from the seed, the entry's set-up and
window, the check against the reference, and the result line.

``run_cell`` is the whole run but the look for a card; ``run.py`` looks
for the card and calls it.  The CPU tests call it with ``device="cpu"``
on a tiny configuration.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from pathlib import Path

import numpy as np

from . import check, guard, spec, trace
from .rhs import RhsStream, seed_sequence

#: the traced window is at most this long, so that reading the trace fits a
#: run's time (a solve cell puts some 10^5 device records into a second)
TRACE_SECONDS = 4.0
#: answers the reference checks, drawn from the seed among those due in
#: the window
CHECKED = 16


@dataclasses.dataclass
class Request:
    index: int            # the right-hand side's index in the stream
    t_submit: float       # host clock: the call that hands it over
    t_done: float         # host clock: its answer in the caller's hands
    iterations: int
    status: str


class Sample:
    """A uniform sample of ``size`` answers from a stream of unknown
    length (reservoir sampling), drawn from the seed."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.kept: list[tuple[int, np.ndarray]] = []
        self.seen = 0
        self._rng = np.random.default_rng(seed_sequence(seed, 2))

    def offer(self, index: int, x: np.ndarray) -> None:
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept.append((index, x))
            return
        j = int(self._rng.integers(0, self.seen))
        if j < self.size:
            self.kept[j] = (index, x)


@dataclasses.dataclass
class Run:
    """What a run knows; the entry fills the window's part, the metric
    readers read it."""
    workload: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    traced: bool
    device: object
    t_process: float
    facts: dict = dataclasses.field(default_factory=dict)
    requests: list = dataclasses.field(default_factory=list)
    submit_s: list = dataclasses.field(default_factory=list)
    dispatches: list = dataclasses.field(default_factory=list)
    setup_s: float = 0.0
    window_s: float = 0.0
    peak_bytes: int = 0
    device_trace: trace.DeviceTrace | None = None
    sample: Sample | None = None

    @property
    def rtol(self) -> float:
        return float(self.config["rtol"])

    @property
    def maxiter(self) -> int:
        return int(self.config["maxiter"])

    def plan_knobs(self) -> dict:
        """The configuration's plan, as ``build_plan`` keywords."""
        import torch
        knobs = dict(self.config["plan"])
        knobs["dtype"] = getattr(torch, knobs["dtype"])
        knobs["device"] = self.device
        return knobs

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def window(self):
        """The measured window.  Set-up ends where it opens; under
        ``--trace 1`` the profiler records it, and it lasts at most
        ``TRACE_SECONDS``.  Yields a function that says whether the
        window's time is up.

        Before it opens, set-up's Python objects are collected and then
        frozen (``gc.freeze``), as a long-lived process does after its
        start-up: a collection inside the window then walks only what the
        window made, and not the matrix, plan and library objects of
        set-up, whose number would otherwise set when and how long the
        collector stops a solve.  The program's own garbage is collected
        as usual."""
        from torch.autograd.profiler import record_function
        self.sync()
        length = min(self.seconds, TRACE_SECONDS) if self.traced \
            else self.seconds
        prof = _profiler(self.device) if self.traced else None
        gc.collect()
        gc.freeze()
        if prof is not None:
            prof.__enter__()
        t0 = time.perf_counter()
        self.setup_s = t0 - self.t_process
        try:
            with record_function(trace.WINDOW_RANGE):
                yield lambda: time.perf_counter() - t0 >= length
                self.sync()
                self.window_s = time.perf_counter() - t0
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
            gc.unfreeze()
        if prof is not None:
            self.device_trace = trace.reduce(prof)


def _profiler(device):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def make_matrix(config: dict, seed: int, bench_dir: Path = spec.BENCH_DIR):
    """The configuration's matrix from the run's seed, or from the fixed
    ``seed`` of its ``matrix`` object where the run's seed would change the
    work (a random graph's structure, and so its rounds and tables)."""
    params = config["matrix"]
    family = spec.load_module("matrices", params["family"], bench_dir)
    seed = params.get("seed", seed)
    return family.make(params, np.random.default_rng(seed_sequence(seed, 0)))


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device, t_process: float, *, root: Path = spec.ROOT,
             config: dict | None = None) -> dict:
    """One run; returns the result line as a dict.  ``config`` replaces
    the configuration's file (the control, the tests)."""
    import torch
    bench_dir = root / "portbench"
    bench = spec.load_benchmark(root)
    c = spec.cell(bench, workload)
    if config is None:
        config = spec.load_json_path(root / c["config"]["file"])
    traffic = spec.load_json("traffic", c["workload"]["traffic"], bench_dir)
    device = torch.device(device)
    run = Run(workload=workload, config=config, traffic=traffic, seed=seed,
              seconds=seconds, traced=traced, device=device,
              t_process=t_process)
    run.sample = Sample(CHECKED, seed)

    a = make_matrix(config, seed, bench_dir)
    n = a.shape[0]
    run.facts.update(n=n, nnz=int(a.nnz),
                     nnz_lower=(int(a.nnz) - int(np.count_nonzero(
                         a.diagonal()))) // 2)
    # the reference judges every answer against the float64 stream; a
    # plan of a lower precision gets the stream cast to its dtype
    ref_rhs = RhsStream(n, seed, int(traffic["rhs_bases"]))
    np_dtype = np.dtype(config["plan"]["dtype"])
    rhs = ref_rhs if np_dtype == ref_rhs.bases.dtype else \
        ref_rhs.astype(np_dtype)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    entry = spec.load_module("entries", traffic["entry"], bench_dir)
    # the program gets a copy: the reference keeps its own matrix
    entry.run(run, a.copy(), rhs)
    if device.type == "cuda":
        run.peak_bytes = torch.cuda.max_memory_allocated(device)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    checks = check.compare(run, a, ref_rhs)
    found = guard.forbidden_modules()
    if found:
        raise guard.ForbiddenModules(found)
    metrics = {}
    for m in (c["per_layer"] if traced else c["end_to_end"]):
        value = spec.load_module("metrics", m["name"], bench_dir).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {
        "correct": check.passed(checks),
        "attempted": len(run.requests),
        "failed": sum(r.status != "CONVERGED" for r in run.requests),
        "metrics": metrics,
        "device": _device(run, int(c["workload"]["chips"])),
    }
    if run.device_trace is not None:
        line["breakdown"] = {"device_ops": run.device_trace.by_name(),
                             "idle_gaps": run.device_trace.idle_gaps()}
    line["checks"] = checks
    return line


def _device(run: Run, chips: int) -> dict:
    import torch
    if run.device.type == "cuda":
        out = {"platform": "gpu",
               "kind": torch.cuda.get_device_name(run.device),
               "count": chips, "memory_peak_bytes": int(run.peak_bytes)}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    if run.device_trace is not None:
        out["busy_s"] = run.device_trace.busy_s
        out["window_s"] = run.device_trace.window_s
    return out
