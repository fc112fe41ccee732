"""``BENCHMARK.json`` and the files it names, found by name.

Everything that belongs to one configuration, traffic mix, matrix family,
traffic entry or per-layer metric sits in a file of its own under
``portbench/``; a later cell, mix or metric is new files plus new entries
in ``BENCHMARK.json``, never an edit here:

    configs/<config>.json       sizes, plan knobs, tolerance, source
    matrices/<family>.py        ``make(params, rng) -> scipy CSR``
    traffic/<mix>.json          parameters read by ``entries/<entry>.py``
    entries/<entry>.py          ``run(run, a, rhs)``: set-up and window
    metrics/<metric>.py         ``read(run) -> float | None``
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _checked(name: str) -> str:
    if not _NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str, bench_dir: Path = BENCH_DIR) -> dict:
    """``<kind>/<name>.json`` (``traffic``)."""
    return load_json_path(bench_dir / kind / f"{_checked(name)}.json")


def load_json_path(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_module(kind: str, name: str,
                bench_dir: Path = BENCH_DIR) -> ModuleType:
    """``<kind>/<name>.py`` (``matrices``, ``entries``, ``metrics``),
    imported from its path: a metric's name may hold dots."""
    path = bench_dir / kind / f"{_checked(name)}.py"
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell(bench: dict, workload: str) -> dict:
    """The workload entry named ``workload`` with its configuration entry
    and the metric entries it reports (``end_to_end``, ``per_layer``)."""
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = found[0]

    def reports(metric: dict) -> bool:
        return workload in metric.get("workloads", [workload])

    return {
        "workload": w,
        "config": next(c for c in bench["configs"] if c["name"] == w["config"]),
        "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
        "per_layer": [m for m in bench["per_layer"] if reports(m)],
    }
