"""Fixtures of the benchmark's CPU tests: tiny configurations of the cells,
run on the CPU through the harness (``run_cell``), which skips only the
look for a card.  The standby cells (``service_cell.json``: the service
entry, mix and metrics, in place for a later cell) run from a copy of
``BENCHMARK.json`` that adds them."""
from __future__ import annotations

import atexit
import functools
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench.lib import harness, spec  # noqa: E402

#: grid or node count of each matrix family at test size
TINY = {"fem2d_p1_lognormal": {"nx": 24, "ny": 24},
        "graph_laplacian": {"n": 600}}

#: cells whose files are in place but which ``BENCHMARK.json`` does not run
#: (PERF.md, open questions): their entries, merged into a copy of it
STANDBY = json.loads((Path(__file__).parent / "service_cell.json").read_text())


def _with_standby(bench: dict) -> dict:
    bench = json.loads(json.dumps(bench))
    bench["workloads"] += STANDBY["workloads"]
    for kind in ("end_to_end", "per_layer"):
        have = {m["name"]: m for m in bench[kind]}
        for m in STANDBY[kind]:
            if m["name"] in have:
                have[m["name"]]["workloads"] += m["workloads"]
            else:
                bench[kind].append(m)
    return bench


BENCH = spec.load_benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]
ALL_CELLS = CELLS + [w["name"] for w in STANDBY["workloads"]]


@functools.cache
def _standby_root() -> Path:
    """A root whose ``BENCHMARK.json`` adds the standby cells, beside links
    to this checkout's ``portbench/`` and ``src/``."""
    root = Path(tempfile.mkdtemp(prefix="portbench_standby_"))
    atexit.register(shutil.rmtree, root, True)
    (root / "BENCHMARK.json").write_text(json.dumps(_with_standby(BENCH)))
    for name in ("portbench", "src"):
        (root / name).symlink_to(ROOT / name)
    return root


def root_of(workload: str) -> Path:
    return ROOT if workload in CELLS else _standby_root()


def cell_of(workload: str) -> dict:
    return spec.cell(spec.load_benchmark(root_of(workload)), workload)


def tiny_config(workload: str, dtype: str = "float64") -> dict:
    config = spec.load_json_path(ROOT / cell_of(workload)["config"]["file"])
    config["matrix"].update(TINY[config["matrix"]["family"]])
    config["plan"]["dtype"] = dtype
    return config


def run_tiny(workload: str, seed: int = 2**33 + 7, seconds: float = 1.0,
             traced: bool = False, dtype: str = "float64",
             device: str = "cpu") -> dict:
    return harness.run_cell(workload, seed, seconds, traced, device,
                            time.perf_counter(), root=root_of(workload),
                            config=tiny_config(workload, dtype))


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"
