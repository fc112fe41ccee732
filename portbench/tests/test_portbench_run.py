"""A tiny run on the CPU through the harness prints a line of the contract's
shape; the command refuses to run without a card; no JAX is loaded."""
import json
import os
import subprocess
import sys

import pytest
from conftest import ALL_CELLS, ROOT, cell_of, run_tiny

from portbench.lib import guard

def _shape(line: dict, metric_names: list[str]) -> None:
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert isinstance(line["correct"], bool)
    assert line["attempted"] >= 1 and line["failed"] == 0
    for name, m in line["metrics"].items():
        assert name in metric_names
        assert set(m) == {"value", "unit"} and m["value"] is not None
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line, allow_nan=False)


@pytest.mark.parametrize("workload", ALL_CELLS)
def test_tiny_run_line(workload):
    line = run_tiny(workload, seconds=3.0)
    c = cell_of(workload)
    names = [m["name"] for m in c["end_to_end"]]
    _shape(line, names)
    assert line["correct"], line["checks"]
    # the CPU has no device numbers: peak memory is left out
    assert set(line["metrics"]) == set(names) - {"peak_mem_gib"}
    assert "breakdown" not in line


@pytest.mark.parametrize("workload", ["thermal2.solve", "thermal2.service"])
def test_tiny_traced_line(workload):
    line = run_tiny(workload, seconds=3.0, traced=True)
    c = cell_of(workload)
    _shape(line, [m["name"] for m in c["per_layer"]])
    assert line["correct"], line["checks"]
    assert "window_s" in line["device"] and "busy_s" in line["device"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device records on the CPU: the device's metrics stay silent
    assert not any(k.startswith(("idle_share", "trisolve_roofline",
                                 "spmv_roofline", "vector_ms"))
                   for k in line["metrics"])
    assert "build_s" in line["metrics"]


def test_command_needs_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "thermal2.solve", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ""


def test_guard_compares_whole_top_level_names():
    mods = dict.fromkeys(["repro_torch", "repro_torch.core", "reprox",
                          "repro", "repro.core.plan", "jax.numpy", "jaxlib",
                          "flax.linen", "portbench"])
    assert guard.forbidden_modules(mods) == ["flax.linen", "jax.numpy",
                                             "jaxlib", "repro",
                                             "repro.core.plan"]


def test_a_run_loads_no_jax():
    code = ("import sys, time; sys.path[:0] = ['portbench/tests']; "
            "from conftest import run_tiny; run_tiny('thermal2.solve'); "
            "from portbench.lib import guard; "
            "print(guard.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.cuda
def test_on_the_card(cuda_device):
    for workload in ALL_CELLS:
        line = run_tiny(workload, seconds=1.5, device=cuda_device)
        assert line["correct"] and line["device"]["platform"] == "gpu"
