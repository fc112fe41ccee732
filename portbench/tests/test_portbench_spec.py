"""BENCHMARK.json against the contract's shape, every name found as a file,
and a configuration, a mix and a metric added as new files only, in a
temporary copy."""
import json
import re
import shutil
import subprocess
import sys

import pytest
from conftest import ALL_CELLS, ROOT, TINY, cell_of, spec

BENCH = spec.load_benchmark(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_names():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("workload", ALL_CELLS)
def test_cell_resolves_to_files(workload):
    c = cell_of(workload)
    assert c["workload"]["chips"] in (1, 4)
    assert len(c["workload"]["why"]) <= 200
    config = spec.load_json_path(ROOT / c["config"]["file"])
    assert c["config"]["file"].startswith("portbench/")
    spec.load_module("matrices", config["matrix"]["family"])
    traffic = spec.load_json("traffic", c["workload"]["traffic"])
    assert hasattr(spec.load_module("entries", traffic["entry"]), "run")
    e2e = [m["name"] for m in c["end_to_end"]]
    assert "setup_s" in e2e and len(e2e) >= 2 and c["per_layer"]
    for m in c["end_to_end"] + c["per_layer"]:
        assert hasattr(spec.load_module("metrics", m["name"]), "read")
    for m in c["per_layer"]:
        assert m["moves"] in e2e


def test_added_files_are_found_in_a_copy(tmp_path):
    """A new configuration (its file and matrix family), a new mix and a
    new per-layer metric, added as files and entries only."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "src").symlink_to(ROOT / "src")
    bench = json.loads(json.dumps(BENCH))
    pb = tmp_path / "portbench"
    (pb / "matrices" / "ring.py").write_text(
        "import numpy as np\nimport scipy.sparse as sp\n\n\n"
        "def make(params, rng):\n"
        "    n = int(params['n'])\n"
        "    w = rng.uniform(0.5, 1.0, size=n)\n"
        "    off = sp.diags(-w[:-1], 1, shape=(n, n))\n"
        "    a = off + off.T\n"
        "    d = -np.asarray(a.sum(axis=1)).ravel() + 1e-2\n"
        "    return (a + sp.diags(d)).tocsr()\n")
    config = spec.load_json_path(ROOT / "portbench/configs/thermal2.json")
    config.update(name="ring", matrix={"family": "ring", "n": 400}, n=400)
    (pb / "configs" / "ring.json").write_text(json.dumps(config))
    (pb / "traffic" / "pair.json").write_text(json.dumps(
        {"entry": "solve", "rhs_bases": 2}))
    (pb / "metrics" / "answers.checked.py").write_text(
        "def read(run):\n    return float(len(run.sample.kept)) + 0.5\n")
    bench["configs"].append({"name": "ring", "source": "a test",
                             "file": "portbench/configs/ring.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "ring.pair", "config": "ring",
                               "traffic": "pair", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "answers.checked", "unit": "answers",
                               "better": "higher", "source": "host_clock",
                               "layer": "check", "moves": "solve_ms",
                               "workloads": ["ring.pair"]})
    for m in bench["end_to_end"]:
        if m["name"] == "solve_ms":
            m["workloads"].append("ring.pair")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys, time; from pathlib import Path; "
            f"sys.path[:0] = [{str(tmp_path)!r}, {str(tmp_path / 'src')!r}]; "
            "from portbench.lib import harness; "
            "assert harness.__file__.startswith(sys.path[0]); "
            "print(json.dumps([harness.run_cell('ring.pair', 5, 1.0, t, "
            f"'cpu', time.perf_counter(), root=Path({str(tmp_path)!r})) "
            "for t in (False, True)]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    plain, traced = json.loads(out.stdout.strip().splitlines()[-1])
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"setup_s", "solve_ms"}
    assert traced["metrics"]["answers.checked"]["value"] % 1 == 0.5
    assert "iters.solve" not in traced["metrics"]


def test_tiny_sizes_cover_every_family():
    families = {spec.load_json_path(ROOT / c["file"])["matrix"]["family"]
                for c in BENCH["configs"]}
    assert families <= set(TINY)
