"""The twins of the examples (``repro_torch.examples``) against the
reference examples (``examples/*.py``), on the CPU.

Each reference example is loaded by path and its ``main()`` run once per
module with its stdout captured; the reference API calls it makes (its
``solve_iccg``, its plan's ``solve``, its service's ``drain``) are recorded
on the way, so the floats it prints with two to four digits are compared at
full precision from the example's own run.  Where the twin takes the port's
default SpMV format (``"sell"``) and the reference example its own
(``"ell"``), the reference example runs a second time with
``spmv_format="sell"`` and the twin is held to both.  Tolerances: counts,
colors, rounds, occupancy and cache statistics equal; solutions and field
energies rel 1e-10 (f64; PyTorch and XLA sum the dots in different orders);
the recurrence's two results within 1e-12 of the sequential one.
"""
import contextlib
import functools
import importlib.util
import io
import re
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import build_plan as j_build_plan
from repro.core import solve_iccg as j_solve_iccg
from repro.core import solve_iccg_batched as j_solve_iccg_batched
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.examples import (iccg_fem, quickstart, rnn_as_trisolve,
                                  serve_lm, serve_solver, timestepping)

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-10


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _recording(fn, calls: list):
    @functools.wraps(fn)
    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        calls.append(out)
        return out
    return wrapped


def _run(mod, argv=()) -> str:
    """``mod.main()`` with ``sys.argv`` set to ``argv``; its stdout."""
    saved = sys.argv
    sys.argv = [mod.__file__, *argv]
    try:
        with contextlib.redirect_stdout(io.StringIO()) as out:
            mod.main()
    finally:
        sys.argv = saved
    return out.getvalue()


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _twin(main, argv=(), device: str | None = "cpu") -> dict:
    """A twin's ``main`` with its stdout captured (``device=None``: the
    twin's default device)."""
    flag = [] if device is None else ["--device", device]
    with contextlib.redirect_stdout(io.StringIO()):
        return main([*flag, *argv])


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------

def _quickstart_reference(spmv_format: str | None) -> tuple[str, list]:
    mod = _load("quickstart")
    calls: list = []
    fmt = {} if spmv_format is None else {"spmv_format": spmv_format}
    mod.solve_iccg = _recording(functools.partial(j_solve_iccg, **fmt),
                                calls)
    mod.solve_iccg_batched = _recording(
        functools.partial(j_solve_iccg_batched, **fmt), calls)
    return _run(mod), calls


@pytest.fixture(scope="module")
def quick():
    """(reference stdout, its reports with ELL, its reports with SELL, the
    twin's dict)."""
    out, ell = _quickstart_reference(None)
    _, sell = _quickstart_reference("sell")
    return out, ell, sell, _twin(quickstart.main)


def test_quickstart_counts_colors_rounds_equal_the_reference(quick):
    out, ell, sell, twin = quick
    rows = re.findall(r"(\w+)\s*:\s+(\d+) iterations, relres \S+, (\d+) "
                      r"colors, (\d+) sequential rounds, lane occupancy "
                      r"([\d.]+)%", out)
    assert [r[0] for r in rows] == ["mc", "bmc", "hbmc"]
    for (method, its, colors, rounds, occ), rep_e, rep_s in zip(
            rows, ell[:3], sell[:3]):
        got = twin[method]
        assert got["iterations"] == int(its) == rep_e.result.iterations \
            == rep_s.result.iterations, method
        assert got["n_colors"] == int(colors) == rep_s.n_colors
        assert got["n_rounds"] == int(rounds) == rep_s.n_rounds
        assert got["lane_occupancy"] == rep_s.lane_occupancy
        assert f"{got['lane_occupancy'] * 100:.1f}" == occ
    assert twin["n"] == 4096 and twin["nnz"] == 20224
    # BMC and HBMC iterate identically (the paper's equivalence theorem)
    assert twin["bmc"]["iterations"] == twin["hbmc"]["iterations"] == 42


def test_quickstart_routes_and_batched_equal_the_reference(quick):
    out, ell, sell, twin = quick
    pallas = int(re.search(r"pallas backend: (\d+) iterations", out)[1])
    assert twin["plain"]["iterations"] == twin["hbmc"]["iterations"] \
        == pallas
    its = [int(v) for v in re.search(r"per-RHS iterations \[([\d ]+)\]",
                                     out)[1].split()]
    steps = int(re.search(r"in (\d+) loop steps", out)[1])
    got = twin["batched"]
    assert got["iterations"].tolist() == its == \
        sell[-1].result.iterations.tolist() == [42, 42, 42, 41]
    assert got["n_steps"] == steps == sell[-1].result.n_steps
    assert got["converged"] and "converged: True" in out


def test_quickstart_solutions_match_the_reference(quick):
    _, ell, sell, twin = quick
    for method, rep in zip(("mc", "bmc", "hbmc"), sell[:3]):
        assert _rel(twin[method]["x"], rep.x) < RTOL, method
    assert _rel(twin["plain"]["x"], sell[2].x) < RTOL
    assert _rel(twin["batched"]["x"], sell[-1].x) < RTOL
    # the reference's own ELL run reaches the same solution
    assert _rel(twin["hbmc"]["x"], ell[2].x) < 1e-8


# ---------------------------------------------------------------------------
# iccg_fem
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fem():
    """Per scale: (reference stdout, its reports, the twin's dict)."""
    done = {}

    def get(scale: str):
        if scale not in done:
            mod = _load("iccg_fem")
            calls: list = []
            mod.solve_iccg = _recording(j_solve_iccg, calls)
            out = _run(mod, ["--scale", scale])
            done[scale] = out, calls, _twin(iccg_fem.main,
                                            ["--scale", scale])
        return done[scale]
    return get


@pytest.mark.parametrize("scale, want", [("tiny", [28, 30, 30, 30]),
                                         ("small", [43, 45, 45, 45])])
def test_iccg_fem_rows_equal_the_reference(fem, scale, want):
    out, reps, twin = fem(scale)
    rows = re.findall(r"^(\w+)\((\w+)_spmv\)\s+(\d+)", out, re.M)
    assert [f"{m}/{f}" for m, f, _ in rows] == \
        [r["solver"] for r in twin["rows"]] == \
        ["mc/ell", "bmc/ell", "hbmc/ell", "hbmc/sell"]
    assert [r["iterations"] for r in twin["rows"]] == \
        [int(i) for _, _, i in rows] == \
        [rep.result.iterations for rep in reps] == want
    assert twin["n"] == reps[0].n and twin["shift"] == 0.3
    for row, rep in zip(twin["rows"], reps):
        assert row["status"] == rep.result.status == "CONVERGED"
        assert _rel(row["x"], rep.x) < RTOL, row["solver"]
        assert row["relres"] < 1e-7


# ---------------------------------------------------------------------------
# timestepping
# ---------------------------------------------------------------------------

def _timestepping_reference(spmv_format: str | None) -> tuple[str, list]:
    mod = _load("timestepping")
    calls: list = []
    fmt = {} if spmv_format is None else {"spmv_format": spmv_format}

    def build(*args, **kw):
        plan = j_build_plan(*args, **kw, **fmt)
        plan.solve = _recording(plan.solve, calls)
        return plan

    mod.build_plan = build
    mod.solve_iccg = functools.partial(j_solve_iccg, **fmt)
    return _run(mod), calls


@pytest.fixture(scope="module")
def stepping():
    out, ell = _timestepping_reference(None)
    _, sell = _timestepping_reference("sell")
    return out, ell, sell, _twin(timestepping.main)


def test_timestepping_iterations_and_energy_equal_the_reference(stepping):
    out, ell, sell, twin = stepping
    lo, hi = (int(v) for v in
              re.search(r"iterations/step (\d+)\.\.(\d+)", out).groups())
    assert twin["iterations"] == [r.result.iterations for r in ell] == \
        [r.result.iterations for r in sell]
    assert (min(twin["iterations"]), max(twin["iterations"])) == (lo, hi) \
        == (5, 6)
    energy = float(re.search(r"energy drained to ([\d.]+)", out)[1])
    assert f"{twin['energy']:.4f}" == f"{energy:.4f}" == "24.9423"
    assert twin["energy"] == pytest.approx(np.linalg.norm(sell[-1].x),
                                           rel=RTOL)
    assert _rel(twin["u"], sell[-1].x) < RTOL
    assert twin["refactor_s"] is not None and twin["cold_s"] > 0


# ---------------------------------------------------------------------------
# serve_solver
# ---------------------------------------------------------------------------

def _serve_reference(spmv_format: str | None) -> tuple[str, list]:
    mod = _load("serve_solver")
    drains: list = []
    fmt = {} if spmv_format is None else {"spmv_format": spmv_format}

    class Recording(mod.SolverService):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw, **fmt)

        def drain(self, *args, **kw):
            done = super().drain(*args, **kw)
            drains.append(done)
            return done

    mod.SolverService = Recording
    return _run(mod), drains


@pytest.fixture(scope="module")
def served():
    out, ell = _serve_reference(None)
    _, sell = _serve_reference("sell")
    return out, ell, sell, _twin(serve_solver.main)


def test_serve_solver_cache_and_steps_equal_the_reference(served):
    out, ell, sell, twin = served
    hits, misses, refactors = (int(v) for v in re.search(
        r"cache: (\d+) hits, (\d+) miss, (\d+) refactor", out).groups())
    assert (twin["hits"], twin["misses"], twin["refactors"]) == \
        (hits, misses, refactors) == (14, 1, 1)
    assert f"{twin['hit_rate']:.2f}" == re.search(r"hit rate ([\d.]+)",
                                                  out)[1]
    steps = re.findall(r"step (\d+): (\d+) solves, iterations \[([\d, ]+)\]"
                       r", plan \[([^\]]*)\]", out)
    assert len(steps) == len(twin["steps"]) == 8
    for (_, solves, its, plan), got, done in zip(steps, twin["steps"],
                                                 sell):
        assert got["solves"] == int(solves)
        assert got["iterations"] == [int(i) for i in its.split(",")] == \
            sorted({c.iterations for c in done})
        assert got["plan"] == re.findall(r"'(\w+)'", plan)


def test_serve_solver_fields_match_the_reference(served):
    out, ell, sell, twin = served
    fields = {}
    for done in sell:
        fields.update({c.tag: c.x for c in done})
    for c, f in enumerate(twin["fields"]):
        assert _rel(f, fields[c]) < RTOL, c
    energy = np.mean([np.linalg.norm(fields[c]) for c in sorted(fields)])
    assert twin["energy"] == pytest.approx(energy, rel=RTOL)
    assert f"{twin['energy']:.4f}" == \
        re.search(r"mean field energy: ([\d.]+)", out)[1] == "10.8851"


# ---------------------------------------------------------------------------
# rnn_as_trisolve
# ---------------------------------------------------------------------------

def test_rnn_as_trisolve_matches_the_sequential_recurrence():
    out = _run(_load("rnn_as_trisolve"))
    twin = _twin(rnn_as_trisolve.main)
    errs = [float(v) for v in re.findall(r"max\|err\| = (\S+)", out)]
    assert len(errs) == 2 and max(errs) < 1e-12
    assert twin["h_seq"].shape == twin["h_hbmc"].shape == (8, 512)
    assert np.abs(twin["h_hbmc"] - twin["h_seq"]).max() < 1e-12
    assert np.abs(twin["h_scan"] - twin["h_seq"]).max() < 1e-12
    assert twin["err_hbmc"] < 1e-12 and twin["err_scan"] < 1e-12


@pytest.mark.parametrize("t", [1, 2, 3, 7, 8, 9, 512])
def test_doubling_scan_is_the_recurrence(t):
    import torch
    rng = np.random.default_rng(t)
    a, b = rng.uniform(0.5, 0.99, (3, t)), rng.normal(size=(3, t))
    h, want = np.zeros(3), np.zeros((3, t))
    for i in range(t):
        h = a[:, i] * h + b[:, i]
        want[:, i] = h
    got = rnn_as_trisolve.doubling_scan(torch.tensor(a), torch.tensor(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# every twin: --device defaults to the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("twin", [quickstart, iccg_fem, timestepping,
                                  serve_solver, rnn_as_trisolve],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_twins_default_to_the_card(monkeypatch, twin):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _twin(twin.main, device=None)


# ---------------------------------------------------------------------------
# serve_lm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_lm_twin_runs_every_arch_on_the_cpu(arch):
    """Token archs return (batch, new_tokens) ids, the ones
    ``greedy_generate`` gives for the twin's weights and prompt; stub
    frontends return the prefill logits' shape and skip decode."""
    import torch
    from repro_torch.models import init_params
    from repro_torch.serve.step import greedy_generate
    cfg = get_smoke_config(arch)
    twin = _twin(serve_lm.main, ["--arch", arch, "--batch", "3",
                                 "--prompt-len", "12", "--new-tokens", "5"])
    assert twin["arch"] == cfg.name and twin["device"] == "cpu"
    if cfg.takes_embeddings:
        assert twin["tokens"] is None
        assert twin["logits_shape"] == (3, 12, cfg.vocab)
        return
    toks = twin["tokens"]
    assert toks.shape == (3, 5) and toks.min() >= 0 and \
        toks.max() < cfg.vocab
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, size=(3, 12))
    want = greedy_generate(init_params(cfg, 0, device="cpu",
                                       dtype=torch.float32),
                           cfg, prompt, 5, max_len=17,
                           cache_dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(toks, want.numpy())


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "musicgen-medium"])
def test_serve_lm_twin_prints_the_reference_shapes(arch):
    """At the default flags the twin's ids (or prefill logits) have the
    shape the reference example prints."""
    out = _run(_load("serve_lm"), ["--arch", arch])
    twin = _twin(serve_lm.main, ["--arch", arch])
    if get_smoke_config(arch).takes_embeddings:
        shape = re.search(r"prefill logits: \(([\d, ]+)\)", out)[1]
        assert twin["logits_shape"] == tuple(int(v) for v in
                                             shape.split(","))
        assert "decode loop skipped" in out
        return
    ids = out.split("generated token ids:\n", 1)[1].split("tok/s")[0]
    rows = re.findall(r"\[([\d\s]+)\]", ids)
    assert twin["tokens"].shape == (len(rows), len(rows[0].split())) \
        == (4, 24)


def test_serve_lm_twin_defaults_to_the_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _twin(serve_lm.main, device=None)
