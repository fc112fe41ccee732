"""The port's dry-run (``repro_torch.launch``) and its cost model
(``repro_torch.analysis.op_cost``) against the reference's
``repro.launch``.

A fake process group lives as long as its process, so everything that
needs one runs in a subprocess (``python -c`` or the CLI), never in the
test process.  Checked: ``op_cost`` on a hand-counted product on a fake
(16, 16) mesh (sharded TP + FSDP it counts 1/256 of the global FLOPs,
replicated all of them); ``roofline_terms``' keys against the
reference's; one cell through the CLI, whose JSON ``reanalyze``
reproduces from the stored op record; and ``model_flops_per_device``
against the reference's formula.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import pytest

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.launch.roofline import roofline_terms as j_roofline_terms
from repro_torch.launch.roofline import roofline_terms

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the cheapest cell: 24 layers, one decode token per sequence
CELL = ("mamba2-130m", "decode_32k")
#: keys of the reference's record that only a compiler reports: XLA's raw
#: cost analysis, and its temporaries and generated code
XLA_ONLY = {"cost_analysis_flops_raw", "cost_analysis_bytes_raw",
            "temp_size_in_bytes", "generated_code_size_in_bytes"}


def _run(args, timeout=300) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable] + args, env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out.stdout


def test_op_cost_counts_local_work():
    """(128 x 2048) . (2048 x 11008): with x sharded over data and w by
    the greedy rule (TP + FSDP) one rank counts 2 M N K / 256 FLOPs and
    the collectives DTensor issues; replicated, 2 M N K and none."""
    code = textwrap.dedent("""
        import json, warnings
        warnings.filterwarnings("ignore")
        import torch
        from repro_torch.launch.dryrun import fake_world
        from repro_torch.launch.mesh import make_production_mesh
        from repro_torch.analysis.op_cost import op_cost
        from repro_torch import dist as D
        fake_world(256)
        mesh = make_production_mesh(device_type="cpu")
        def put(shape, spec):
            t = torch.empty(shape, device="meta")
            return D.distribute(t, D.NamedSharding(mesh, spec(t)))
        x = put((128, 2048), lambda t: D.batch_partition_spec(mesh, 128, 2))
        w = put((2048, 11008), lambda t: D.param_partition_spec("w", t, mesh))
        _, sharded = op_cost(lambda: x @ w)
        xr = put((128, 2048), lambda t: (None, None))
        wr = put((2048, 11008), lambda t: (None, None))
        _, replicated = op_cost(lambda: xr @ wr)
        print(json.dumps({"sharded": sharded, "replicated": replicated,
                          "w": str(w.placements), "x": str(x.placements)}))
    """)
    got = json.loads(_run(["-c", code]).strip().splitlines()[-1])
    flops = 2 * 128 * 2048 * 11008
    assert got["w"] == "(Shard(dim=0), Shard(dim=1))"
    assert got["x"] == "(Shard(dim=0), Replicate())"
    assert got["sharded"]["flops"] == flops / 256
    assert got["sharded"]["ops"]["aten.mm"] == 1
    assert sum(got["sharded"]["collective_counts"].values()) >= 1
    assert got["sharded"]["collective_wire_bytes"] > 0
    assert got["replicated"]["flops"] == flops
    assert got["replicated"]["collective_counts"] == {}
    # operands plus result, f32
    assert got["replicated"]["bytes"] == 4 * (128 * 2048 + 2048 * 11008
                                              + 128 * 11008)


def test_roofline_terms_keys_match_the_reference():
    """The port's record has the reference's keys but those only XLA
    reports (``XLA_ONLY``)."""
    compiled = jax.jit(lambda a, b: a @ b).lower(
        jnp.ones((64, 32)), jnp.ones((32, 16))).compile()
    ref = j_roofline_terms(compiled, 1e9, 1)
    record = {"flops": 65536.0, "bytes": 14336.0,
              "collective_wire_bytes": 0.0, "collective_bytes_by_kind": {},
              "collective_counts": {}}
    got = roofline_terms(record, 1e9, 1, {"argument_size_in_bytes": 1,
                                          "output_size_in_bytes": 1})
    assert set(got) == set(ref) - XLA_ONLY
    assert got["dominant"] in ("compute", "memory", "collective")
    assert got["roofline_bound_s"] == max(
        got["t_compute_s"], got["t_memory_s"], got["t_collective_s"])


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun"))
    log = _run(["-m", "repro_torch.launch.dryrun", "--arch", CELL[0],
                "--shape", CELL[1], "--mesh", "single", "--out", out])
    return out, log


def test_dryrun_cell_through_the_cli(cell):
    """One cell: the JSON has the reference's keys (but XLA's) and the
    cell's bookkeeping, the op record is stored, and the step ran on the
    (16, 16) mesh's local shards."""
    out, log = cell
    assert "dry-run OK: 1 cells" in log
    stem = os.path.join(out, f"{CELL[0]}__{CELL[1]}__single")
    terms = json.load(open(stem + ".json"))
    assert os.path.exists(stem + ".ops.xz")
    record = {"flops": 1.0, "bytes": 1.0, "collective_wire_bytes": 0.0,
              "collective_bytes_by_kind": {}, "collective_counts": {}}
    keys = set(roofline_terms(record, 1.0, 1, {
        "argument_size_in_bytes": 0, "output_size_in_bytes": 0}))
    assert keys | {"arch", "shape", "chips", "mesh_axes", "compile_seconds",
                   "kind"} == set(terms)
    assert terms["chips"] == 256 and terms["mesh_axes"] == {"data": 16,
                                                            "model": 16}
    assert terms["kind"] == "decode" and terms["flops_per_device"] > 0
    assert 0 < terms["argument_size_in_bytes"] < 1e9


def test_reanalyze_reproduces_the_cell(cell):
    out, _ = cell
    stem = os.path.join(out, f"{CELL[0]}__{CELL[1]}__single")
    before = json.load(open(stem + ".json"))
    _run(["-m", "repro_torch.launch.reanalyze", out])
    assert json.load(open(stem + ".json")) == before


@pytest.mark.parametrize("shape", list(J_SHAPES))
def test_model_flops_per_device_is_the_reference_formula(cell, shape):
    """``model_flops_per_device`` = the reference's ``cfg.model_flops``
    (train 6 N D, prefill a third of it, decode 2 N per token) / chips:
    the stored cell, and the port's configs against the reference's for
    every shape."""
    from repro_torch.configs import SHAPES, get_config
    spec = SHAPES[shape]
    for arch in ("olmoe-1b-7b", "qwen2.5-3b", CELL[0]):
        want = j_get_config(arch).model_flops(
            spec.global_batch, spec.seq_len, decode=spec.kind == "decode")
        got = get_config(arch).model_flops(
            spec.global_batch, spec.seq_len, decode=spec.kind == "decode")
        assert got == want
    out, _ = cell
    terms = json.load(open(os.path.join(
        out, f"{CELL[0]}__{CELL[1]}__single.json")))
    s = J_SHAPES[CELL[1]]
    assert terms["model_flops_per_device"] == j_get_config(
        CELL[0]).model_flops(s.global_batch, s.seq_len, decode=True) / 256
