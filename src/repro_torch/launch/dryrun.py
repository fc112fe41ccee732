"""Multi-pod dry-run: run every (arch x shape) step on the production
meshes as one rank of a fake process group, record its local op stream,
and extract roofline terms (port of ``repro.launch.dryrun``).

The reference forces 512 host devices and compiles each cell; the port
makes a fake process group (``torch.distributed``'s ``"fake"`` backend:
collectives return at once and move nothing) of 256 or 512 ranks in this
process, builds the mesh over it, and runs the step once as rank 0 on
meta DTensors placed by the sharding rules (``launch/input_specs.py``):
nothing is allocated or computed, and ``analysis.op_cost`` counts the
rank's local FLOPs, bytes and collectives.  Run it in a process of its
own (the group lives as long as the process).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b \
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \
        --out results/dryrun_torch
"""
from __future__ import annotations

import argparse
import json
import lzma
import os
import time
import traceback
from functools import partial

import torch

from ..configs import ARCH_IDS, SHAPES, cells, get_config
from ..dist.constraints import use_mesh
from ..serve.step import prefill, serve_step
from ..train.optimizer import AdamWConfig
from ..train.step import train_step
from . import input_specs as ispec
from .mesh import make_production_mesh
from .roofline import roofline_terms

# per-arch training knobs (microbatching for activation pressure)
MICROBATCHES = {"llama3-405b": 16, "qwen2-vl-72b": 8, "mixtral-8x22b": 4,
                "qwen3-14b": 4}
META = torch.device("meta")


def fake_world(size: int) -> None:
    """A fake process group of ``size`` ranks in this process, this
    process rank 0 (kept if one of that size exists)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() != size:
            raise RuntimeError(f"a process group of {dist.get_world_size()}"
                               f" ranks exists; the dry-run needs {size}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def _axes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.mesh.shape)))


def _local_bytes(tree) -> int:
    """Bytes of one rank's shards of every tensor in ``tree``."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(v) for v in tree)
    if isinstance(tree, torch.nn.Module):
        return sum(_local_bytes(p) for p in tree.parameters())
    if isinstance(tree, torch.Tensor):
        t = tree.to_local() if isinstance(tree, DTensor) else tree
        return t.numel() * t.element_size()
    return 0


def lower_cell(arch_id: str, shape_name: str, mesh, *,
               param_dtype=torch.bfloat16) -> tuple[dict, dict]:
    """Run one cell's step as rank 0 under ``analysis.op_cost``; returns
    (the op record, the roofline terms)."""
    from ..analysis.op_cost import op_cost
    cfg = get_config(arch_id)
    spec = SHAPES[shape_name]
    chips = mesh.size()
    params_abs = ispec.abstract_params(cfg, mesh, dtype=param_dtype)

    if spec.kind == "train":
        opt_abs = ispec.abstract_opt_state(params_abs, mesh)
        batch_abs = ispec.train_batch_specs(cfg, mesh, spec.global_batch,
                                            spec.seq_len)
        opt_cfg = AdamWConfig(
            mu_dtype=torch.bfloat16 if arch_id == "llama3-405b"
            else torch.float32)
        mb = MICROBATCHES.get(arch_id, 1)
        # divisibility guard: every microbatch must still split over all
        # DP shards or the step replicates
        dp = chips // _axes(mesh).get("model", 1)
        while mb > 1 and (spec.global_batch // mb) % dp:
            mb //= 2
        fn = partial(train_step, params_abs, opt_abs, batch_abs, cfg=cfg,
                     opt_cfg=opt_cfg, microbatches=mb, device=META)
        args = (params_abs, opt_abs, batch_abs)
        mf = cfg.model_flops(spec.global_batch, spec.seq_len)
    elif spec.kind == "prefill":
        inputs_abs = ispec.prefill_specs(cfg, mesh, spec.global_batch,
                                         spec.seq_len)
        fn = partial(prefill, params_abs, cfg, inputs_abs,
                     max_len=spec.seq_len, device=META)
        args = (params_abs, inputs_abs)
        # prefill = forward-only pass: 2*N*D
        mf = cfg.model_flops(spec.global_batch, spec.seq_len) / 3.0
    else:  # decode
        cache_abs, tokens_abs, pos = ispec.decode_specs(
            cfg, mesh, spec.global_batch, spec.seq_len)
        fn = partial(serve_step, params_abs, cache_abs, tokens_abs, pos,
                     cfg=cfg, device=META)
        args = (params_abs, cache_abs, tokens_abs)
        mf = cfg.model_flops(spec.global_batch, spec.seq_len, decode=True)

    t0 = time.time()
    with use_mesh(mesh):
        out, record = op_cost(fn)
    seconds = time.time() - t0
    memory = {"argument_size_in_bytes": _local_bytes(args),
              # train: the parameters and AdamW state it updates in place
              "output_size_in_bytes": _local_bytes(
                  (params_abs, out) if spec.kind == "train" else out)}
    terms = roofline_terms(record, mf, chips, memory)
    terms.update(arch=arch_id, shape=shape_name, chips=chips,
                 mesh_axes=_axes(mesh),
                 compile_seconds=seconds, kind=spec.kind)
    return record, terms


def run_cell(arch_id, shape_name, mesh_kind, outdir=None, verbose=True):
    multi = mesh_kind == "multi"
    fake_world(512 if multi else 256)
    mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
    record, terms = lower_cell(arch_id, shape_name, mesh)
    if verbose:
        print(f"== {arch_id} x {shape_name} x {mesh_kind} "
              f"({terms['chips']} chips) ==")
        print({k: terms[k] for k in ("argument_size_in_bytes",
                                     "output_size_in_bytes",
                                     "flops_per_device",
                                     "bytes_per_device")})
        print(json.dumps({k: v for k, v in terms.items()
                          if k.startswith(("t_", "dominant", "useful"))},
                         indent=2, default=str))
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        stem = os.path.join(outdir, f"{arch_id}__{shape_name}__{mesh_kind}")
        with open(stem + ".json", "w") as f:
            json.dump(terms, f, indent=2, default=str)
        # the compressed op record: re-derive the roofline terms offline
        # (launch/reanalyze.py) without rerunning the step
        with open(stem + ".ops.xz", "wb") as f:
            f.write(lzma.compress(json.dumps(record).encode()))
    return terms


def print_stack_replicated() -> None:
    """``dist.sharding.stack_replicated_report`` for the ten full configs
    on the two production meshes (stand-ins: no process group)."""
    import types

    import numpy as np

    from ..dist.sharding import stack_replicated_report
    from ..models import param_specs
    for shape, names in (((16, 16), ("data", "model")),
                         ((2, 16, 16), ("pod", "data", "model"))):
        mesh = types.SimpleNamespace(axis_names=names,
                                     devices=np.empty(shape))
        for arch in ARCH_IDS:
            for r in stack_replicated_report(param_specs(get_config(arch)),
                                             mesh):
                print(f"{'x'.join(map(str, shape))} {arch} slot {r['slot']} "
                      f"{r['leaf']} {r['shape']} stack on {r['axis']!r}: "
                      f"+{r['bytes_added']:.0f} bytes a device")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--stack-replicated", action="store_true",
                    help="print the leaves the reference shards over its "
                         "stack dimension (the port replicates them) on the "
                         "production meshes, and exit")
    args = ap.parse_args(argv)
    if args.stack_replicated:
        print_stack_replicated()
        return

    meshes = (("single", "multi") if args.mesh == "both" else (args.mesh,))
    todo = []
    if args.all:
        for arch, shape, skip in cells():
            if skip:
                print(f"SKIP {arch} x {shape} (quadratic attention at 512k; "
                      f"see DESIGN.md §7)")
                continue
            for mk in meshes:
                todo.append((arch, shape, mk))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        todo = [(args.arch, args.shape, mk) for mk in meshes]

    failures = []
    for arch, shape, mk in todo:
        if args.skip_existing and args.out and os.path.exists(
                os.path.join(args.out, f"{arch}__{shape}__{mk}.json")):
            print(f"cached {arch} x {shape} x {mk}")
            continue
        try:
            run_cell(arch, shape, mk, outdir=args.out)
        except Exception as e:      # noqa: BLE001 -- report all cell failures
            traceback.print_exc()
            failures.append((arch, shape, mk, repr(e)))
    if failures:
        print("FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print(f"dry-run OK: {len(todo)} cells")


if __name__ == "__main__":
    main()
