"""Re-derive roofline terms from stored dry-run records -- lets the
HBM / collective cost model evolve without rerunning the cells (port of
``repro.launch.reanalyze``; the port stores each cell's op record,
``<stem>.ops.xz``, where the reference stores its optimized HLO).

    PYTHONPATH=src python -m repro_torch.launch.reanalyze results/dryrun_torch
"""
from __future__ import annotations

import json
import lzma
import os
import sys

from .roofline import roofline_terms

_MEMORY = ("argument_size_in_bytes", "output_size_in_bytes")


def reanalyze_cell(stem: str) -> dict:
    with open(stem + ".json") as f:
        terms = json.load(f)
    with open(stem + ".ops.xz", "rb") as f:
        record = json.loads(lzma.decompress(f.read()))
    chips = terms["chips"]
    terms.update(roofline_terms(
        record, terms["model_flops_per_device"] * chips, chips,
        {k: terms[k] for k in _MEMORY if k in terms}))
    with open(stem + ".json", "w") as f:
        json.dump(terms, f, indent=2, default=str)
    return terms


def main(dirpath: str):
    stems = sorted(set(
        os.path.join(dirpath, fn[:-len(".ops.xz")])
        for fn in os.listdir(dirpath) if fn.endswith(".ops.xz")))
    for s in stems:
        t = reanalyze_cell(s)
        print(f"{os.path.basename(s):55s} {t['dominant']:10s} "
              f"bound={t['roofline_bound_s']:.4g}s "
              f"roofline={100*t['roofline_fraction']:.2f}%")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "results/dryrun_torch")
