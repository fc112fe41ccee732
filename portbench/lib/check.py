"""The comparison that decides ``correct``: the reference judges the answers
the window produced.

Two numbers, each with its limit from the configuration's ``limits``
(``value <= limit`` passes):

``not_converged``
    requests completed in the window whose status is not CONVERGED
    (limit 0: every right-hand side is a healthy N(0, 1) vector, and the
    program's own stopping test is its recursive residual below ``rtol``).
``true_relres_max``
    the largest true relative residual among the answers sampled from the
    seed (``harness.CHECKED`` of them, drawn uniformly among all answers due
    in the window).  The limit lies between the program's readings and
    the control's (PERF.md).  None (fails) when no answer came.
"""
from __future__ import annotations

import sys

from ..reference.residual import true_relres


def compare(run, a, rhs) -> dict:
    kept = run.sample.kept if run.sample is not None else []
    worst = max((true_relres(a, rhs(k), x) for k, x in kept), default=None)
    if worst is not None and worst == float("inf"):
        worst = sys.float_info.max
    limits = run.config["limits"]
    return {
        "not_converged": {"value": sum(r.status != "CONVERGED"
                                       for r in run.requests),
                          "limit": limits["not_converged"]},
        "true_relres_max": {"value": worst,
                            "limit": limits["true_relres_max"]},
    }


def passed(checks: dict) -> bool:
    return all(c["value"] is not None and c["value"] <= c["limit"]
               for c in checks.values())
