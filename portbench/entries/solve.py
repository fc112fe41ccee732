"""Traffic entry ``solve``: one closed-loop caller of ``SolverPlan.solve``.

Set-up builds the plan from the benchmark's matrix (``build_plan`` with
the configuration's knobs) and solves twice: the first solve runs the
segment analysis and captures the PCG block's CUDA graph, the second finds
both.  The window then solves back to back, each on the stream's next
right-hand side, to the configuration's ``rtol``; a solve's time is the
caller's, host embed and extract included.
"""
from __future__ import annotations

import time

from torch.autograd.profiler import record_function

from portbench.lib.harness import Request

WARM_SOLVES = 2


def run(run, a, rhs) -> None:
    from repro_torch.core.plan import build_plan
    plan = build_plan(a, **run.plan_knobs())
    del a
    run.facts["build_s"] = plan.timings.total
    for k in range(WARM_SOLVES):
        plan.solve(rhs(-1 - k), rtol=run.rtol, maxiter=run.maxiter)
    with run.window() as over:
        k = 0
        while not over():
            with record_function("portbench.rhs"):
                b = rhs(k)
            t0 = time.perf_counter()
            with record_function("portbench.solve"):
                rep = plan.solve(b, rtol=run.rtol, maxiter=run.maxiter)
            t1 = time.perf_counter()
            run.requests.append(Request(k, t0, t1, rep.result.iterations,
                                        rep.result.status))
            run.sample.offer(k, rep.x)
            k += 1
