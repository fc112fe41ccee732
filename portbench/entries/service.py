"""Traffic entry ``service``: closed-loop clients of one ``SolverService``.

The service runs on a ``WallClock`` with the mix's ``slab_width`` and
``quantum`` and the configuration's plan knobs and tolerance, recording
its dispatches.  Each of ``clients`` clients submits the same matrix
object with the stream's next right-hand side as soon as its previous
request has completed; one thread submits and steps the service, as a
front end over it would.  Set-up runs this loop (the first plan build,
the graph captures of the slab step) until ``warm_completions`` requests
have completed, and the window continues it: a request counts where it
completes inside the window, its latency from the start of its ``submit``
call to the end of the ``step`` that returned it.
"""
from __future__ import annotations

import time

from torch.autograd.profiler import record_function

from portbench.lib.harness import Request

#: a service that completes too few requests in this long fails the run
WARM_LIMIT_S = 240.0


def run(run, a, rhs) -> None:
    from repro_torch.serve import SolverService, WallClock
    t = run.traffic
    svc = SolverService(slab_width=int(t["slab_width"]),
                        quantum=int(t["quantum"]), rtol=run.rtol,
                        maxiter=run.maxiter, clock=WallClock(),
                        record_dispatches=True, **run.plan_knobs())
    run.facts["slab_width"] = svc.slab_width
    waiting: dict[int, tuple[int, float]] = {}   # rid -> (index, submitted)
    k = 0

    def submit(keep: bool) -> None:
        nonlocal k
        with record_function("portbench.rhs"):
            b = rhs(k)
        t0 = time.perf_counter()
        with record_function("portbench.submit"):
            rid = svc.submit(a, b)
        if keep:
            run.submit_s.append(time.perf_counter() - t0)
        waiting[rid] = (k, t0)
        k += 1

    def step(keep: bool) -> int:
        """One service step; each completed client submits again."""
        with record_function("portbench.step"):
            done = svc.step()
        t_done = time.perf_counter()
        for c in done:
            index, t_submit = waiting.pop(c.rid)
            if keep:
                run.requests.append(Request(index, t_submit, t_done,
                                            c.iterations, c.status))
                if c.x is not None:
                    run.sample.offer(index, c.x)
            submit(keep)
        return len(done)

    for _ in range(int(t["clients"])):
        submit(False)
    warm, t_warm = 0, time.perf_counter()
    while warm < int(t["warm_completions"]):
        if time.perf_counter() - t_warm > WARM_LIMIT_S:
            raise RuntimeError(f"{warm} requests completed in "
                               f"{WARM_LIMIT_S} s of warm-up")
        warm += step(False)
    first = len(svc.dispatch_log)
    with run.window() as over:
        while not over():
            step(True)
    run.dispatches = svc.dispatch_log[first:]
    plan, _ = svc.cache.get(a, **svc.plan_knobs)
    run.facts["build_s"] = plan.timings.total
