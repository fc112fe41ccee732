"""submit_ms.service (layer: service): mean host time of one
``SolverService.submit`` call in the window (the harness's clock around
each call)."""


def read(run):
    if not run.submit_s:
        return None
    return 1e3 * sum(run.submit_s) / len(run.submit_s)
