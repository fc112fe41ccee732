"""iters.solve (layer: PCG loop): mean PCG iterations of the solves in the
window, as the program reports them."""


def read(run):
    if not run.requests:
        return None
    return sum(r.iterations for r in run.requests) / len(run.requests)
