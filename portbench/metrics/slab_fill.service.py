"""slab_fill.service (layer: service): mean share of the slab's slots that
hold a request, over the dispatches of the window (the service's
``dispatch_log``)."""


def read(run):
    if not run.dispatches:
        return None
    width = run.facts["slab_width"]
    fill = [sum(r is not None for r in d["rids"]) / width
            for d in run.dispatches]
    return 100.0 * sum(fill) / len(fill)
