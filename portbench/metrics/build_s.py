"""build_s (layer: host setup): the plan's own clock over its build,
``plan.timings.total`` (ordering, IC(0), packing); in a service cell that
of the plan the service cached."""


def read(run):
    return run.facts.get("build_s")
