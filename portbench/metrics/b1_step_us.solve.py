"""b1_step_us.solve (layer: round-major apply): device microseconds of one
step of B1 (``segment_single``), the traced time of its kernels over the
applies they ran times the steps of the fused table.

The applies are counted from the trace: B1's launches over the launches of
one apply (the fused table's segments).  The table's steps and segments
are the program's own record of what set-up analysed
(``repro_torch.kernels.segments.analysed()``).  None where the program
keeps no such record, or where set-up analysed no fused table or fused
tables of more than one shape.
"""
from portbench.lib import roofline

B1 = ("segment_single",)


def read(run):
    from repro_torch.kernels import segments
    analysed = getattr(segments, "analysed", None)
    t = run.device_trace
    if analysed is None or t is None:
        return None
    fused = {(r.steps, r.lanes, r.k, r.segments) for r in analysed()
             if r.fused}
    if len(fused) != 1:
        return None
    ((steps, _, _, per_apply),) = fused
    launches = [e - s for s, e, name in t.device
                if roofline.is_kernel_of(name, B1)]
    if not launches or steps == 0:
        return None
    applies = len(launches) / per_apply
    return sum(launches) / (applies * steps)        # the trace is in us
