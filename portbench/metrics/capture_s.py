"""capture_s (layer: PCG loop (set-up)): host seconds of the program's
``loop.first_block`` and ``loop.capture`` spans in set-up: each loop's
first block, run eagerly, and the CUDA graph captured of it
(``lib/spans.py``)."""
from portbench.lib import spans


def read(run):
    got = spans.in_setup(run, ("loop.first_block", "loop.capture"))
    return spans.seconds(got) if got else None
