"""Twins of the reference's examples (``examples/*.py``), on the port.

Each keeps its reference's sizes, seeds, printed rows and flags, adds
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain versions)
and returns what it prints from ``main(argv=None) -> dict``.  Run one as

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

with ``quickstart``, ``iccg_fem``, ``timestepping``, ``serve_solver``,
``rnn_as_trisolve``, ``serve_lm`` or ``train_lm``.
"""


def device_parser(description: str):
    """An argument parser with the twins' common ``--device`` flag."""
    import argparse
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the kernels) or cpu (their "
                         "plain versions); default cuda")
    return ap
