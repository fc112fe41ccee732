"""Drivers (port of ``repro.launch``): ``train`` (the training loop with
checkpoints), ``dryrun`` (every arch x shape step on the production meshes
as one rank of a fake process group) with ``mesh``, ``input_specs``,
``roofline`` and ``reanalyze``."""
