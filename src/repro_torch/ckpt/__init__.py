"""Step-atomic checkpoints (port of ``repro.ckpt``)."""
