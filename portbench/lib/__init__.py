"""The harness: what every cell shares (see ``spec`` for the layout)."""
