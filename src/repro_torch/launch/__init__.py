"""Drivers (port of ``repro.launch``): ``train``."""
