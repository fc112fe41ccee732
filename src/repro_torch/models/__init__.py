"""Model zoo: the 10 assigned architectures as one configurable decoder
stack (port of ``repro.models``)."""
from .config import ArchConfig
from .transformer import Model, forward, init_cache, init_params
