"""Abstract stand-ins for every model input (port of
``repro.launch.input_specs``): meta DTensors, no allocation.

Each returns DTensors on the meta device placed by the rules of
``dist.sharding`` on ``mesh``: their global shapes and dtypes are the
reference's, and each holds one rank's local shape.  The dry-run runs the
step on them (``launch/dryrun.py``).
"""
from __future__ import annotations

import torch

from ..dist.sharding import (NamedSharding, batch_partition_spec,
                             cache_partition_spec, distribute,
                             distribute_params, params_shardings)
from ..models import init_cache, param_specs
from ..models.config import ArchConfig
from ..train.optimizer import init_opt_state

META = torch.device("meta")


def _sds(shape, dtype, mesh, spec):
    return distribute(torch.empty(shape, dtype=dtype, device=META),
                      NamedSharding(mesh, spec))


def abstract_params(cfg: ArchConfig, mesh, dtype=torch.bfloat16):
    """The model on the meta device, each parameter a DTensor placed by
    ``params_shardings``."""
    model = param_specs(cfg, dtype=dtype)
    return distribute_params(model, params_shardings(model, mesh))


def abstract_opt_state(params_abs, mesh):
    """AdamW state of ``params_abs``: f32 moments in the parameters'
    placements (``init_opt_state``)."""
    return init_opt_state(params_abs)


def train_batch_specs(cfg: ArchConfig, mesh, batch: int, seq: int):
    if cfg.takes_embeddings:
        inputs = _sds((batch, seq, cfg.d_model), torch.bfloat16, mesh,
                      batch_partition_spec(mesh, batch, ndim=3))
    else:
        inputs = _sds((batch, seq), torch.int32, mesh,
                      batch_partition_spec(mesh, batch, ndim=2))
    labels = _sds((batch, seq), torch.int32, mesh,
                  batch_partition_spec(mesh, batch, ndim=2))
    return {"inputs": inputs, "labels": labels}


def decode_specs(cfg: ArchConfig, mesh, batch: int, context: int,
                 cache_dtype=torch.bfloat16):
    """(cache, tokens, cur_pos): the per-layer cache with each leaf's batch
    dim placed by ``cache_partition_spec``, one token per sequence, and the
    position of the last slot (the port's ``cur_pos`` is an int)."""
    cache = [{k: distribute(v, NamedSharding(
                 mesh, cache_partition_spec(mesh, v, batch)))
              for k, v in layer.items()}
             for layer in init_cache(cfg, batch, max_len=context,
                                     device=META, dtype=cache_dtype)]
    if cfg.takes_embeddings:
        tokens = _sds((batch, 1, cfg.d_model), torch.bfloat16, mesh,
                      batch_partition_spec(mesh, batch, ndim=3))
    else:
        tokens = _sds((batch, 1), torch.int32, mesh,
                      batch_partition_spec(mesh, batch, ndim=2))
    return cache, tokens, context - 1


def prefill_specs(cfg: ArchConfig, mesh, batch: int, seq: int):
    if cfg.takes_embeddings:
        return _sds((batch, seq, cfg.d_model), torch.bfloat16, mesh,
                    batch_partition_spec(mesh, batch, ndim=3))
    return _sds((batch, seq), torch.int32, mesh,
                batch_partition_spec(mesh, batch, ndim=2))
