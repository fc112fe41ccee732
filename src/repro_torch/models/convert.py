"""The bridge to the reference's parameters and caches, for the parity
tests.

The reference keeps its parameters as a pytree of nested dicts with each
pattern slot's weights stacked over repeats (``blocks[i][name][r]``), and
its decode caches as a tuple per pattern slot stacked the same way.  The
port keeps one module (and one cache dict) per layer, layer ``r * P + i``
for repeat ``r`` of slot ``i``.  These functions take numpy arrays
(``np.asarray`` of the reference's leaves) and give torch tensors on the
CPU, or the reverse (``params_to_reference`` also carries gradients keyed
by parameter name); nothing else in the port calls them.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import ArchConfig


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # numpy's bf16 extension type
        return torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(np.array(a))


def _numpy(t: torch.Tensor) -> np.ndarray:
    """bf16 comes back as exact f32 (numpy has no bf16 of its own)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _flatten(tree, prefix: str = "") -> dict:
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flatten(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = val
    return out


def params_from_reference(np_params: dict, cfg: ArchConfig) -> dict:
    """The reference's parameter pytree -> the port's ``state_dict`` (load
    it with ``model.load_state_dict``, which checks every name and shape).
    """
    state = {"embed": _tensor(np_params["embed"])}
    n_slots = len(cfg.block_pattern)
    for i, slot in enumerate(np_params["blocks"]):
        for name, stacked in _flatten(slot).items():
            stacked = np.asarray(stacked)
            for r in range(cfg.pattern_repeats):
                state[f"blocks.{r * n_slots + i}.{name}"] = \
                    _tensor(stacked[r])
    state.update(_flatten({k: _tensor(v) for k, v in
                           np_params["ln_f"].items()}, "ln_f."))
    if "lm_head" in np_params:
        state["lm_head"] = _tensor(np_params["lm_head"])
    return state


def _nest(flat: dict) -> dict:
    """``{"a.b": x}`` -> ``{"a": {"b": x}}``."""
    out: dict = {}
    for key, val in flat.items():
        *head, last = key.split(".")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = val
    return out


def params_to_reference(state: dict, cfg: ArchConfig) -> dict:
    """The port's parameters (a ``state_dict``, or gradients keyed by
    parameter name) -> the reference's pytree layout, numpy leaves, each
    pattern slot's leaves stacked over repeats (the inverse of
    ``params_from_reference``)."""
    n_slots = len(cfg.block_pattern)
    top = {k: _numpy(v) for k, v in state.items()
           if not k.startswith("blocks.")}
    slots = []
    for i in range(n_slots):
        prefix = f"blocks.{i}."
        names = [k[len(prefix):] for k in state if k.startswith(prefix)]
        slots.append(_nest({
            name: np.stack([_numpy(state[f"blocks.{r * n_slots + i}.{name}"])
                            for r in range(cfg.pattern_repeats)])
            for name in names}))
    out = _nest(top)
    out["blocks"] = tuple(slots)
    return out


def cache_from_reference(ref_cache, cfg: ArchConfig) -> list[dict]:
    """The reference's stacked cache -> the port's per-layer cache."""
    n_slots = len(cfg.block_pattern)
    return [{k: _tensor(np.asarray(v)[layer // n_slots])
             for k, v in ref_cache[layer % n_slots].items()}
            for layer in range(cfg.n_layers)]


def cache_to_reference(cache: list[dict], cfg: ArchConfig) -> tuple:
    """The port's per-layer cache -> the reference's layout: a tuple per
    pattern slot of dicts of numpy arrays stacked over repeats."""
    n_slots = len(cfg.block_pattern)
    return tuple(
        {k: np.stack([_numpy(cache[r * n_slots + i][k])
                      for r in range(cfg.pattern_repeats)])
         for k in cache[i]}
        for i in range(n_slots))
