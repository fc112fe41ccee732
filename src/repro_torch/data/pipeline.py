"""Deterministic synthetic data pipeline, shardable and resumable (the
port's own copy of ``repro.data.pipeline``, numpy only, bitwise the same
batches).

Design points that matter at cluster scale:
  * **stateless indexing** — batch contents are a pure function of
    (seed, step, host), so restart-from-checkpoint resumes the exact
    stream with no pipeline state to persist beyond the step counter;
  * **per-host sharding** — each host materializes only its slice of the
    global batch (``host_slice``), the standard multi-pod input layout;
  * **straggler-free** — no host ever waits on a shared queue; generation
    is compute-trivial and prefetchable a step ahead.

The token distribution is a Zipfian mixture with a Markov overlay so models
actually learn during the example runs (loss visibly decreases), unlike
uniform-random tokens.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0


def _batch_rng(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host_id]))


def host_slice(cfg: DataConfig) -> tuple[int, int]:
    per = cfg.global_batch // cfg.n_hosts
    return cfg.host_id * per, per


def sample_batch(cfg: DataConfig, step: int) -> dict:
    """Returns {"inputs": (b, S) int32, "labels": (b, S) int32} for this
    host's slice of the global batch."""
    rng = _batch_rng(cfg, step)
    _, per = host_slice(cfg)
    v = cfg.vocab
    # Zipf base distribution
    ranks = np.arange(1, v + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()
    base = rng.choice(v, size=(per, cfg.seq_len + 1), p=probs)
    # Markov overlay: with p=0.5, next token = f(prev) (learnable structure)
    mult = 6364136223846793005 % v
    prev = base[:, :-1]
    succ = (prev * mult + 12345) % v
    mask = rng.random((per, cfg.seq_len)) < 0.5
    seq = base.copy()
    seq[:, 1:][mask] = succ[mask]
    return {"inputs": seq[:, :-1].astype(np.int32),
            "labels": seq[:, 1:].astype(np.int32)}


def sample_embedding_batch(cfg: DataConfig, step: int, d_model: int) -> dict:
    """Frontend-stub batch for [vlm]/[audio] archs: precomputed frame/patch
    embeddings + token labels."""
    tok = sample_batch(cfg, step)
    rng = _batch_rng(cfg, step + 2**20)
    _, per = host_slice(cfg)
    emb = rng.normal(0, 0.5, size=(per, cfg.seq_len, d_model))
    return {"inputs": emb.astype(np.float32), "labels": tok["labels"]}
