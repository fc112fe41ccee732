"""Step-atomic checkpoints (port of ``repro.ckpt.checkpoint``).

The reference's contract, kept:
  * **atomic** -- written to ``<dir>/tmp.<step>``, flushed and fsynced,
    then renamed to ``step_<step:08d>.ckpt``, and only then the ``LATEST``
    marker (itself written to ``LATEST.tmp`` and renamed); a crash mid-write
    never corrupts the latest checkpoint;
  * **self-verifying** -- every leaf carries a crc32 of its bytes; a load
    fails loudly on bit rot;
  * **full logical arrays** -- each leaf is saved whole (a DTensor leaf
    is gathered first), so a checkpoint restores onto any device
    (``load_checkpoint(..., device=)``) or onto a mesh of another shape
    (``load_checkpoint(..., shardings=)``: the elastic reshard);
  * **resumable stream** -- the data pipeline is stateless-indexed, so the
    step alone resumes the exact data order.

The file format differs from the reference's (msgpack, compressed with
zstd or zlib): the port uses the standard library only.  A file is the
magic ``RPTCKPT1``, each leaf's raw bytes one after the other
(uncompressed), a JSON index ``{"step", "leaves": {key: {"dtype",
"shape", "crc", "offset", "nbytes"}}}`` and the index's length as 8
little-endian bytes.  numpy has no bfloat16, so a bf16 leaf is stored as its
raw 16-bit words with dtype ``"bfloat16"``.

A tree is nested dicts, lists, tuples and NamedTuples of tensors; a leaf's
key is its path, joined with ``.``.
"""
from __future__ import annotations

import contextlib
import json
import os
import struct
import zlib

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..dist.sharding import distribute
from ..kernels.config import resolve_device

_MAGIC = b"RPTCKPT1"


def _flatten(tree, prefix: str = "") -> list[tuple[str, object]]:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix.rstrip("."), tree)]
    return [kv for k, v in items for kv in _flatten(v, f"{prefix}{k}.")]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves) for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(v, leaves) for v in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _leaf_bytes(leaf: torch.Tensor) -> tuple[str, list[int], bytes]:
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return "bfloat16", list(t.shape), t.view(torch.int16).numpy() \
            .tobytes()
    arr = t.numpy()
    return str(arr.dtype), list(arr.shape), arr.tobytes()


def save_checkpoint(path: str, tree, step: int) -> str:
    """Write ``tree`` at ``step`` into directory ``path``; returns the
    file's path.  With DTensor leaves every rank must call it (each leaf is
    gathered); rank 0 writes, and every rank returns once the file is
    there."""
    sharded = any(isinstance(leaf, DTensor) for _, leaf in _flatten(tree))
    writer = not (sharded and dist.is_initialized()) or dist.get_rank() == 0
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f"tmp.{step}")
    final = os.path.join(path, f"step_{step:08d}.ckpt")
    index = {"step": int(step), "leaves": {}}
    with open(tmp, "wb") if writer else contextlib.nullcontext() as f:
        if writer:
            f.write(_MAGIC)
        for key, leaf in _flatten(tree):
            dtype, shape, buf = _leaf_bytes(leaf)
            if not writer:
                continue
            index["leaves"][key] = {"dtype": dtype, "shape": shape,
                                    "crc": zlib.crc32(buf),
                                    "offset": f.tell(), "nbytes": len(buf)}
            f.write(buf)
        if writer:
            blob = json.dumps(index).encode()
            f.write(blob)
            f.write(struct.pack("<Q", len(blob)))
            f.flush()
            os.fsync(f.fileno())
    if writer:
        os.rename(tmp, final)
        _write_latest(path, final)
    if sharded and dist.is_initialized():
        dist.barrier()
    return final


def _write_latest(path: str, final: str):
    tmp = os.path.join(path, "LATEST.tmp")
    with open(tmp, "w") as f:
        f.write(os.path.basename(final))
    os.rename(tmp, os.path.join(path, "LATEST"))


def latest_checkpoint(path: str) -> str | None:
    """The file ``LATEST`` names in ``path``, or None."""
    marker = os.path.join(path, "LATEST")
    if not os.path.exists(marker):
        return None
    with open(marker) as f:
        name = f.read().strip()
    full = os.path.join(path, name)
    return full if os.path.exists(full) else None


def load_checkpoint(file: str, like_tree, device="cuda", shardings=None
                    ) -> tuple[object, int]:
    """Restore into the structure of ``like_tree`` (its values are
    ignored), each leaf a tensor on ``device`` in the dtype and shape it
    was saved with.  ``shardings``: a tree of the same structure whose
    leaves are ``dist.NamedSharding``s (or None: a plain tensor); each leaf
    is then placed on its (possibly different) mesh as a DTensor -- the
    elastic-rescale path.
    Returns (tree, step); raises ``IOError`` on a crc mismatch and
    ``KeyError`` on a missing leaf."""
    dev = resolve_device(device)
    shard_leaves = (None if shardings is None
                    else iter([sh for _, sh in _flatten(shardings)]))
    with open(file, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            raise IOError(f"{file} is not a checkpoint")
        f.seek(-8, os.SEEK_END)
        (n,) = struct.unpack("<Q", f.read(8))
        f.seek(-8 - n, os.SEEK_END)
        index = json.loads(f.read(n))
        out = []
        for key, _ in _flatten(like_tree):
            rec = index["leaves"].get(key)
            if rec is None:
                raise KeyError(f"checkpoint missing leaf {key}")
            f.seek(rec["offset"])
            buf = f.read(rec["nbytes"])
            if zlib.crc32(buf) != rec["crc"]:
                raise IOError(f"crc mismatch on leaf {key} (corrupt "
                              "checkpoint)")
            bf16 = rec["dtype"] == "bfloat16"
            arr = np.frombuffer(buf, np.int16 if bf16 else rec["dtype"])
            t = torch.from_numpy(arr.copy()).reshape(rec["shape"])
            t = (t.view(torch.bfloat16) if bf16 else t).to(dev)
            sh = None if shard_leaves is None else next(shard_leaves)
            out.append(t if sh is None else distribute(t, sh))
    return _unflatten(like_tree, iter(out)), index["step"]
