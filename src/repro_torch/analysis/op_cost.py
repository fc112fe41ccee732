"""Per-device cost of one step from its dispatch stream: FLOPs, bytes and
collectives (the port's counterpart of ``repro.analysis.hlo`` and of its
re-export ``repro.launch.hlo_analysis``).

The reference compiles the step and walks the optimized per-device HLO.
The port compiles no HLO: it runs the step once on one rank and records
that rank's op stream under a ``TorchDispatchMode`` (:class:`OpCost`).
Under DTensor the mode sees **local** ops: for an op on DTensors it
returns ``NotImplemented``, so DTensor runs first and desugars the op into
the collectives of its redistributions and the op on the local shards,
which the mode then records.  So the counts are one device's after
partitioning -- replicated work counts on every rank -- as the reference's
are.  On the dry-run's meta tensors nothing is computed; shapes suffice.
Ops on ``FakeTensor``s (DTensor's own shape propagation) are not the
step's and are skipped.

The reference's cost model, per op:

  * FLOPs: a product (``mm``, ``bmm``, ``addmm``, ``baddbmm``) is 2 x
    result elements x contraction size (plus the result for the bias
    add); an elementwise op (``torch.Tag.pointwise``, and dtype casts) 1
    per result element; a reduction its input elements; a softmax 5 per
    element (two reductions and three elementwise passes) and its
    backward 3.
  * Bytes: operands plus result of every op, but views (aliasing outputs),
    allocations and waits, which move nothing.  No fusion: the reference's XLA fuses,
    so this is an upper bound of its traffic.
  * Collectives (``_c10d_functional`` ops): by kind, each buffer the
    larger of result and operand, and wire bytes with ``COLL_WIRE``'s
    multipliers (a ring all-reduce moves ~2x its buffer).
"""
from __future__ import annotations

from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
# bytes-on-the-wire multiplier per unit buffer (ring algorithms): a ring
# all-reduce moves ~2x its buffer, all-gather/reduce-scatter (n-1)/n ~ 1x
COLL_WIRE = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
             "all-to-all": 1.0, "collective-permute": 1.0}

#: ``_c10d_functional`` op -> collective kind
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "collective-permute",
}
_PRODUCTS = {"mm", "bmm", "addmm", "baddbmm"}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod",
               "argmax", "argmin", "cumsum", "logsumexp", "var", "std",
               "norm", "linalg_vector_norm", "topk", "sort"}
_SOFTMAX = {"_softmax": 5, "_log_softmax": 5, "_softmax_backward_data": 3,
            "_log_softmax_backward_data": 3}
_CASTS = {"_to_copy", "copy_", "clone"}
#: allocations move no bytes (the reference's free broadcast / iota)
_ALLOCATIONS = {"empty", "empty_strided", "empty_like", "new_empty",
                "new_empty_strided"}


def _tensors(tree) -> list[torch.Tensor]:
    out = []
    for a in tree if isinstance(tree, (list, tuple)) else (tree,):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out += _tensors(a)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    """An op whose result aliases an input without writing (a view)."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


class OpCost(TorchDispatchMode):
    """Records one rank's local op stream as FLOPs, bytes and collectives
    (module docstring); read the totals with :meth:`totals`."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.coll_bytes: dict = defaultdict(float)
        self.coll_count: dict = defaultdict(float)
        self.coll_wire = 0.0
        self.ops: dict = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented        # DTensor desugars it into local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors(list(args) + list(kwargs.values()))
        if any(_is_fake(t) for t in ins):
            return out                   # DTensor's shape propagation
        self._record(func, ins, _tensors(out))
        return out

    def _record(self, func, ins, outs) -> None:
        name = func.overloadpacket.__name__
        self.ops[f"{func.namespace}.{name}"] += 1
        if func.namespace == "_c10d_functional":
            kind = _COLLECTIVE_OPS.get(name)
            if kind is None:             # wait_tensor and the like
                return
            buf = max(sum(map(_nbytes, outs)), sum(map(_nbytes, ins)))
            self.coll_bytes[kind] += buf
            self.coll_count[kind] += 1
            self.coll_wire += COLL_WIRE[kind] * buf
            self.bytes += sum(map(_nbytes, outs)) + sum(map(_nbytes, ins))
            return
        if _is_view(func) or name in _ALLOCATIONS:
            return
        out_elems = sum(t.numel() for t in outs)
        if name in _PRODUCTS:
            a = ins[-2] if name in ("addmm", "baddbmm") else ins[0]
            self.flops += 2.0 * out_elems * a.shape[-1]
            if name in ("addmm", "baddbmm"):
                self.flops += out_elems
        elif name in _SOFTMAX:
            self.flops += _SOFTMAX[name] * out_elems
        elif name in _REDUCTIONS:
            self.flops += ins[0].numel() if ins else out_elems
        elif torch.Tag.pointwise in func.tags or name in _CASTS:
            self.flops += out_elems
        self.bytes += sum(map(_nbytes, outs)) + sum(map(_nbytes, ins))

    def totals(self) -> dict:
        """The reference's ``analyze_hlo`` keys."""
        return {"flops": self.flops, "bytes": self.bytes,
                "collective_wire_bytes": self.coll_wire,
                "collective_bytes_by_kind": dict(self.coll_bytes),
                "collective_counts": dict(self.coll_count)}

    def record(self) -> dict:
        """The totals and the op census (ops by name), for storage."""
        return {**self.totals(), "ops": dict(self.ops)}


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def op_cost(fn, *args, **kwargs) -> tuple[object, dict]:
    """Run ``fn(*args, **kwargs)`` under :class:`OpCost`; returns (its
    result, the record: the ``analyze_hlo`` keys and ``ops``)."""
    with OpCost() as rec:
        out = fn(*args, **kwargs)
    return out, rec.record()
