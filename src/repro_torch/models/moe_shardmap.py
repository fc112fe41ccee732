"""Explicit-dispatch MoE: token-local dispatch + ff-sliced experts + one
reduction over `model` (port of ``repro.models.moe_shardmap``).

The reference's production path for E < mesh_model (e.g. mixtral's 8
experts on a 16-wide model axis): under plain sharding propagation the
capacity-dispatch MoE leaves the (E, C, d) buffers replicated across
`model` and the partitioner all-reduces them.  Here every device:

  1. computes the router logits for its batch shard (a DTensor product,
     outside the per-device body),
  2. scatters its OWN tokens into a local (E, C_local, d) buffer -- no
     communication at all,
  3. runs all experts' GEMMs on its ff-slice of every expert
     (Megatron-style tensor parallelism over `model`),
  4. combines back to token layout; the ff-partial outputs are declared
     ``Partial()`` on `model` and DTensor reduces them -- the only
     collective, (T_local x d) sized.

The body runs under ``torch.distributed.tensor.experimental.local_map``
(the reference's ``shard_map``) with the reference's in / out specs as
placements.  Its gradients are declared by hand (``in_grad_placements``):
the experts' and the logits' gradients of the body are partial sums --
over the batch axes for the weights (each device saw only its tokens),
over `model` for the tokens and logits (each device holds one ff-slice) --
and DTensor reduces them.  No all-reduce is written by hand: a
differentiable all-reduce also all-reduces the gradient in its backward
and would scale replicated gradients by the axis size.

The reference computes the router inside its body, where ``shard_map``'s
transpose sums the router's replicated gradient over `model`, counting
the logits' own path (the load-balancing loss) once per model device; its
``test_shardmap_moe_grads_match_plain`` fails.  The port computes the
logits outside the body, so its gradients are ``moe_apply``'s.

The math is ``moe_apply``'s with per-device capacity C_local from the local
token count (routing is batch-local), so it equals ``moe_apply`` exactly
where no token is dropped or the batch is not sharded.
"""
from __future__ import annotations

from types import SimpleNamespace

from ..dist.constraints import _current_mesh
from ..dist.sharding import _axis_sizes, mesh_placement
from .moe import dispatch_combine

#: calls in which the explicit dispatch engaged since the last reset
engaged = 0


def engaged_count() -> int:
    return engaged


def reset_engaged_count() -> None:
    global engaged
    engaged = 0


def _batch_axes(sizes: dict, b: int) -> tuple:
    """The reference's batch-axis choice: ("pod", "data") when their
    product divides b, else the first of them that divides b, else none."""
    axes = tuple(a for a in ("pod", "data") if a in sizes)
    bdiv = 1
    for a in axes:
        bdiv *= sizes[a]
    if b % bdiv != 0:
        axes = tuple(a for a in axes if b % sizes[a] == 0)[:1]
    return axes


def moe_apply_shardmap(p, x, *, top_k: int, capacity_factor: float,
                       act: str):
    """Drop-in replacement for ``moe_apply`` when a mesh with a `model`
    axis is active and ff divides it (else None).  Returns (y, router
    logits (B*S, E) f32)."""
    global engaged
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = _current_mesh()
    b, s, d = x.shape
    ff = p.experts.down.shape[1]
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return None
    sizes = _axis_sizes(mesh)
    if ff % sizes["model"] != 0:
        return None
    batch_axes = _batch_axes(sizes, b)
    names = tuple(mesh.mesh_dim_names)

    def place(batch, model):
        """Placements: ``batch`` on the batch axes, ``model`` on `model`,
        replicated elsewhere (and on axes of size 1)."""
        return tuple(mesh_placement(mesh, a, batch if a in batch_axes
                                    else model if a == "model" else None)
                     for a in names)

    tokens = place(Shard(0), None)          # x and the logits, forward
    partial_tokens = place(Shard(0), Partial())   # y; x / logits grads
    up = place(None, Shard(2))              # gate / up (E, d, ff)
    up_grad = place(Partial(), Shard(2))
    down = place(None, Shard(1))            # down (E, ff, d)
    down_grad = place(Partial(), Shard(1))

    def body(xl, logits, gw, uw, dw):
        t_l = xl.shape[0] * xl.shape[1]
        y = dispatch_combine(
            xl.reshape(t_l, d), logits,
            SimpleNamespace(gate=gw, up=uw, down=dw), top_k=top_k,
            capacity_factor=capacity_factor, act=act)
        return y.reshape(xl.shape)

    logits = (x.reshape(b * s, d) @ p.router).float()         # (T, E)
    uw, dw = p.experts.up, p.experts.down
    gw = getattr(p.experts, "gate", uw)      # gelu path ignores gate
    y = local_map(
        body, out_placements=(partial_tokens,), in_placements=(
            tokens, tokens, up, up, down),
        in_grad_placements=(partial_tokens, partial_tokens, up_grad, up_grad,
                            down_grad),
        device_mesh=mesh, redistribute_inputs=True,
    )(x, logits, gw, uw, dw)
    engaged += 1
    return y, logits
