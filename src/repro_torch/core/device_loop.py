"""Device-resident PCG loops: blocks of masked steps, replayed as CUDA graphs.

The port's counterpart of the reference's device-side ``lax.while_loop``
and of ``SolverPlan``'s per-signature ``jax.jit`` cache.  A loop runs
blocks of ``k`` guarded PCG steps and reads one device flag per block: once
before the first block (a zero or NaN right-hand side stops at 0 trips, as
the reference's ``cond`` does) and once after each block.  Every step after
the stop is a no-op on whatever outlives it (``core.iccg``'s masked steps),
so the results do not depend on ``k``.

On the card a ``BlockLoop`` runs the first block eagerly on a side stream
(that warms every kernel variant, the cuBLAS workspace of the capture
stream and the tables' lazily computed segments), then captures the
``k``-step block once as a CUDA graph over static state tensors -- the
block ``copy_``s its results back into them and writes the flag -- and
replays it.  A later solve of the same signature copies its initial state
into the static tensors and replays from the first block.  On the CPU the
same block runs eagerly, with no graph, on the same read-every-``k``
schedule.

A capture issues the kernel launches of one block without running them, and
a replay runs them without the wrappers' Python: the loop takes what the
capture counted back out of ``spans``' counters (the kernels' launches and
bytes, the mesh's all-gathers) and adds it once per replay, so the
counters count what ran on the card.  ``loop_counts`` counts the flag
reads, the blocks run, the replays among them and the captures.

Under a mesh (``build_plan(mesh=...)``) the block holds the mesh's
collectives too, and they are captured with it: the apply before the loop
and the eager first block issue every collective once, so NCCL has made
its communicator before the capture, as a capture requires.  Every rank
must run the same number of blocks, or the collectives deadlock: the flag
is computed from replicated state by the same arithmetic on every rank,
so the ranks read the same flag after every block.

A failed capture or replay raises: there is no fallback to a host loop.
"""
from __future__ import annotations

import gc
from typing import Callable

import torch

from ..spans import add, count, counts, reset_counts, snapshot, span

#: PCG steps per block, and so per host read of the loop's flag.  On the
#: H100 (chip_smoke.py phase 4, 1M unknowns) k = 8 and 16 give the same ms
#: per iteration and k = 1 and 4 more; k = 8 runs fewer masked steps after
#: the stop (k - 1 at most).
_STEPS_PER_READ = 8

_EVENTS = ("reads", "blocks", "replays", "captures")

State = tuple[torch.Tensor, ...]


def loop_counts() -> dict[str, int]:
    """Flag reads, blocks run (eager and replayed), replays and graph
    captures since the last reset, over every loop of the process."""
    got = counts("loop.")
    return {event: got.get(event, 0) for event in _EVENTS}


def reset_loop_counts() -> None:
    reset_counts("loop.")


def _read(flag: torch.Tensor) -> bool:
    count("loop.reads")
    return bool(flag.item())


class LoopCache:
    """A plan's captured blocks, one ``BlockLoop`` per signature: the
    counterpart of the reference plan's ``_pcg_cache`` of jitted loops.
    Every graph of one cache shares one memory pool and one capture
    stream; ``captures`` counts the graphs captured into it (the
    counterpart of the reference's ``_trace_count``)."""

    def __init__(self):
        self._loops: dict[tuple, BlockLoop] = {}
        self.captures = 0
        self._pool = None
        self._stream = None

    def __len__(self) -> int:
        return len(self._loops)

    def keys(self):
        return self._loops.keys()

    def items(self):
        return self._loops.items()

    def get(self, key: tuple, steps_per_read: int) -> "BlockLoop":
        loop = self._loops.get(key)
        if loop is None:
            loop = self._loops[key] = BlockLoop(steps_per_read, cache=self)
        return loop

    def clear(self) -> None:
        """Drop every captured graph (their operands changed address)."""
        self._loops.clear()

    def _side_stream(self, device: torch.device) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        return self._stream

    def _graph_pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool


class BlockLoop:
    """One signature's loop: ``k`` steps a block, and on the card the CUDA
    graph of that block with its static state tensors.

    ``run(state, step, flag)`` takes the initial state (a tuple of
    tensors), ``step`` (state -> state: one masked PCG step; it may update
    a state tensor in place and return it) and ``flag`` (state -> 0-d bool
    tensor: whether the next step is live).  Once a graph is captured,
    ``step`` and ``flag`` are not called again: the caller passes the same
    arithmetic for one signature, over tensors that are either in the state
    or live as long as the loop (the plan's operands).
    """

    def __init__(self, steps_per_read: int, cache: LoopCache | None = None):
        if steps_per_read < 1:
            raise ValueError(f"steps_per_read must be >= 1, got "
                             f"{steps_per_read}")
        self.k = int(steps_per_read)
        self._cache = cache if cache is not None else LoopCache()
        self.graph: torch.cuda.CUDAGraph | None = None
        self._static: State | None = None
        self._flag: torch.Tensor | None = None
        self._counted: dict[str, int] = {}

    def _block(self, step: Callable[[State], State], state: State) -> State:
        for _ in range(self.k):
            state = tuple(step(state))
        return state

    def run(self, state: State, step: Callable[[State], State],
            flag: Callable[[State], torch.Tensor],
            eager: bool = False) -> tuple[State, int]:
        """Run blocks until the flag reads False; returns the final state
        and the number of blocks run.  ``eager`` runs every block eagerly
        on the card too (no graph; for comparison)."""
        state = tuple(state)
        if not _read(flag(state)):
            return state, 0
        if state[0].device.type != "cuda" or eager:
            return self._run_eager(state, step, flag)
        blocks = 0
        if self.graph is None:
            state = self._first_block(state, step)
            blocks += 1
            if not _read(flag(state)):
                return state, blocks
            self._capture(state, step, flag)
        else:
            for s, t in zip(self._static, state, strict=True):
                if s.shape != t.shape or s.dtype != t.dtype:
                    raise ValueError(f"state {tuple(t.shape)} {t.dtype} "
                                     f"does not fit the captured "
                                     f"{tuple(s.shape)} {s.dtype}")
                s.copy_(t)
        live = True
        while live:
            self._replay()
            blocks += 1
            live = _read(self._flag)
        # tensors of the caller's own: the next replay overwrites the
        # static ones
        return tuple(s.clone() for s in self._static), blocks

    def run_once(self, state: State,
                 step: Callable[[State], State]) -> State:
        """One block from ``state``, with no flag: eagerly on the CPU; on
        the card the first call runs the block eagerly and then captures
        it, and every later call replays the graph (``step`` is then not
        called again)."""
        state = tuple(state)
        if state[0].device.type != "cuda":
            count("loop.blocks")
            return self._block(step, state)
        if self.graph is None:
            out = self._first_block(state, step)
            self._capture(state, step, None)
            return out
        for s, t in zip(self._static, state, strict=True):
            s.copy_(t)
        self._replay()
        return tuple(s.clone() for s in self._static)

    def _replay(self) -> None:
        """Replay the graph, and count what it ran."""
        self.graph.replay()
        add(self._counted)
        count("loop.blocks")
        count("loop.replays")

    def _run_eager(self, state, step, flag) -> tuple[State, int]:
        blocks = 0
        live = True
        while live:
            state = self._block(step, state)
            count("loop.blocks")
            blocks += 1
            live = _read(flag(state))
        return state, blocks

    def _first_block(self, state: State, step) -> State:
        """The first block, eagerly on the capture stream: the warm-up the
        ``torch.cuda.graphs`` docs ask for before a capture."""
        dev = state[0].device
        with span("loop.first_block"):
            side = self._cache._side_stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                state = self._block(step, state)
            torch.cuda.current_stream(dev).wait_stream(side)
        count("loop.blocks")
        return state

    def _capture(self, state: State, step, flag) -> None:
        dev = state[0].device
        with span("loop.capture"):
            static = tuple(t.clone() for t in state)
            live = torch.zeros((), dtype=torch.bool, device=dev)
            before = snapshot()
            graph = torch.cuda.CUDAGraph()
            # no garbage collection while the stream captures: collecting
            # an unreachable plan would destroy its graphs, which CUDA
            # forbids during a capture, and the capture would fail
            collecting = gc.isenabled()
            gc.disable()
            try:
                self._record(graph, dev, static, live, step, flag)
            finally:
                if collecting:
                    gc.enable()
            torch.cuda.synchronize(dev)
        # the capture issued one block's launches and ran none of them
        self._counted = {key: n - before.get(key, 0)
                         for key, n in snapshot().items()
                         if n != before.get(key, 0)}
        add(self._counted, -1)
        self.graph, self._static, self._flag = graph, static, live
        self._cache.captures += 1
        count("loop.captures")

    def _record(self, graph, dev, static: State, live: torch.Tensor,
                step, flag) -> None:
        """Capture one block over ``static`` into ``graph``: the block
        writes its results back into ``static`` and, with a ``flag``, the
        flag into ``live``."""
        with torch.cuda.graph(graph, pool=self._cache._graph_pool(),
                              stream=self._cache._side_stream(dev)):
            out = self._block(step, static)
            # an output that is another field's static tensor is copied
            # before any field is overwritten
            where = {id(s): i for i, s in enumerate(static)}
            out = tuple(o.clone() if where.get(id(o), i) != i else o
                        for i, o in enumerate(out))
            for s, o in zip(static, out, strict=True):
                if o is not s:
                    s.copy_(o)
            if flag is not None:
                live.copy_(flag(static))
