# Copy of repro/core/coloring.py (numpy/scipy only).  The port keeps its own copy
# because importing the reference package loads JAX; the two stay identical
# so setup products are bitwise-equal (tests/test_torch_setup.py).
"""Nodal multi-color (MC) and algebraic block multi-color (BMC) orderings.

MC: greedy coloring of the matrix adjacency graph; unknowns ordered by
(color, original index).

BMC (Iwashita, Nakashima, Takahashi, IPDPS 2012): unknowns are first grouped
into blocks of size ``b_s`` with the *simplest heuristic* from that paper (the
one the HBMC paper says it uses): the unknown with the minimal number among
unassigned ones seeds a new block, and the block is grown greedily across
adjacent unassigned unknowns (minimal index first).  The quotient (block)
graph is then greedy-colored, and unknowns are ordered by
(block color, block id, position inside block).

Block building is the one ordering stage with no closed-form vectorization:
the minimal-index growth rule makes every acceptance depend on the previous
one.  ``build_blocks`` vectorizes it anyway with *batched frontier growth*:
per step it gathers the CSR neighbor slices of the whole sorted candidate
frontier at once and accepts the longest prefix whose acceptance provably
cannot be altered by neighbors the accepted nodes introduce (a prefix-min
argument, see ``build_blocks``).  The original element-at-a-time heap walk
survives as ``_build_blocks_walk`` — the bitwise oracle of the property
tests and of ``benchmarks/bench_setup.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from .graph import adjacency_lists, ragged_arange


def _validate_block_size(block_size, who: str) -> int:
    """Entry-point guard: ``block_size`` must be a positive int.

    ``block_size=0`` used to degenerate silently — every block became a
    singleton and the padded system collapsed to ``n_padded = 0``, so the
    caller got an empty permutation and garbage downstream; negative
    values degenerated the same way.
    """
    if isinstance(block_size, bool) or not isinstance(
            block_size, (int, np.integer)):
        raise ValueError(
            f"{who}: block_size must be an int, got "
            f"{type(block_size).__name__} ({block_size!r})")
    if block_size < 1:
        raise ValueError(
            f"{who}: block_size must be >= 1, got {block_size} "
            f"(block_size < 1 silently produced an empty padded system)")
    return int(block_size)


def greedy_color(indptr: np.ndarray, indices: np.ndarray, n: int,
                 order: np.ndarray | None = None) -> np.ndarray:
    """Greedy (first-fit) coloring.  Returns color id per node (0-based)."""
    colors = np.full(n, -1, dtype=np.int64)
    scratch = np.full(n, -1, dtype=np.int64)  # color -> last node that used it
    seq = np.arange(n) if order is None else order
    for v in seq:
        for u in indices[indptr[v]:indptr[v + 1]]:
            cu = colors[u]
            if cu >= 0:
                scratch[cu] = v
        c = 0
        while scratch[c] == v:
            c += 1
        colors[v] = c
    return colors


@dataclasses.dataclass(frozen=True)
class MCOrdering:
    """Nodal multi-color ordering."""
    perm: np.ndarray          # perm[old] = new
    colors: np.ndarray        # color of each *old* unknown
    n_colors: int
    color_counts: np.ndarray  # unknowns per color, in new order


def multicolor_ordering(a: sp.spmatrix) -> MCOrdering:
    n = a.shape[0]
    indptr, indices = adjacency_lists(a)
    colors = greedy_color(indptr, indices, n)
    n_colors = int(colors.max()) + 1
    # stable sort by color keeps original order inside each color
    new_order = np.argsort(colors, kind="stable")   # new -> old
    perm = np.empty(n, dtype=np.int64)
    perm[new_order] = np.arange(n)
    counts = np.bincount(colors, minlength=n_colors)
    return MCOrdering(perm=perm, colors=colors, n_colors=n_colors,
                      color_counts=counts)


@dataclasses.dataclass(frozen=True)
class BMCOrdering:
    """Algebraic block multi-color ordering.

    Unknown layout in the new order: colors ascending; inside a color its
    blocks consecutively (``block_size`` unknowns each, padded with dummy
    unknowns so every block is exactly ``block_size`` long); inside a block
    the original relative order is preserved.

    ``perm`` maps old index -> new index over the *padded* system of size
    ``n_padded = n_blocks_total * block_size``.  Dummy slots are the padded
    tail of each block; ``is_dummy`` marks them in the new order.
    """
    perm: np.ndarray
    n: int
    n_padded: int
    block_size: int
    n_colors: int
    block_color: np.ndarray        # color of each block
    blocks_per_color: np.ndarray   # number of blocks in each color
    block_of_new: np.ndarray       # block id (global, color-major) per new idx
    is_dummy: np.ndarray           # bool per new index


@dataclasses.dataclass(frozen=True)
class BlockPartition:
    """Greedy min-index blocks as flat arrays (the array-program form).

    ``members`` concatenates the blocks in build order, ascending inside
    each block (the legacy walk's post-sort); ``lens`` is the member count
    per block.  ``tolists()`` recovers the legacy list-of-lists shape for
    oracle comparisons.
    """
    members: np.ndarray   # (n,) int64 — node ids, block-major
    lens: np.ndarray      # (n_blocks,) int64

    @property
    def n_blocks(self) -> int:
        return len(self.lens)

    @property
    def starts(self) -> np.ndarray:
        """First flat index of every block (len ``n_blocks``)."""
        return np.concatenate([[0], np.cumsum(self.lens)[:-1]]).astype(
            np.int64)

    def tolists(self) -> list[list[int]]:
        ends = np.cumsum(self.lens)
        starts = ends - self.lens
        return [self.members[s:e].tolist() for s, e in zip(starts, ends)]


def _build_blocks_walk(a: sp.spmatrix, block_size: int) -> list[list[int]]:
    """Min-index-seeded greedy block growing (2012 paper, simplest
    heuristic) — the element-at-a-time heap walk.

    Kept as the bitwise ORACLE for :func:`build_blocks`: the property
    tests prove the batched frontier growth reproduces these blocks
    exactly, and ``bench_setup`` prices the vectorized pipeline against
    this walk.  Plain-Python-int hot loop (adjacency converted to lists
    once, a stamp array instead of a per-block set).
    """
    block_size = _validate_block_size(block_size, "_build_blocks_walk")
    n = a.shape[0]
    indptr_a, indices_a = adjacency_lists(a)
    indptr = indptr_a.tolist()
    indices = indices_a.tolist()
    assigned = bytearray(n)
    in_heap = [0] * n        # stamp = block id + 1 marks "already pushed"
    blocks: list[list[int]] = []
    # frontier-based growth: keep candidate set of neighbors of current block
    import heapq
    heappush, heappop = heapq.heappush, heapq.heappop
    next_seed = 0
    while True:
        while next_seed < n and assigned[next_seed]:
            next_seed += 1
        if next_seed >= n:
            break
        blk = [next_seed]
        assigned[next_seed] = 1
        stamp = len(blocks) + 1
        heap: list[int] = []
        for u in indices[indptr[next_seed]:indptr[next_seed + 1]]:
            if not assigned[u] and in_heap[u] != stamp:
                in_heap[u] = stamp; heappush(heap, u)
        while len(blk) < block_size and heap:
            v = heappop(heap)
            if assigned[v]:
                continue
            blk.append(v)
            assigned[v] = 1
            for u in indices[indptr[v]:indptr[v + 1]]:
                if not assigned[u] and in_heap[u] != stamp:
                    in_heap[u] = stamp; heappush(heap, u)
        blk.sort()  # preserve original relative order inside the block
        blocks.append(blk)
    return blocks


_WINDOW_CHUNKS = 64          # max blocks' worth of frontier per window
_SCAN_CHUNK = 4096           # dead-prefix scan granularity


def _window_edges(window: np.ndarray, indptr: np.ndarray,
                  indices: np.ndarray, alive: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Induced edges of the window subgraph, as window-position pairs.

    One CSR-sliced gather over all window rows at once; membership of the
    endpoints is a ``searchsorted`` against the (sorted) window because the
    window holds *every* alive node in its index range.
    """
    cnt = indptr[window + 1] - indptr[window]
    cols = indices[np.repeat(indptr[window], cnt) + ragged_arange(cnt)]
    pu = np.repeat(np.arange(window.size), cnt)
    keep = alive[cols]
    cols, pu = cols[keep], pu[keep]
    pv = np.searchsorted(window, cols)
    keep = pv < window.size          # alive but beyond the window's max index
    in_win = keep.copy()
    in_win[keep] = window[pv[keep]] == cols[keep]
    return pu[in_win], pv[in_win]


def _walk_one_block(seed: int, block_size: int, indptr: list,
                    indices: list, dead: set) -> np.ndarray:
    """Scalar greedy growth of a single block — the exact walk semantics,
    used as the fallback when a block interleaves index ranges (so no
    aligned chunk can represent it).  ``indptr``/``indices`` are Python
    lists and ``dead`` is a Python set mirroring the assigned mask: the
    fallback must not touch numpy per edge, or it loses to the legacy
    walk on exactly the structures it exists for."""
    import heapq
    blk = [seed]
    seen = {seed}
    heap: list[int] = []
    for u in indices[indptr[seed]:indptr[seed + 1]]:
        if u not in dead and u not in seen:
            seen.add(u); heapq.heappush(heap, u)
    while len(blk) < block_size and heap:
        v = heapq.heappop(heap)
        blk.append(v)
        for u in indices[indptr[v]:indptr[v + 1]]:
            if u not in dead and u not in seen:
                seen.add(u); heapq.heappush(heap, u)
    blk.sort()
    return np.asarray(blk, dtype=np.int64)


def build_blocks(a: sp.spmatrix, block_size: int,
                 adjacency: tuple[np.ndarray, np.ndarray] | None = None
                 ) -> BlockPartition:
    """Vectorized min-index-seeded greedy block growing.

    Bitwise-identical blocks to :func:`_build_blocks_walk` (proven in
    tests/test_properties.py), via a threshold reformulation of the walk.

    Between "record" pops (pops that raise the running index maximum) the
    walk's accepted set equals ``K(theta)`` — the connected component of
    the seed in the subgraph induced on *unassigned nodes with index <=
    theta* — and every distinct ``K`` value is visited, so a block is
    exactly ``K(theta*)`` for the smallest ``theta*`` whose component
    reaches ``block_size`` (when it reaches it exactly).

    That yields a batched *chunk-run* fast path: take an index-window of
    the next ``~64 * block_size`` unassigned nodes (one CSR-sliced edge
    gather for the whole window) and accept every leading aligned
    ``block_size`` chunk that is internally connected — such a chunk IS
    the next block, because the window holds every unassigned node in its
    index range, so its ``K(theta*)`` can contain nothing else.
    Connectivity is certified by the cheapest sufficient test there is:
    every consecutive window pair inside the chunk being adjacent (one
    vectorized flag pass over the gathered edges).  A chunk that fails
    the test (a mesh block spilling into the next grid row, an irregular
    pattern) is grown exactly by a bounded scalar walk instead, and the
    window size / test cadence adapt so persistently unaligned structure
    degrades to walk speed rather than paying for windows it cannot use.

    ``adjacency`` lets callers that already hold the symmetrized
    ``(indptr, indices)`` pair skip recomputing it.
    """
    block_size = _validate_block_size(block_size, "build_blocks")
    n = a.shape[0]
    indptr, indices = (adjacency_lists(a) if adjacency is None
                       else adjacency)
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    alive = np.ones(n, dtype=bool)
    avail = np.arange(n, dtype=np.int64)   # alive superset, index-ordered
    lo = 0                                 # scan pointer into avail
    members: list[np.ndarray] = []
    lens: list[int] = []
    bs = block_size
    win_chunks = 16                        # adaptive window, in blocks
    miss_streak = 0                        # consecutive failed chunk tests
    walked = accepted = 0                  # per-epoch regime counters
    adj_lists: tuple[list, list] | None = None   # lazy, for the fallback
    dead: set = set()                      # scalar mirror of ~alive

    def take_window(want: int) -> np.ndarray:
        """Next ``want`` alive nodes in index order (fewer if exhausted)."""
        nonlocal avail, lo
        parts: list[np.ndarray] = []
        got = 0
        pos = lo
        while got < want and pos < avail.size:
            sl = avail[pos:pos + max(2 * (want - got), _SCAN_CHUNK)]
            sel = sl[alive[sl]]
            parts.append(sel)
            got += sel.size
            pos += sl.size
        if pos - lo > 4 * max(got, _SCAN_CHUNK):   # mostly-dead span: compact
            tail = avail[pos:]
            avail = np.concatenate(parts + [tail[alive[tail]]])
            lo = 0
            return avail[:want]
        w = (parts[0] if len(parts) == 1
             else np.concatenate(parts) if parts
             else np.empty(0, dtype=np.int64))
        return w[:want]

    def walk_one(seed: int) -> np.ndarray:
        nonlocal adj_lists
        if adj_lists is None:
            adj_lists = (indptr.tolist(), indices.tolist())
        blk = _walk_one_block(seed, bs, *adj_lists, dead)
        alive[blk] = False
        dead.update(blk.tolist())
        return blk

    while True:
        # advance the scan pointer to the next unassigned node
        while lo < avail.size and not alive[avail[lo]]:
            chunk = alive[avail[lo:lo + _SCAN_CHUNK]]
            j = int(np.argmax(chunk))
            if chunk[j]:
                lo += j
            else:
                lo += chunk.size
        if lo >= avail.size:
            break
        # regime hysteresis: when the structure has been defeating the
        # chunk test this epoch, walk blocks directly and only re-probe a
        # window every 16th block; counters reset each epoch so a
        # structure that becomes aligned again is re-detected
        if len(lens) % 256 == 0:
            walked = accepted = 0
        if walked > accepted + 8 and (len(lens) & 15):
            blk = walk_one(int(avail[lo]))
            members.append(blk)
            lens.append(blk.size)
            walked += 1
            continue
        window = take_window(win_chunks * bs)
        if window.size == 0:
            break
        n_full = window.size // bs
        k = 0
        if n_full:
            pu, pv = _window_edges(window, indptr, indices, alive)
            # flag[i]: window positions i and i+1 are adjacent
            flags = np.zeros(window.size, dtype=bool)
            flags[pu[pv == pu + 1]] = True
            runs = flags[:n_full * bs].reshape(n_full, bs)
            ok = runs[:, :bs - 1].all(axis=1) if bs > 1 else np.ones(
                n_full, dtype=bool)
            k = n_full if ok.all() else int(np.argmin(ok))
        if k:
            acc = window[:k * bs]
            alive[acc] = False
            dead.update(acc.tolist())
            members.append(acc)
            lens.extend([bs] * k)
            miss_streak = 0
            accepted += k
            if 2 * k >= n_full:
                win_chunks = min(2 * win_chunks, _WINDOW_CHUNKS)
        else:
            blk = walk_one(int(window[0]))
            members.append(blk)
            lens.append(blk.size)
            walked += 1
            miss_streak += 1
            if miss_streak >= 2:
                win_chunks = max(win_chunks // 2, 4)
    return BlockPartition(
        members=(np.concatenate(members) if members
                 else np.empty(0, dtype=np.int64)),
        lens=np.asarray(lens, dtype=np.int64))


def color_blocks(a: sp.spmatrix, partition: BlockPartition,
                 block_size: int,
                 adjacency: tuple[np.ndarray, np.ndarray] | None = None
                 ) -> BMCOrdering:
    """Quotient-graph coloring + permutation assembly over built blocks.

    The second half of :func:`block_multicolor_ordering`, split out so the
    setup pipeline can time (and reuse) the block-building stage
    separately.  All array programs: the block membership map, the edge
    contraction, the color-major block gather and the final scatter are
    single numpy expressions — no per-block Python loops.

    ``adjacency`` lets callers that already hold the symmetrized
    ``(indptr, indices)`` (e.g. from the block-build stage) skip
    recomputing it — on large systems the symmetrization dominates
    this stage.
    """
    block_size = _validate_block_size(block_size, "color_blocks")
    n = a.shape[0]
    nb = partition.n_blocks
    blk_lens_src = partition.lens
    block_of = np.empty(n, dtype=np.int64)
    block_of[partition.members] = np.repeat(np.arange(nb), blk_lens_src)
    indptr, indices = (adjacency_lists(a) if adjacency is None
                       else adjacency)
    # block adjacency via edge contraction
    coo_rows = np.repeat(np.arange(n), np.diff(indptr))
    br, bc = block_of[coo_rows], block_of[indices]
    mask = br != bc
    badj = sp.coo_matrix(
        (np.ones(mask.sum(), dtype=np.int8), (br[mask], bc[mask])),
        shape=(nb, nb)).tocsr()
    badj.sum_duplicates()
    bcolors = greedy_color(badj.indptr, badj.indices, nb)
    n_colors = int(bcolors.max()) + 1

    # order blocks by (color, block id)
    border = np.argsort(bcolors, kind="stable")  # new block pos -> old block id
    blocks_per_color = np.bincount(bcolors, minlength=n_colors)

    n_padded = nb * block_size
    blk_lens = blk_lens_src[border]
    # members of the reordered blocks: one segmented gather out of the
    # flat partition (src block `border[i]` supplies slice i)
    flat = partition.members[
        np.repeat(partition.starts[border], blk_lens) + ragged_arange(blk_lens)]
    within = ragged_arange(blk_lens)
    perm = np.empty(n, dtype=np.int64)
    perm[flat] = np.repeat(np.arange(nb) * block_size, blk_lens) + within
    block_of_new = np.repeat(np.arange(nb), block_size)
    is_dummy = (np.arange(n_padded) % block_size
                ) >= np.repeat(blk_lens, block_size)
    block_color = bcolors[border]
    return BMCOrdering(
        perm=perm, n=n, n_padded=n_padded, block_size=block_size,
        n_colors=n_colors, block_color=block_color,
        blocks_per_color=blocks_per_color, block_of_new=block_of_new,
        is_dummy=is_dummy)


def block_multicolor_ordering(a: sp.spmatrix, block_size: int) -> BMCOrdering:
    """BMC ordering = vectorized block building + quotient coloring.

    ``build_blocks`` / ``color_blocks`` expose the two stages separately
    (the setup pipeline times them as ``block_build_s`` / ``color_s``).
    """
    block_size = _validate_block_size(block_size, "block_multicolor_ordering")
    adjacency = adjacency_lists(a)
    return color_blocks(a, build_blocks(a, block_size, adjacency=adjacency),
                        block_size, adjacency=adjacency)


def pad_system(a: sp.spmatrix, b: np.ndarray | None, ordering: BMCOrdering
               ) -> tuple[sp.csr_matrix, np.ndarray | None]:
    """Apply a BMC ordering, embedding the system into the padded size.

    Dummy unknowns get a 1.0 diagonal and zero RHS; they never couple to real
    unknowns, so the Krylov process on the padded system reproduces the
    original one exactly.
    """
    n, npad = ordering.n, ordering.n_padded
    coo = sp.coo_matrix(a)
    p = ordering.perm
    rows = p[coo.row]
    cols = p[coo.col]
    data = coo.data                # keep the caller's dtype (f32 stays f32)
    if not np.issubdtype(data.dtype, np.floating):
        data = data.astype(np.float64)
    dummy_idx = np.nonzero(ordering.is_dummy)[0]
    rows = np.concatenate([rows, dummy_idx])
    cols = np.concatenate([cols, dummy_idx])
    data = np.concatenate([data, np.ones(len(dummy_idx), dtype=data.dtype)])
    a_bar = sp.coo_matrix((data, (rows, cols)), shape=(npad, npad)).tocsr()
    b_bar = None
    if b is not None:
        b = np.asarray(b)          # keep the caller's dtype (f32 stays f32)
        if not np.issubdtype(b.dtype, np.floating):
            # same promotion rule as the matrix data: an int RHS must not
            # flow into the float solve un-promoted
            b = b.astype(np.float64)
        b_bar = np.zeros(npad, dtype=b.dtype)
        b_bar[p] = b
    return a_bar, b_bar
