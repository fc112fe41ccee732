"""The port's host-clock spans (``repro_torch.spans``).

* The recorder: nested spans end inside their parent, each name's records
  give its count and seconds, a span that raises is recorded, and the ring
  keeps the last ``RING``.
* A solve (``solve``, ``solve_batched``, ``solve_slab``) records one each of
  ``solve.embed``, ``solve.loop`` and ``solve.extract``, in that order; the
  report's ``setup_seconds`` / ``solve_seconds`` are the embed's and the
  loop's lengths.
* ``nbytes`` counts the bytes that cross between host and device where
  they cross: none on the CPU; on the card (marked ``cuda``) the upload of
  ``slab_m`` x B elements, and the answer and the loop's scalars copied
  down.
* Set-up: the ``build.*`` spans are ``plan.timings`` (a build and a
  ``refactor``), and a plan's first solve records its table's segment
  analysis, the next one none.
* No span reaches ``torch.profiler``.
* The counters: ``count`` / ``counts`` / ``reset_counts`` by prefix, and
  ``snapshot`` / ``add`` as a replayed graph uses them; the kernels',
  mesh's and loops' views read them and reset only their own.
"""
import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.core import build_plan
from repro_torch.core.matrices import laplace_2d
from repro_torch.core.plan import _download, _upload

KNOBS = dict(method="hbmc", block_size=8, w=4, spmv_format="sell",
             device="cpu")
SOLVE = ("solve.embed", "solve.loop", "solve.extract")


@pytest.fixture
def plan():
    return build_plan(laplace_2d(12, 12), **KNOBS)


def _rhs(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n)


def test_nested_spans_and_totals():
    spans.reset()
    with spans.span("outer") as outer:
        with spans.span("inner") as inner:
            inner.nbytes = 48
        with spans.span("inner"):
            pass
    got = spans.recent()
    assert [r.name for r in got] == ["inner", "inner", "outer"]
    assert got[0].nbytes == 48 and got[2].nbytes == 0
    assert outer.start <= got[0].start <= got[0].end <= got[1].start \
        <= got[1].end <= outer.end
    assert outer.seconds == got[2].seconds == got[2].end - got[2].start
    assert spans.recent("inner") == got[:2]
    assert spans.recent("outer") == got[2:]
    assert spans.recent("none") == []


def test_span_that_raises_is_recorded():
    spans.reset()
    with pytest.raises(KeyError):
        with spans.span("failing"):
            raise KeyError("x")
    assert [r.name for r in spans.recent()] == ["failing"]


def test_ring_keeps_the_last_spans():
    spans.reset()
    for i in range(spans.RING + 3):
        with spans.span("s") as rec:
            rec.nbytes = i
    kept = spans.recent()
    assert len(kept) == spans.RING
    assert kept[0].nbytes == 3 and kept[-1].nbytes == spans.RING + 2
    spans.reset()
    assert spans.recent() == []


def _call(plan, kind, b):
    if kind == "solve":
        return plan.solve(b), 1
    if kind == "solve_batched":
        return plan.solve_batched(np.stack([b, 2 * b], axis=1)), 2
    return plan.solve_slab(b, slab_width=3, slot=1), 1


def _one_each(plan, kind):
    # the first call of a kind analyses its table's segments and, on the
    # card, captures its loop
    _call(plan, kind, _rhs(plan.n, 1))
    spans.reset()
    rep, columns = _call(plan, kind, _rhs(plan.n))
    assert [r.name for r in spans.recent()] == list(SOLVE)
    return rep, columns, spans.recent()


@pytest.mark.parametrize("kind", ["solve", "solve_batched", "solve_slab"])
def test_a_solve_records_embed_loop_and_extract(plan, kind):
    rep, _, (embed, loop, extract) = _one_each(plan, kind)
    assert rep.result.iterations is not None
    assert embed.end <= loop.start and loop.end <= extract.start
    assert rep.setup_seconds == embed.seconds
    assert rep.solve_seconds == loop.seconds
    # on the CPU nothing crosses between host and device
    assert embed.nbytes == extract.nbytes == 0


def test_extract_counts_the_bytes_it_copies():
    """The two places where a solve's bytes cross count them: an upload to
    a device that is not the host's, and a copy down from one."""
    host = np.arange(12, dtype=np.float64)
    rec = spans.span("t")
    got = _upload(host, torch.device("meta"), rec)
    assert got.device.type == "meta" and rec.nbytes == host.nbytes
    assert _upload(host, torch.device("cpu"), rec).data_ptr() == \
        host.__array_interface__["data"][0]
    assert rec.nbytes == host.nbytes           # the host's own: no copy

    class OnDevice:                            # a tensor held elsewhere
        device = torch.device("meta")
        nbytes = 40

        def cpu(self):
            return torch.zeros(5)
    assert _download(OnDevice(), rec).shape == (5,)
    assert rec.nbytes == host.nbytes + 40
    _download(torch.zeros(7), rec)
    assert rec.nbytes == host.nbytes + 40
    assert _upload(host, torch.device("meta")).device.type == "meta"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand-written kernels have no "
                    "CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["solve", "solve_batched", "solve_slab"])
def test_the_card_counts_what_crosses(cuda, kind):
    plan = build_plan(laplace_2d(64, 64), **dict(KNOBS, device="cuda"))
    rep, columns, (embed, _, extract) = _one_each(plan, kind)
    res = rep.result
    itemsize = torch.empty((), dtype=plan.dtype).element_size()
    assert embed.nbytes == plan.slab_m * columns * itemsize
    # the answer, then per column the iteration count (int64 in a single
    # solve, int32 in the batched and slab states), relres and the status
    # (int32), and the history
    count = 8 if kind == "solve" else 4
    scalars = columns * (count + itemsize + 4)
    history = np.asarray(res.history).nbytes
    assert extract.nbytes == plan.slab_m * columns * itemsize + scalars \
        + history


def test_build_spans_are_the_timings():
    spans.reset()
    a = laplace_2d(12, 12)
    plan = build_plan(a, **KNOBS)
    t = plan.timings
    (build,), (ordering,), (factor,), (pack,) = (
        spans.recent(n) for n in ("build", "build.ordering", "build.factor",
                                  "build.pack"))
    assert t.total == build.seconds
    assert (t.ordering, t.factor, t.pack) == (
        ordering.seconds, factor.seconds, pack.seconds)
    assert build.start <= ordering.start <= ordering.end <= factor.start \
        <= factor.end <= pack.start <= pack.end <= build.end
    assert t.ordering + t.factor + t.pack <= t.total

    spans.reset()
    again = plan.refactor(a * 2.0)
    (build,), (factor,), (pack,) = (
        spans.recent(n) for n in ("build", "build.factor", "build.pack"))
    assert spans.recent("build.ordering") == []
    assert (again.ordering, again.factor, again.pack, again.total) == (
        0.0, factor.seconds, pack.seconds, build.seconds)


def test_segment_analysis_runs_at_the_first_apply(plan):
    spans.reset()
    plan.solve(_rhs(plan.n))
    assert len(spans.recent("segments")) == 1
    spans.reset()
    plan.solve(_rhs(plan.n, 1))
    assert spans.recent("segments") == []


def test_spans_stay_out_of_the_profiler(plan):
    from torch.profiler import ProfilerActivity, profile
    plan.solve(_rhs(plan.n, 1))
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        plan.solve(_rhs(plan.n))
    recorded = {r.name for r in spans.recent()}
    assert set(SOLVE) <= recorded
    assert not recorded & {e.name for e in prof.events()}


def test_counters_by_prefix_snapshot_and_add():
    spans.reset_counts("test.")
    spans.count("test.a.x")
    spans.count("test.a.y", 5)
    spans.count("test.b", 2)
    assert spans.counts("test.a.") == {"x": 1, "y": 5}
    before = spans.snapshot()
    spans.count("test.a.x", 3)        # what a capture counted
    spans.count("test.c", 4)
    after = spans.snapshot()
    delta = {k: v - before.get(k, 0) for k, v in after.items()
             if v != before.get(k, 0)}
    assert delta == {"test.a.x": 3, "test.c": 4}
    spans.add(delta, -1)              # taken back out
    assert spans.counts("test.") == {"a.x": 1, "a.y": 5, "b": 2, "c": 0}
    spans.add(delta, times=2)         # two replays
    assert spans.counts("test.") == {"a.x": 7, "a.y": 5, "b": 2, "c": 8}
    spans.reset_counts("test.a.")
    assert spans.counts("test.") == {"b": 2, "c": 8}
    spans.reset_counts("test.")
    assert spans.counts("test.") == {}


def test_each_view_resets_its_own_counters():
    from repro_torch import kernels
    from repro_torch.core import device_loop, mesh
    kernels.reset_launch_counts()
    mesh.reset_gather_counts()
    device_loop.reset_loop_counts()
    spans.count("kernels.calls.sell_spmv", 2)
    spans.count("kernels.path.hbmc_trisolve.grouped", 3)
    spans.count("mesh.gathers.spmv")
    spans.count("loop.replays", 4)
    assert kernels.launch_counts()["sell_spmv"] == 2
    assert kernels.forwarding_counts()["hbmc_trisolve"] == {
        "on_chip": 0, "plain": 0, "grouped": 3}
    assert mesh.gather_counts() == {"trisolve": 0, "spmv": 1}
    assert device_loop.loop_counts() == {"reads": 0, "blocks": 0,
                                         "replays": 4, "captures": 0}
    kernels.reset_launch_counts()
    assert set(kernels.launch_counts().values()) == {0}
    assert mesh.gather_counts()["spmv"] == 1
    assert device_loop.loop_counts()["replays"] == 4
    mesh.reset_gather_counts()
    device_loop.reset_loop_counts()
    assert spans.counts("mesh.") == spans.counts("loop.") == {}
