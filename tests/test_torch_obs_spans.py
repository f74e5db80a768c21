"""Device-timed spans inside the port's query and write paths.

On the CPU: the stage names and order of the ``query``, ``insert_many``
and ``kernel_load`` traces (deletes record none), host starts inside the
call, no device durations, answers and index state bit-equal with and
without a trace, the ring's bound and ``clear()``, device durations read
only when the ring or a context is read (timing events stood in for),
``NULL_REGISTRY`` recording nothing, the staged path's ``last_trace`` and
``repro_query_stage_ms`` unchanged, the ``repro.*`` ranges under
``torch.profiler``, and the sub-stages a ``TraceContext`` imports.  With
the ``gpu`` marker, on the card: an unstaged batch makes no sync, every
span gets a device duration no longer than the batch, insert traces
resolve once the card is idle, and a kernel's first load is traced.
"""

import time

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.data import synth  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.obs import trace as otrace  # noqa: E402
from repro_torch.obs.trace import Trace, TraceContext  # noqa: E402
from repro_torch.serving.serve import QUERY_STAGES  # noqa: E402
from repro_torch.serving.serve import QueryServer  # noqa: E402

QUERY = ["admission", "sketch_scan", "topk_merge", "rerank", "to_host"]
INSERT = ["prep", "id_map", "encode", "bitmap", "sketch", "csr", "id_map"]
BACKENDS = ("fused", "reference", "grouped")
DS = synth.SparseDatasetSpec("t", n=500, psi_doc=24, psi_query=10)


@pytest.fixture(autouse=True)
def fresh_ring():
    """Every test starts and ends with an empty ring and the global
    registry it found."""
    otrace.clear()
    reg = obs_metrics.get_registry()
    yield
    obs_metrics.set_registry(reg)
    otrace.clear()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA timing events")
    return torch.device("cuda")


def _spec(capacity=256):
    return teng.EngineSpec(n=DS.n, m=16, h=2, capacity=capacity,
                           max_nnz=32, seed=4)


def _corpus(n=200, seed=0):
    idx, val = synth.make_corpus(seed, DS, n, pad=32)
    return np.asarray(idx), np.asarray(val)


def _queries(b=6, seed=1):
    qi, qv = synth.make_queries(seed, DS, b, pad=16)
    return np.asarray(qi), np.asarray(qv)


def _index(device="cpu", cls=teng.SinnamonIndex, n=200, **kw):
    index = cls(_spec(), device=device, **kw)
    idx, val = _corpus(n)
    index.insert_many(list(range(n)), idx, val)
    otrace.clear()
    return index


def _state(index):
    st = index.state
    return {f: getattr(st, f).cpu().clone()
            for f in ("sketch", "bits", "active", "ids", "dirty")} | {
        "store_i": st.store.indices.cpu().clone(),
        "store_v": st.store.values.cpu().clone()}


def _assert_host_times(tr, t_call0, t_call1):
    starts = [s.start_ms for s in tr.spans]
    assert starts == sorted(starts)
    assert t_call0 <= tr.t0 <= t_call1
    for s in tr.spans:
        assert s.ms >= 0.0
        assert tr.t0 + s.start_ms * 1e-3 >= t_call0 - 1e-9
        assert tr.t0 + (s.start_ms + s.ms) * 1e-3 <= t_call1 + 1e-9


# -- query path ------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_query_trace_stages_and_host_times(backend):
    index = _index()
    server = QueryServer(index, k=5, kprime=40, score_backend=backend)
    qi, qv = _queries()
    t0 = time.perf_counter()
    res = server.query_many(qi, qv)
    t1 = time.perf_counter()
    (tr,) = otrace.recent("query")
    assert tr.name == "query" and tr.device_timed
    assert [s.name for s in tr.spans] == QUERY
    assert tr.trace_id == res.trace_id
    assert all(s.device_ms is None for s in tr.spans)
    _assert_host_times(tr, t0, t1)
    assert server.last_trace is None


@pytest.mark.parametrize("backend", BACKENDS)
def test_answers_equal_with_and_without_a_trace(backend):
    index = _index()
    qi, qv = _queries(8, seed=5)
    plain = index.search_many(qi, qv, k=5, kprime=40, backend=backend)
    tr = Trace("query", index.device, device_timed=True)
    traced = index.search_many(qi, qv, k=5, kprime=40, backend=backend,
                               trace=tr)
    for a, b in zip(plain, traced):
        np.testing.assert_array_equal(a, b)
    assert [s.name for s in tr.spans] == QUERY
    one = index.search(qi[0], qv[0], k=5, kprime=40, backend=backend,
                       trace=Trace("query", index.device, device_timed=True))
    np.testing.assert_array_equal(one[0], plain[0][0])
    np.testing.assert_array_equal(one[1], plain[1][0])
    assert otrace.recent("query") == []        # the caller finishes a trace


def test_single_query_records_one_trace_and_a_context():
    index = _index()
    server = QueryServer(index, k=5, kprime=40)
    qi, qv = _queries(2)
    ctx = TraceContext()
    res = server.query(qi[0], qv[0], ctx=ctx)
    (tr,) = otrace.recent("query")
    assert [s.name for s in tr.spans] == QUERY
    assert tr.trace_id == res.trace_id == ctx.trace_id
    subs = [st for st in ctx.to_dict()["stages"]
            if st["stage"].startswith("device/")]
    assert [st["stage"] for st in subs] == ["device/" + n for n in QUERY]
    assert all("start_ms" in st and "device_ms" not in st for st in subs)
    starts = [st["start_ms"] for st in subs]
    assert starts == sorted(starts) and starts[0] >= 0.0


def test_staged_path_unchanged():
    """The staged batch keeps its synced spans on ``last_trace`` and in
    ``repro_query_stage_ms``; only the unstaged batches enter the ring."""
    reg = obs_metrics.MetricsRegistry()
    index = _index()
    server = QueryServer(index, k=5, kprime=40, trace_every=2, registry=reg)
    qi, qv = _queries()
    a = server.query_many(qi, qv)           # unstaged
    assert server.last_trace is None
    b = server.query_many(qi, qv)           # staged
    np.testing.assert_array_equal(a.ids, b.ids)
    assert [s.name for s in server.last_trace.spans] == list(QUERY_STAGES)
    assert not server.last_trace.device_timed
    assert len(otrace.recent("query")) == 1
    snap = reg.snapshot()
    stages = {s["labels"]["stage"]
              for s in snap["repro_query_stage_ms"]["series"]}
    assert stages == set(QUERY_STAGES)
    assert snap["repro_query_traces_total"]["series"][0]["value"] == 1


def test_score_fn_and_sketch_only_batches_are_not_traced():
    from repro_torch.kernels import ops
    index = _index()
    qi, qv = _queries()
    QueryServer(index, k=5, kprime=40,
                score_fn=ops.make_engine_score_fn()).query_many(qi, qv)
    QueryServer(index, k=5, kprime=40).query_many(qi, qv, degrade=2)
    assert otrace.recent("query") == []
    QueryServer(index, k=5, kprime=40).query_many(qi, qv, degrade=1)
    assert len(otrace.recent("query")) == 1


def test_tiered_query_trace_has_prefetch():
    index = _index(cls=teng.TieredSinnamonIndex, tier_chunk_slots=32,
                   cache_chunks=2)
    resident = _index()
    qi, qv = _queries()
    got = QueryServer(index, k=5, kprime=40).query_many(qi, qv)
    want = QueryServer(resident, k=5, kprime=40).query_many(qi, qv)
    np.testing.assert_array_equal(got.ids, want.ids)
    tiered = [t for t in otrace.recent("query")
              if "prefetch" in [s.name for s in t.spans]]
    assert len(tiered) == 1
    assert [s.name for s in tiered[0].spans] == [
        "admission", "sketch_scan", "topk_merge", "prefetch", "rerank",
        "to_host"]


def test_null_registry_server_records_nothing():
    index = _index()
    qi, qv = _queries()
    a = QueryServer(index, k=5, kprime=40,
                    registry=obs_metrics.NULL_REGISTRY).query_many(qi, qv)
    assert otrace.recent("query") == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        QueryServer(index, k=5, kprime=40,
                    registry=obs_metrics.NULL_REGISTRY).query_many(qi, qv)
    assert not [e for e in prof.events() if e.name.startswith("repro.")]
    b = QueryServer(index, k=5, kprime=40).query_many(qi, qv)
    np.testing.assert_array_equal(a.ids, b.ids)


# -- write path ------------------------------------------------------------------

@pytest.mark.parametrize("cls", [teng.SinnamonIndex,
                                 teng.TieredSinnamonIndex])
def test_write_traces_stages_and_state_bit_equal(cls):
    kw = {"tier_chunk_slots": 32, "cache_chunks": 2} \
        if cls is teng.TieredSinnamonIndex else {}
    idx, val = _corpus(120, seed=3)
    states = []
    for traced in (True, False):
        obs_metrics.set_registry(obs_metrics.MetricsRegistry() if traced
                                 else obs_metrics.NULL_REGISTRY)
        otrace.clear()
        index = cls(_spec(), device="cpu", **kw)
        t0 = time.perf_counter()
        index.insert_many(list(range(100)), idx[:100], val[:100])
        t1 = time.perf_counter()
        index.delete_many([3, 7, 11])
        index.insert_many([8, 200, 201], idx[100:103], val[100:103])
        index.insert(300, idx[110][:5], val[110][:5])
        index.delete(200)
        ins = otrace.recent("insert_many")
        # deletes, the overwrite of id 8 inside an insert among them,
        # record no trace
        assert otrace.recent("delete_many") == []
        if traced:
            assert len(ins) == 3
            assert all([s.name for s in t.spans] == INSERT for t in ins)
            assert all(s.device_ms is None for t in ins for s in t.spans)
            _assert_host_times(ins[0], t0, t1)
            assert ins[0].t0 < ins[1].t0 < ins[2].t0
        else:
            assert ins == []
        states.append((_state(index), dict(index._id2slot),
                       list(index._free)))
    (sa, ma, fa), (sb, mb, fb) = states
    assert ma == mb and fa == fb
    for name in sa:
        assert torch.equal(sa[name], sb[name]), name


def test_write_path_functions_take_no_trace_by_default():
    spec = _spec(64)
    state = teng.init(spec, "cpu")
    idx, val = _corpus(4)
    teng.insert(state, spec, 5, 50, torch.from_numpy(idx[0]),
                torch.from_numpy(val[0]))
    teng.delete(state, spec, 5)
    assert not state.active.any() and bool(state.dirty[5])
    assert otrace.recent("insert_many") == []


# -- the ring --------------------------------------------------------------------

def test_ring_is_bounded_per_operation_and_cleared(monkeypatch):
    monkeypatch.setattr(otrace, "RING", 4)
    otrace.clear()              # rings are made with the bound in force
    for i in range(7):
        Trace("query", device_timed=True, trace_id=str(i)).finish()
    Trace("insert_many", device_timed=True).finish()
    assert [t.trace_id for t in otrace.recent("query")] == list("3456")
    assert len(otrace.recent("insert_many")) == 1
    assert otrace.recent("delete_many") == []
    otrace.clear()
    assert otrace.recent("query") == [] == otrace.recent("insert_many")


def test_obs_imports_without_torch():
    import subprocess
    import sys
    code = ("import sys; sys.modules['torch'] = None\n"
            "from repro_torch.obs import trace as t\n"
            "tr = t.Trace('query', device_timed=True)\n"
            "with tr.span('a'):\n    pass\n"
            "with t.profiler_range('x'):\n    pass\n"
            "tr.finish(); assert t.recent('query')[0].spans[0].name == 'a'\n")
    import os
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env=dict(os.environ, PYTHONPATH=src))


def test_synced_spans_carry_host_starts():
    tr = Trace()
    with tr.span("a"):
        pass
    with tr.span("b"):
        pass
    assert 0.0 <= tr.spans[0].start_ms <= tr.spans[1].start_ms
    assert tr.stage_ms().keys() == {"a", "b"}
    ctx = TraceContext()
    ctx.add_trace(tr, prefix="device/")
    d = ctx.to_dict()["stages"]
    assert [s["stage"] for s in d] == ["device/a", "device/b"]
    assert all("start_ms" in s and "device_ms" not in s for s in d)


def test_context_reports_a_device_duration_once_read():
    tr = Trace("query", device_timed=True)
    with tr.span("a"):
        pass
    ctx = TraceContext()
    ctx.add_trace(tr, prefix="device/")
    assert "device_ms" not in ctx.to_dict()["stages"][0]
    tr.spans[0].device_ms = 1.25          # as a completed event pair sets it
    assert ctx.to_dict()["stages"][0]["device_ms"] == 1.25


class _Event:
    """A stand-in timing event: completes when ``done`` is set; counts
    its reads."""

    def __init__(self, log, done):
        self.log, self.done, self.t = log, done, None

    def record(self, stream):
        self.t = stream.now = stream.now + 1.0

    def query(self):
        self.log.append("query")
        return self.done[0]

    def elapsed_time(self, end):
        self.log.append("elapsed")
        return end.t - self.t


class _Stream:
    now = 0.0


def _events_trace(monkeypatch, done, log, name="query"):
    monkeypatch.setattr(otrace, "_take_event",
                        lambda index: _Event(log, done))
    tr = Trace(name, device_timed=True)
    tr._stream, tr._index = _Stream(), 0
    for stage in ("a", "b", "c"):
        with tr.span(stage):
            pass
    return tr


def test_device_durations_are_read_when_the_ring_is_read(monkeypatch):
    monkeypatch.setattr(otrace, "_EVENTS", {})
    done, log = [False], []
    tr = _events_trace(monkeypatch, done, log)
    assert len(tr._events) == 4          # neighbouring spans share one
    tr.finish()
    assert log == []                     # finishing reads nothing
    (got,) = otrace.recent("query")
    assert log == ["query"]              # the last event only, not done
    assert all(s.device_ms is None for s in got.spans)
    done[0] = True
    otrace.recent("query")
    assert [s.device_ms for s in got.spans] == [1.0, 1.0, 1.0]
    assert log.count("elapsed") == 3 and not got._events
    assert len(otrace._EVENTS[0]) == 4   # the events went back to the pool
    log.clear()
    otrace.recent("query")
    assert log == []                     # a read trace is not read again


def test_context_reads_its_device_durations_and_the_pool_is_bounded(
        monkeypatch):
    monkeypatch.setattr(otrace, "_EVENTS", {})
    monkeypatch.setattr(otrace, "POOL", 2)
    done, log = [True], []
    tr = _events_trace(monkeypatch, done, log)
    tr.finish()
    ctx = TraceContext()
    ctx.add_trace(tr, prefix="device/")
    stages = ctx.to_dict()["stages"]
    assert [st["device_ms"] for st in stages] == [1.0, 1.0, 1.0]
    assert len(otrace._EVENTS[0]) == 2
    assert otrace.recent("query")[0] is tr and log.count("elapsed") == 3


# -- the profiler's clock ---------------------------------------------------------

def test_repro_ranges_under_the_profiler():
    index = _index()
    qi, qv = _queries()
    idx, val = _corpus(8, seed=9)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        QueryServer(index, k=5, kprime=40).query_many(qi, qv)
        index.insert_many(list(range(500, 508)), idx, val)
        index.delete_many([500])
    names = {e.name for e in prof.events()}
    assert {"repro.query_many"} | {f"repro.query.{s}" for s in QUERY} <= names
    assert {f"repro.insert_many.{s}" for s in INSERT} <= names
    assert not any(n.startswith("repro.delete_many") for n in names)
    assert not any(n.startswith("bench.") for n in names)
    # no profiler: no range, one flag read
    assert otrace.profiler_range("x") is otrace.span(None, "x")


# -- on the card --------------------------------------------------------------------

@pytest.mark.gpu
def test_unstaged_batch_makes_no_sync_on_card(cuda, monkeypatch):
    index = _index(cuda)
    server = QueryServer(index, k=5, kprime=40)
    qi, qv = _queries()
    server.query_many(qi, qv)                 # kernels loaded, warm
    torch.cuda.synchronize()
    otrace.clear()
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: calls.append("synchronize"))
    monkeypatch.setattr(torch.cuda.Event, "synchronize",
                        lambda self: calls.append("event"))
    t0 = time.perf_counter()
    res = server.query_many(qi, qv)
    host_ms = (time.perf_counter() - t0) * 1e3
    monkeypatch.undo()
    assert calls == []
    staged = QueryServer(index, k=5, kprime=40, trace_every=1)
    np.testing.assert_array_equal(res.ids, staged.query_many(qi, qv).ids)
    torch.cuda.synchronize()
    (tr,) = otrace.recent("query")
    assert [s.name for s in tr.spans] == QUERY
    assert all(s.device_ms is not None and s.device_ms >= 0.0
               for s in tr.spans)
    assert sum(s.device_ms for s in tr.spans) <= host_ms


@pytest.mark.gpu
def test_write_traces_resolve_on_card(cuda):
    index = _index(cuda)
    idx, val = _corpus(40, seed=6)
    index.insert_many(list(range(300, 340)), idx, val)
    index.delete_many(list(range(300, 320)))
    torch.cuda.synchronize()
    (ins,) = otrace.recent("insert_many")
    assert otrace.recent("delete_many") == []
    assert [s.name for s in ins.spans] == INSERT
    assert all(s.device_ms is not None and s.device_ms >= 0.0
               for s in ins.spans)
    assert not ins._events                 # the events went back to the pool


@pytest.mark.gpu
def test_kernel_load_is_traced_on_card(cuda, monkeypatch):
    from repro_torch.kernels import _build
    _build.load("csr_rerank")
    monkeypatch.delitem(_build._LOADED, "csr_rerank")
    otrace.clear()
    lib = _build.load("csr_rerank")
    assert lib is _build._LOADED["csr_rerank"]
    (tr,) = otrace.recent("kernel_load")
    assert [s.name for s in tr.spans] == ["csr_rerank"]
    assert tr.spans[0].ms > 0.0
