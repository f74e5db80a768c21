"""Counters beside the spans of a query trace: ``coords`` and
``lower_coords``, recorded by ``ops.fused_candidates``.

On the CPU: both equal the counts of kernel A's operands (scored pairs,
and those with a negative value, read from the L rows) on signed batches, on all-positive
batches (no lower coordinate) and on an index without a lower sketch, in
the device-timed trace of an unstaged batch and in the synced trace of a
staged one; no counter on the traces of paths that do not run
``fused_candidates``; recording them adds no ``synchronize`` and no
``.item()`` to the query path; a device-timed trace reads them only once
its last event has completed.  With the ``gpu`` marker, on the card: the
counts stay on the card until the ring is read, with no sync on the
query path, and a read waits for no later batch.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.data import synth  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.obs import trace as otrace  # noqa: E402
from repro_torch.obs.trace import Trace  # noqa: E402
from repro_torch.serving.serve import QueryServer  # noqa: E402

DS = synth.SparseDatasetSpec("t", n=500, psi_doc=24, psi_query=10)
COUNTERS = ("coords", "lower_coords")


@pytest.fixture(autouse=True)
def fresh_ring():
    otrace.clear()
    reg = obs_metrics.get_registry()
    yield
    obs_metrics.set_registry(reg)
    otrace.clear()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: pinned copies behind the stream")
    return torch.device("cuda")


def _index(device="cpu", positive_only=False, n=200):
    spec = teng.EngineSpec(n=DS.n, m=16, h=2, capacity=256, max_nnz=32,
                           seed=4, positive_only=positive_only)
    index = teng.SinnamonIndex(spec, device=device)
    idx, val = synth.make_corpus(0, DS, n, pad=32)
    index.insert_many(list(range(n)), np.asarray(idx), np.asarray(val))
    otrace.clear()
    return index


def _queries(positive: bool, b=6, seed=1):
    qi, qv = synth.make_queries(seed, DS, b, pad=16)
    qi, qv = np.asarray(qi), np.asarray(qv)
    return qi, (np.abs(qv) if positive else qv)


def _want(index, qi, qv) -> dict:
    """The counts of kernel A's own operands."""
    st = index.state
    qv_t, _, brows, _, one_sided = ops.prepare_fused_operands(
        st, index.spec, torch.as_tensor(qi, device=st.device),
        torch.as_tensor(qv, dtype=torch.float32, device=st.device))
    scored = brows >= 0
    lower = scored & (qv_t < 0) if one_sided else torch.zeros_like(scored)
    return {"coords": int(scored.sum()), "lower_coords": int(lower.sum())}


@pytest.mark.parametrize("staged", (False, True), ids=("unstaged", "staged"))
@pytest.mark.parametrize("batch", ("signed", "positive", "no_lower_sketch"))
def test_counters_equal_operand_counts(batch, staged):
    index = _index(positive_only=batch == "no_lower_sketch")
    qi, qv = _queries(positive=batch == "positive")
    server = QueryServer(index, k=5, kprime=40,
                         trace_every=1 if staged else 0)
    server.query_many(qi, qv)
    if staged:
        tr = server.last_trace
        assert not tr.device_timed
    else:
        (tr,) = otrace.recent("query")
    want = _want(index, qi, qv)
    assert tr.counters == want
    ok = qi >= 0
    assert want["coords"] == int(ok.sum())
    if batch == "signed":
        assert want["lower_coords"] == int((ok & (qv < 0)).sum()) > 0
    else:
        assert want["lower_coords"] == 0


@pytest.mark.parametrize("path", ("reference", "grouped", "score_fn",
                                  "insert_many"))
def test_no_counters_off_the_fused_path(path):
    index = _index()
    qi, qv = _queries(positive=False)
    if path == "insert_many":
        idx, val = synth.make_corpus(3, DS, 8, pad=32)
        index.insert_many(list(range(300, 308)), np.asarray(idx),
                          np.asarray(val))
        traces = otrace.recent("insert_many")
    elif path == "score_fn":
        tr = Trace("query", index.device, device_timed=True)
        index.search_many(qi, qv, k=5, kprime=40,
                          score_fn=ops.make_engine_score_fn(), trace=tr)
        traces = [tr]
    else:
        QueryServer(index, k=5, kprime=40, score_backend=path).query_many(
            qi, qv)
        traces = otrace.recent("query")
    assert len(traces) == 1
    assert traces[0].counters == {}


def test_counters_add_no_sync_or_item(monkeypatch):
    """An unstaged batch makes the same ``synchronize`` and ``.item()``
    calls whether it records a trace with counters or none at all."""
    index = _index()
    qi, qv = _queries(positive=False)
    calls = []
    item, tolist = torch.Tensor.item, torch.Tensor.tolist
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: calls.append("synchronize"))
    monkeypatch.setattr(torch.Tensor, "item",
                        lambda self: calls.append("item") or item(self))
    monkeypatch.setattr(torch.Tensor, "tolist",
                        lambda self: calls.append("tolist") or tolist(self))
    traced = QueryServer(index, k=5, kprime=40)
    untraced = QueryServer(index, k=5, kprime=40,
                           registry=obs_metrics.NULL_REGISTRY)
    got = {}
    for name, server in (("untraced", untraced), ("traced", traced)):
        calls.clear()
        server.query_many(qi, qv)
        got[name] = list(calls)
    monkeypatch.undo()
    assert got["traced"] == got["untraced"]
    assert "synchronize" not in got["traced"]
    (tr,) = otrace.recent("query")
    assert tr.counters == _want(index, qi, qv)


class _Event:
    """A stand-in timing event that completes when ``done`` is set."""

    def __init__(self, done):
        self.done, self.t = done, 0.0

    def record(self, stream):
        pass

    def query(self):
        return self.done[0]

    def elapsed_time(self, end):
        return 1.0


class _Stream:
    pass


@pytest.mark.parametrize("device_timed", (False, True))
def test_counters_are_read_with_the_trace(monkeypatch, device_timed):
    """A synced trace reads its counters at once; a device-timed one when
    :func:`recent` finds its last event completed, and never before."""
    done = [False]
    monkeypatch.setattr(otrace, "_take_event", lambda index: _Event(done))
    tr = Trace("query", device_timed=device_timed)
    if device_timed:
        tr._stream, tr._index = _Stream(), 0
    with tr.span("a"):
        tr.count(COUNTERS, torch.tensor([7, 3]))
    with tr.span("b"):
        pass
    if not device_timed:
        assert tr.counters == {"coords": 7, "lower_coords": 3}
        return
    assert tr.counters == {}
    tr.finish()
    otrace.recent("query")
    assert tr.counters == {}                 # the copy is not known done
    done[0] = True
    (got,) = otrace.recent("query")
    assert got.counters == {"coords": 7, "lower_coords": 3}
    assert [s.device_ms for s in got.spans] == [1.0, 1.0]


def test_cpu_trace_without_events_reads_its_counters():
    """A device-timed trace on the CPU has no events: its counters are
    read when the ring is, and a name counted twice accumulates."""
    tr = Trace("query", torch.device("cpu"), device_timed=True)
    with tr.span("a"):
        tr.count(COUNTERS, torch.tensor([5, 0]))
    with tr.span("b"):
        tr.count(("coords",), torch.tensor([2]))
    assert tr.counters == {}
    tr.finish()
    (got,) = otrace.recent("query")
    assert got.counters == {"coords": 7, "lower_coords": 0}


# -- on the card --------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("positive", (False, True))
def test_counters_on_card_without_a_sync(cuda, monkeypatch, positive):
    index = _index(cuda)
    qi, qv = _queries(positive=positive)
    server = QueryServer(index, k=5, kprime=40)
    server.query_many(qi, qv)                 # kernels loaded, warm
    torch.cuda.synchronize()
    otrace.clear()
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: calls.append("synchronize"))
    monkeypatch.setattr(torch.cuda.Event, "synchronize",
                        lambda self: calls.append("event"))
    server.query_many(qi, qv)
    monkeypatch.undo()
    assert calls == []
    torch.cuda.synchronize()
    (tr,) = otrace.recent("query")
    assert tr.counters == _want(index, qi, qv)
    assert (tr.counters["lower_coords"] == 0) is positive


@pytest.mark.gpu
def test_counters_read_waits_for_no_later_batch(cuda):
    """Once a batch's events have completed, reading its counters does not
    wait for work queued on the serving stream since."""
    import time
    index = _index(cuda)
    qi, qv = _queries(positive=False)
    server = QueryServer(index, k=5, kprime=40)
    server.query_many(qi, qv)
    torch.cuda.synchronize()
    otrace.clear()
    server.query_many(qi, qv)
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)           # about a second of the card
    t0 = time.perf_counter()
    (tr,) = otrace.recent("query")
    waited = time.perf_counter() - t0
    busy = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    assert busy and waited < 0.25
    assert tr.counters == _want(index, qi, qv)
