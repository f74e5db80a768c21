"""The port's front door and load generator against the reference's.

* The cases of ``tests/test_frontend.py`` and
  ``tests/test_frontend_resilience.py`` on ``repro_torch.serving``: the
  coalesced answers bit-identical to per-query ``QueryServer.query`` on the
  port's own CPU index (every backend); backpressure, deadline expiry,
  quotas, shutdown, HTTP, tracing, the poisoned batch, the supervisor, the
  circuit breaker, the watchdog and the degradation ladder against stub
  servers.  Where the reference's tests sleep to order threads, these wait
  on events or drive a fake clock.
* Across the two packages: the same requests through repro's front door
  over repro's ``QueryServer`` and through the port's over the port's give
  the same ids (scores within rtol = atol = 1e-5, kernel B's tolerance);
  with one fake clock a submit sequence gives the same outcomes, reject
  reasons and ``retry_after_ms``; the front door's metric families and
  label sets are equal in both expositions; every destination of the
  reference launcher's argparse exists in the port's; the port's launcher
  with ``--serve-port 0`` answers a POST.
"""

import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, as the suite runs it)
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro.core import engine as jeng  # noqa: E402
from repro.launch import serve as jlauncher  # noqa: E402
from repro.fault.retry import CircuitBreaker as JBreaker  # noqa: E402
from repro.obs import MetricsRegistry as JRegistry  # noqa: E402
from repro.serving import frontend as jfe  # noqa: E402
from repro.serving.results import QueryResult as JResult  # noqa: E402
from repro.serving.serve import QueryServer as JServer  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.data import synth  # noqa: E402
from repro_torch.fault.degrade import DegradeConfig  # noqa: E402
from repro_torch.fault.retry import CircuitBreaker  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.obs import FlightRecorder, MetricsRegistry  # noqa: E402
from repro_torch.obs.metrics import parse_exposition  # noqa: E402
from repro_torch.serving import loadgen  # noqa: E402
from repro_torch.serving.frontend import (  # noqa: E402
    DeadlineExceeded, DeviceStuck, FrontendServer, Rejected,
    ServingFrontend, TenantQuota)
from repro_torch.serving.results import QueryResult  # noqa: E402
from repro_torch.serving.serve import QueryServer  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
DS = synth.SparseDatasetSpec("fe", n=512, psi_doc=20, psi_query=10,
                             value_dist="gaussian")
N_DOCS = 192
POISON = 12345.0        # marker value: a malformed query the device rejects


def _spec(pkg):
    return pkg.EngineSpec(n=DS.n, m=12, capacity=256, max_nnz=32, h=2,
                          seed=3, value_dtype="float32")


@pytest.fixture(scope="module")
def corpus():
    idx, val = synth.make_corpus(0, DS, N_DOCS, pad=32)
    qi, qv = synth.make_queries(1, DS, 16, pad=16)
    return idx, val, qi, qv


def _port_server(corpus, backend=None):
    idx, val, _, _ = corpus
    index = teng.SinnamonIndex(_spec(teng), device="cpu")
    index.insert_many(list(range(N_DOCS)), idx, val)
    return QueryServer(index, k=10, kprime=40, score_backend=backend)


@pytest.fixture(scope="module")
def served(corpus):
    return _port_server(corpus), corpus[2], corpus[3]


class _StubServer:
    """Device stand-in: controllable stall (``gate``), signals each entry
    (``entered``), rejects poisoned rows, records (rows, degrade level)."""

    def __init__(self, k=4, gate: threading.Event = None, result=QueryResult):
        self.k = k
        self.gate = gate
        self.entered = threading.Event()
        self.calls = []
        self._result = result

    def query_many(self, qi, qv, ctx=None, degrade=0):
        self.entered.set()
        if self.gate is not None:
            self.gate.wait()
        self.calls.append((qi.shape[0], degrade))
        if np.any(qv == POISON):
            raise ValueError("malformed query rejected by device")
        B = qi.shape[0]
        ids = np.tile(np.arange(self.k, dtype=np.int64), (B, 1))
        return self._result(ids=ids, scores=np.zeros((B, self.k), np.float32),
                            k=self.k, backend="stub", trace_id="q-stub",
                            degraded=degrade > 0)


class _LoopBug(BaseException):
    """Escapes the batch-level ``except Exception``: a bug in the dispatch
    loop itself, which only the supervisor catches."""


class _BuggyServer(_StubServer):
    def query_many(self, qi, qv, ctx=None, degrade=0):
        raise _LoopBug("dispatch loop bug")


def _q(seed=0, nnz=8, poison=False):
    rng = np.random.default_rng(seed)
    qi = rng.choice(DS.n, nnz, replace=False).astype(np.int32)
    qv = rng.random(nnz, np.float32)
    if poison:
        qv[0] = POISON
    return qi, qv


def _series(reg, name):
    fam = json.loads(reg.to_json()).get(name)
    return [] if fam is None else fam["series"]


def _wait_until(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.005)
    return pred()


# ---------------------------------------------------------------------------
# bit-identity of coalesced batches (the port's engine)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["fused", "reference", "grouped"])
def test_coalesced_bit_identical_to_per_query(corpus, backend):
    server = _port_server(corpus, backend)
    qi, qv = corpus[2], corpus[3]
    expect = [server.query(qi[b], qv[b]) for b in range(qi.shape[0])]
    fe = ServingFrontend(server, max_batch=8, batch_window_ms=50.0,
                         queue_depth=64)
    try:
        futs = [fe.submit(qi[b], qv[b]) for b in range(qi.shape[0])]
        got = [f.result(timeout=60) for f in futs]
    finally:
        fe.close()
    for b, (g, e) in enumerate(zip(got, expect)):
        np.testing.assert_array_equal(g.ids, e.ids, err_msg=f"query {b}")
        np.testing.assert_array_equal(g.scores, e.scores,
                                      err_msg=f"query {b}: scores")
        assert g.k == e.k and g.backend == e.backend == backend


def test_batches_actually_coalesce():
    """The identity test must not pass vacuously via batch-of-1 dispatches."""
    gate = threading.Event()
    stub = _StubServer(gate=gate)
    fe = ServingFrontend(stub, max_batch=8, batch_window_ms=5.0,
                         queue_depth=64)
    try:
        qi, qv = _q()
        futs = [fe.submit(qi, qv) for _ in range(8)]
        gate.set()
        for f in futs:
            f.result(timeout=30)
    finally:
        fe.close()
    assert max(rows for rows, _ in stub.calls) > 1, (
        f"8 concurrent submits never coalesced: dispatched {stub.calls}")


def test_mixed_widths_pad_without_crosstalk(served):
    """Different-nnz queries coalesced into one rectangle answer as alone."""
    server, qi, qv = served
    short_i, short_v = qi[0][:6].copy(), qv[0][:6].copy()
    expect_short = server.query(short_i, short_v)
    expect_full = server.query(qi[1], qv[1])
    fe = ServingFrontend(server, max_batch=4, batch_window_ms=50.0,
                         queue_depth=16)
    try:
        fa = fe.submit(short_i, short_v)
        fb = fe.submit(qi[1], qv[1])
        ga, gb = fa.result(timeout=60), fb.result(timeout=60)
    finally:
        fe.close()
    for got, want in ((ga, expect_short), (gb, expect_full)):
        np.testing.assert_array_equal(got.ids, want.ids)
        np.testing.assert_array_equal(got.scores, want.scores)


# ---------------------------------------------------------------------------
# backpressure / deadline / quotas (stub device)
# ---------------------------------------------------------------------------

def test_backpressure_rejects_at_full_queue():
    gate = threading.Event()
    stub = _StubServer(gate=gate)
    reg = MetricsRegistry()
    fe = ServingFrontend(stub, max_batch=2, batch_window_ms=1000.0,
                         queue_depth=4, registry=reg)
    try:
        qi, qv = _q()
        held = [fe.submit(qi, qv) for _ in range(4)]   # device is stalled
        with pytest.raises(Rejected) as exc:
            fe.submit(qi, qv)
        assert exc.value.reason == "queue_full"
        assert exc.value.retry_after_ms > 0
        gate.set()
        for f in held:
            f.result(timeout=30)
        rej = [s["value"] for s in _series(reg, "repro_frontend_rejected_total")
               if s["labels"].get("reason") == "queue_full"]
        assert rej == [1]
    finally:
        fe.close()


def test_deadline_expiry_under_stalled_device():
    """Fake clock: the deadlines elapse while the device stalls."""
    t = [100.0]
    gate = threading.Event()
    stub = _StubServer(gate=gate)
    reg = MetricsRegistry()
    fe = ServingFrontend(stub, max_batch=4, batch_window_ms=0.0,
                         queue_depth=16, default_deadline_ms=30.0,
                         registry=reg, clock=lambda: t[0])
    try:
        qi, qv = _q()
        blocker = fe.submit(qi, qv, deadline_ms=60_000)
        assert stub.entered.wait(10)       # the dispatcher holds the device
        doomed = [fe.submit(qi, qv, deadline_ms=20.0) for _ in range(3)]
        t[0] += 0.1
        gate.set()
        blocker.result(timeout=30)
        for f in doomed:
            with pytest.raises(DeadlineExceeded) as exc:
                f.result(timeout=30)
            assert exc.value.queued_ms >= 20.0
        assert [s["value"] for s in
                _series(reg, "repro_frontend_expired_total")] == [3]
    finally:
        fe.close()


def test_per_tenant_quota_isolation():
    stub = _StubServer()
    reg = MetricsRegistry()
    fe = ServingFrontend(
        stub, max_batch=4, batch_window_ms=0.0, queue_depth=64,
        quotas={"limited": TenantQuota(rate_qps=1.0, burst=2)},
        registry=reg)
    try:
        qi, qv = _q()
        ok = [fe.submit(qi, qv, tenant="limited") for _ in range(2)]
        with pytest.raises(Rejected) as exc:
            fe.submit(qi, qv, tenant="limited")
        assert exc.value.reason == "throttled"
        assert exc.value.tenant == "limited"
        assert exc.value.retry_after_ms > 0
        free = [fe.submit(qi, qv, tenant="free") for _ in range(16)]
        for f in ok + free:
            f.result(timeout=30)
        throttled = {s["labels"]["tenant"]: s["value"] for s in
                     _series(reg, "repro_frontend_throttled_total")}
        assert throttled == {"limited": 1}
    finally:
        fe.close()


def test_quota_refills_over_time():
    stub = _StubServer()
    t = [0.0]
    fe = ServingFrontend(
        stub, max_batch=4, batch_window_ms=0.0, queue_depth=64,
        default_quota=TenantQuota(rate_qps=10.0, burst=1),
        clock=lambda: t[0])
    try:
        qi, qv = _q()
        f1 = fe.submit(qi, qv)
        with pytest.raises(Rejected):
            fe.submit(qi, qv)
        t[0] += 0.2                   # 0.2 s at 10 qps: 2 tokens back
        f2 = fe.submit(qi, qv)
        for f in (f1, f2):
            f.result(timeout=30)
    finally:
        fe.close()


def test_close_without_drain_fails_queued_futures():
    gate = threading.Event()
    stub = _StubServer(gate=gate)
    fe = ServingFrontend(stub, max_batch=1, batch_window_ms=0.0,
                         queue_depth=16)
    qi, qv = _q()
    stuck = fe.submit(qi, qv)
    assert stub.entered.wait(10)
    queued = [fe.submit(qi, qv) for _ in range(3)]
    threading.Timer(0.05, gate.set).start()
    fe.close(drain=False)
    stuck.result(timeout=30)          # the in-flight dispatch still completes
    for f in queued:
        with pytest.raises(Rejected) as exc:
            f.result(timeout=30)
        assert exc.value.reason == "shutdown"
    with pytest.raises(RuntimeError):
        fe.submit(qi, qv)


# ---------------------------------------------------------------------------
# HTTP front door
# ---------------------------------------------------------------------------

def _post(url, doc, timeout=60):
    req = urllib.request.Request(url + "/v1/query",
                                 data=json.dumps(doc).encode(),
                                 method="POST")
    return json.loads(urllib.request.urlopen(req, timeout=timeout).read())


def test_http_round_trip(served):
    server, qi, qv = served
    expect = server.query(qi[2], qv[2])
    reg = MetricsRegistry()
    fe = ServingFrontend(server, max_batch=4, batch_window_ms=1.0,
                         queue_depth=32, registry=reg)
    try:
        with FrontendServer(fe, port=0, registry=reg) as door:
            doc = _post(door.url, {"indices": qi[2].tolist(),
                                   "values": qv[2].tolist()})
            assert doc["ids"] == [int(i) for i in expect.ids]
            np.testing.assert_array_equal(
                np.asarray(doc["scores"], np.float32), expect.scores)
            assert doc["k"] == expect.k
            assert doc["backend"] == expect.backend == "fused"
            assert doc["trace_id"].startswith("q-")
            assert doc["degraded"] is False
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(urllib.request.Request(
                    door.url + "/v1/query", data=b'{"indices": [1, 2]}',
                    method="POST"), timeout=30)
            assert exc.value.code == 400
            scrape = urllib.request.urlopen(door.url + "/metrics",
                                            timeout=30).read().decode()
            names = {n for (n, _l) in parse_exposition(scrape)}
            assert any(n.startswith("repro_frontend_requests_total")
                       for n in names)
            assert urllib.request.urlopen(
                door.url + "/healthz", timeout=30).read() == b"ok\n"
            assert urllib.request.urlopen(
                door.url + "/readyz", timeout=30).status == 200
    finally:
        fe.close()


def test_http_429_with_retry_after():
    stub = _StubServer(gate=threading.Event())       # never released
    fe = ServingFrontend(stub, max_batch=1, batch_window_ms=0.0,
                         queue_depth=1)
    try:
        with FrontendServer(fe, port=0) as door:
            qi, qv = _q()
            fe.submit(qi, qv)          # the dispatcher picks this up, stalls
            assert stub.entered.wait(10)
            fe.submit(qi, qv)          # fills the depth-1 queue
            with pytest.raises(urllib.error.HTTPError) as exc:
                _post(door.url, {"indices": qi.tolist(),
                                 "values": qv.tolist()}, timeout=30)
            assert exc.value.code == 429
            assert int(exc.value.headers["Retry-After"]) >= 1
            assert json.loads(exc.value.read())["reason"] == "queue_full"
    finally:
        stub.gate.set()
        fe.close(drain=False)


# ---------------------------------------------------------------------------
# request tracing + flight recorder
# ---------------------------------------------------------------------------

def test_stage_attribution_sums_to_latency(served):
    server, qi, qv = served
    rec = FlightRecorder(capacity=64, sample_rate=1.0, spill=False,
                         registry=MetricsRegistry())
    fe = ServingFrontend(server, max_batch=4, batch_window_ms=1.0,
                         queue_depth=32, recorder=rec)
    try:
        fe.query(qi[0], qv[0])
        res = fe.query(qi[1], qv[1])
    finally:
        fe.close()
    trace = rec.get(res.trace_id)
    assert trace is not None and trace["outcome"] == "ok"
    names = [s["stage"] for s in trace["stages"]]
    assert {"quota", "queue", "assembly", "device", "respond"} <= set(names)
    stage_sum = sum(s["ms"] for s in trace["stages"]
                    if not s["stage"].startswith("device/"))
    total = trace["total_ms"]
    assert 0.5 * total <= stage_sum <= 1.5 * total + 1.0
    assert trace["batch_size"] >= 1
    assert trace["width_bucket"] % fe.query_pad == 0
    assert 0.0 <= trace["padding_fraction"] < 1.0
    batch = rec.get_batch(trace["batch_id"])
    assert batch is not None and res.trace_id in batch["trace_ids"]
    assert any(s["stage"] == "device" for s in batch["stages"])


def test_rejected_and_expired_recoverable_from_recorder():
    t = [0.0]
    gate = threading.Event()
    stub = _StubServer(gate=gate)
    rec = FlightRecorder(capacity=64, sample_rate=0.0, spill=False,
                         registry=MetricsRegistry())
    fe = ServingFrontend(stub, max_batch=1, batch_window_ms=0.0,
                         queue_depth=2, default_deadline_ms=60_000,
                         recorder=rec, clock=lambda: t[0])
    try:
        qi, qv = _q()
        blocker = fe.submit(qi, qv)
        assert stub.entered.wait(10)
        doomed = fe.submit(qi, qv, deadline_ms=10.0)
        fe.submit(qi, qv)              # fills the depth-2 queue
        with pytest.raises(Rejected) as rej:
            fe.submit(qi, qv)
        t[0] += 0.05                   # doomed's deadline elapses in-queue
        gate.set()
        blocker.result(timeout=30)
        with pytest.raises(DeadlineExceeded) as exp:
            doomed.result(timeout=30)
    finally:
        fe.close()
    r = rec.get(rej.value.trace_id)
    assert r is not None and r["outcome"] == "rejected_queue_full"
    assert r["retained"] == "outcome"
    assert r["retry_after_ms"] > 0 and r["queue_depth"] == 2
    assert [s["stage"] for s in r["stages"]] == ["quota"]
    e = rec.get(exp.value.trace_id)
    assert e is not None and e["outcome"] == "expired"
    assert "deadline" in e["error"]
    assert sum(s["ms"] for s in e["stages"] if s["stage"] == "queue") >= 10.0
    assert [r2["outcome"] for r2 in rec.recent(outcome="rejected")] \
        == ["rejected_queue_full"]


def test_loadgen_outcome_accounting_matches_counters():
    """Client-observed outcomes and the front door's counters agree:
    submitted == ok + rejected + expired."""
    t = [0.0]
    gate = threading.Event()
    stub = _StubServer(gate=gate)
    reg = MetricsRegistry()
    fe = ServingFrontend(stub, max_batch=4, batch_window_ms=0.0,
                         queue_depth=8,
                         quotas={"lim": TenantQuota(rate_qps=0.001, burst=2)},
                         registry=reg, clock=lambda: t[0])
    qi, qv = _q()
    client = {"ok": 0, "rejected": 0, "expired": 0}
    futs, submitted = [], 0

    def try_submit(**kw):
        nonlocal submitted
        submitted += 1
        try:
            futs.append(fe.submit(qi, qv, **kw))
        except Rejected:
            client["rejected"] += 1

    try:
        try_submit()                   # blocker: dispatched, then stalls
        assert stub.entered.wait(10)
        for _ in range(3):
            try_submit(deadline_ms=20.0)        # will expire in-queue
        for _ in range(3):
            try_submit(tenant="lim")            # 2 admitted, 1 throttled
        for _ in range(3):
            try_submit()                        # fills the queue to 8
        try_submit()                            # 9th -> queue_full
        t[0] += 0.1
        gate.set()
        for f in futs:
            try:
                f.result(timeout=30)
                client["ok"] += 1
            except DeadlineExceeded:
                client["expired"] += 1
    finally:
        fe.close()
    assert submitted == 11
    assert client == {"ok": 6, "rejected": 2, "expired": 3}
    by_outcome = {}
    for s in _series(reg, "repro_frontend_requests_total"):
        out = s["labels"]["outcome"]
        by_outcome[out] = by_outcome.get(out, 0) + s["value"]
    assert sum(by_outcome.values()) == submitted
    assert by_outcome["ok"] == client["ok"]
    assert by_outcome["expired"] == client["expired"]
    assert by_outcome["rejected_throttled"] \
        + by_outcome["rejected_queue_full"] == client["rejected"]


def test_loadgen_run_point_accounts_every_arrival():
    """``run_point`` with a fake clock and sleep: every arrival is issued
    once and counted under its outcome; goodput counts OK alone."""
    t = [0.0]
    outcomes = ["ok", "rejected", "expired", "error", "ok"]
    seen = []
    lock = threading.Lock()

    def client(q_idx, q_val):
        with lock:
            i = len(seen)
            seen.append(int(q_idx[0]))
        if outcomes[i % 5] == "error":
            raise RuntimeError("client failure")
        return outcomes[i % 5]

    def sleep(dt):
        with lock:
            t[0] += dt

    queries = [(np.array([i], np.int32), np.ones(1, np.float32))
               for i in range(7)]
    point = loadgen.run_point(client, queries, 100.0, clients=3,
                              duration_s=0.5, clock=lambda: t[0],
                              sleep=sleep)
    assert point.issued == 50 == len(seen)
    assert sorted(seen) == sorted(s % 7 for s in range(50))
    assert (point.ok, point.rejected, point.expired, point.errors) \
        == (20, 10, 10, 10)
    assert point.goodput_qps == pytest.approx(point.ok / point.duration_s)
    row = point.to_row()
    assert set(row) == {"offered_qps", "achieved_qps", "goodput_qps",
                        "p50_ms", "p99_ms", "p999_ms", "ok", "rejected",
                        "expired", "errors"}


def test_loadgen_frontend_client_maps_outcomes():
    stub = _StubServer(gate=threading.Event())
    fe = ServingFrontend(stub, max_batch=1, batch_window_ms=0.0,
                         queue_depth=1)
    try:
        call = loadgen.frontend_client(fe)
        qi, qv = _q()
        fe.submit(qi, qv)
        assert stub.entered.wait(10)
        fe.submit(qi, qv)              # the queue is full
        assert call(qi, qv) == "rejected"
    finally:
        stub.gate.set()
        fe.close()
    fe = ServingFrontend(_StubServer(), max_batch=4, batch_window_ms=0.0,
                         queue_depth=8)
    try:
        assert loadgen.frontend_client(fe)(*_q()) == "ok"
    finally:
        fe.close()


def test_front_door_serves_readyz_and_debug_surfaces():
    stub = _StubServer()
    rec = FlightRecorder(capacity=64, sample_rate=1.0, spill=False,
                         registry=MetricsRegistry())
    fe = ServingFrontend(stub, max_batch=4, batch_window_ms=0.0,
                         queue_depth=16, recorder=rec)
    closed = False
    try:
        with FrontendServer(fe, port=0, recorder=rec) as door:
            res = fe.query(*_q())
            ready = json.loads(urllib.request.urlopen(
                door.url + "/readyz", timeout=30).read())
            assert ready["ready"] is True
            assert set(ready["checks"]) == {"dispatcher", "admission_queue"}
            doc = json.loads(urllib.request.urlopen(
                door.url + "/debug/requests?outcome=ok", timeout=30).read())
            assert any(r["trace_id"] == res.trace_id
                       for r in doc["requests"])
            trace = json.loads(urllib.request.urlopen(
                door.url + f"/debug/trace/{res.trace_id}",
                timeout=30).read())
            assert trace["outcome"] == "ok"
            batches = json.loads(urllib.request.urlopen(
                door.url + "/debug/batches", timeout=30).read())
            assert batches["count"] >= 1
            fe.close()
            closed = True
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(door.url + "/readyz", timeout=30)
            assert exc.value.code == 503
            assert json.loads(exc.value.read())["checks"]["dispatcher"][
                "ok"] is False
    finally:
        if not closed:
            fe.close()


def test_query_result_typed_and_frozen(served):
    server, qi, qv = served
    res = server.query(qi[0], qv[0])
    assert isinstance(res, QueryResult)
    assert res.k == 10 and res.backend == "fused"
    assert res.trace_id.startswith("q-")
    with pytest.raises(AttributeError):
        res.k = 99
    ids, scores = res
    assert ids is res.ids and scores is res.scores and len(res) == 2
    assert res.batch_size is None
    batched = server.query_many(qi[:4], qv[:4])
    assert batched.batch_size == 4
    row = batched.row(2, k=5, trace_id="q-test")
    assert row.ids.shape == (5,) and row.k == 5
    np.testing.assert_array_equal(row.ids, batched.ids[2, :5])
    with pytest.raises(ValueError):
        res.row(0)


# ---------------------------------------------------------------------------
# resilience: poisoned batch, supervisor, breaker, watchdog, ladder
# ---------------------------------------------------------------------------

def test_poisoned_batch_fails_only_its_own_future():
    gate = threading.Event()
    stub = _StubServer(gate=gate)
    reg = MetricsRegistry()
    fe = ServingFrontend(stub, max_batch=8, batch_window_ms=5.0,
                         queue_depth=32, registry=reg)
    try:
        healthy = [fe.submit(*_q(seed=s)) for s in range(3)]
        bad = fe.submit(*_q(seed=9, poison=True))
        gate.set()
        for f in healthy:
            assert f.result(timeout=30).ids.shape == (4,)
        with pytest.raises(ValueError, match="malformed"):
            bad.result(timeout=30)
        assert fe.query(*_q(seed=5)).ids.shape == (4,)
        assert fe.dispatcher_restarts == 0
        assert fe._dispatcher.is_alive()
        assert fe.breaker.state == "closed"
    finally:
        fe.close()
    by_outcome = {}
    for s in _series(reg, "repro_frontend_requests_total"):
        by_outcome[s["labels"]["outcome"]] = \
            by_outcome.get(s["labels"]["outcome"], 0) + s["value"]
    assert by_outcome["ok"] == 4 and by_outcome["error"] == 1


def test_single_query_batch_fails_directly_without_retry():
    stub = _StubServer()
    fe = ServingFrontend(stub, max_batch=4, batch_window_ms=0.0,
                         queue_depth=8, registry=MetricsRegistry())
    try:
        with pytest.raises(ValueError):
            fe.query(*_q(poison=True))
        assert len(stub.calls) == 1
        assert fe.query(*_q()).ids.shape == (4,)
    finally:
        fe.close()


def test_dispatcher_exhausts_restarts_then_fast_fails():
    reg = MetricsRegistry()
    fe = ServingFrontend(_BuggyServer(), max_batch=1, batch_window_ms=0.0,
                         queue_depth=8, registry=reg,
                         max_dispatcher_restarts=1)
    try:
        f0 = fe.submit(*_q(seed=0))           # crash 1: restart
        with pytest.raises(_LoopBug):
            f0.result(timeout=30)
        fe.submit(*_q(seed=1))                # crash 2: budget exhausted
        assert _wait_until(lambda: fe._dispatcher_dead)
        assert fe.dispatcher_restarts == 2
        with pytest.raises(Rejected) as exc:
            fe.submit(*_q(seed=2))
        assert exc.value.reason == "unavailable"
        assert exc.value.retry_after_ms > 0
        assert _series(reg, "repro_frontend_dispatcher_restarts_total")[0][
            "value"] == 2
    finally:
        fe.close()


def test_breaker_opens_on_persistent_device_failure():
    class _Broken(_StubServer):
        def query_many(self, qi, qv, ctx=None, degrade=0):
            raise RuntimeError("device on fire")

    reg = MetricsRegistry()
    br = CircuitBreaker(failure_threshold=1, reset_timeout_s=60.0,
                        name="frontend", registry=reg)
    fe = ServingFrontend(_Broken(), max_batch=1, batch_window_ms=0.0,
                         queue_depth=8, registry=reg, breaker=br)
    try:
        with pytest.raises(RuntimeError, match="on fire"):
            fe.query(*_q())
        assert br.state == "open"
        with pytest.raises(Rejected) as exc:
            fe.submit(*_q())
        assert exc.value.reason == "unavailable"
        assert 0 < exc.value.retry_after_ms <= 60_000
        assert {s["labels"]["reason"]: s["value"] for s in
                _series(reg, "repro_frontend_rejected_total")} \
            == {"unavailable": 1}
        assert _series(reg, "repro_fault_breaker_open_total")[0][
            "value"] == 1
    finally:
        fe.close()


def test_halfopen_probe_survives_admission_and_expiry():
    """The half-open probe token is consumed at dispatch time: a request
    that expires in-queue must not strand it (fake clock for the reset)."""

    class _FailOnce(_StubServer):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.fail_next = True

        def query_many(self, qi, qv, ctx=None, degrade=0):
            if self.fail_next:
                self.fail_next = False
                raise RuntimeError("transient device fault")
            return super().query_many(qi, qv, ctx=ctx, degrade=degrade)

    t = [0.0]
    reg = MetricsRegistry()
    br = CircuitBreaker(failure_threshold=1, reset_timeout_s=0.05,
                        name="frontend", registry=reg, clock=lambda: t[0])
    fe = ServingFrontend(_FailOnce(), max_batch=1, batch_window_ms=0.0,
                         queue_depth=8, registry=reg, breaker=br,
                         clock=lambda: t[0])
    try:
        with pytest.raises(RuntimeError, match="transient"):
            fe.query(*_q())
        assert br.state == "open"
        t[0] += 0.08                       # reset elapsed: half-open
        fut = fe.submit(*_q(), deadline_ms=-1.0)
        with pytest.raises(DeadlineExceeded):
            fut.result(timeout=30)
        assert fe.query(*_q()).ids.shape == (4,)
        assert br.state == "closed"
    finally:
        fe.close()


def test_queued_requests_fast_fail_when_breaker_opens():
    class _GatedBroken(_StubServer):
        def query_many(self, qi, qv, ctx=None, degrade=0):
            self.gate.wait()
            raise RuntimeError("device on fire")

    gate = threading.Event()
    reg = MetricsRegistry()
    br = CircuitBreaker(failure_threshold=1, reset_timeout_s=60.0,
                        name="frontend", registry=reg)
    fe = ServingFrontend(_GatedBroken(gate=gate), max_batch=1,
                         batch_window_ms=0.0, queue_depth=8,
                         registry=reg, breaker=br)
    try:
        futs = [fe.submit(*_q(seed=s)) for s in range(3)]
        gate.set()
        with pytest.raises(RuntimeError, match="on fire"):
            futs[0].result(timeout=30)
        for f in futs[1:]:
            with pytest.raises(Rejected) as exc:
                f.result(timeout=30)
            assert exc.value.reason == "unavailable"
            assert exc.value.retry_after_ms > 0
    finally:
        fe.close()


def test_loop_crash_fails_inflight_batch_futures():
    class _BadRow:
        def row(self, i, k=None, trace_id=None):
            raise RuntimeError("post-dispatch result decode bug")

    class _BadRowOnce(_StubServer):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.poisoned = True

        def query_many(self, qi, qv, ctx=None, degrade=0):
            if self.poisoned:
                self.poisoned = False
                return _BadRow()
            return super().query_many(qi, qv, ctx=ctx, degrade=degrade)

    fe = ServingFrontend(_BadRowOnce(), max_batch=4, batch_window_ms=0.0,
                         queue_depth=8, registry=MetricsRegistry())
    try:
        with pytest.raises(RuntimeError, match="decode bug"):
            fe.submit(*_q()).result(timeout=30)
        assert fe.query(*_q()).ids.shape == (4,)
        assert fe.dispatcher_restarts == 1
        assert fe._dispatcher.is_alive()
    finally:
        fe.close()


def test_housekeeping_survives_slo_exception():
    class _BurningSLO:
        def fast_burn(self):
            raise KeyError("windows")

    reg = MetricsRegistry()
    fe = ServingFrontend(_StubServer(), max_batch=4, batch_window_ms=0.0,
                         queue_depth=8, registry=reg, slo=_BurningSLO(),
                         degrade=DegradeConfig(dwell_ticks=1),
                         degrade_tick_s=0.01)
    try:
        def errors():
            s = _series(reg, "repro_frontend_housekeeping_errors_total")
            return s[0]["value"] if s else 0

        assert _wait_until(lambda: errors() >= 2)
        assert fe._housekeeper.is_alive()
        assert fe.query(*_q()).ids.shape == (4,)
    finally:
        fe.close()


def test_watchdog_504s_inflight_futures_on_stall():
    gate = threading.Event()
    stub = _StubServer(gate=gate)
    reg = MetricsRegistry()
    fe = ServingFrontend(stub, max_batch=4, batch_window_ms=0.0,
                         queue_depth=8, registry=reg,
                         watchdog_timeout_s=0.15)
    try:
        fut = fe.submit(*_q())
        with pytest.raises(DeviceStuck) as exc:
            fut.result(timeout=30)
        assert isinstance(exc.value, DeadlineExceeded)
        assert exc.value.queued_ms >= 150.0
        assert exc.value.deadline_ms == pytest.approx(150.0)
        assert _series(reg, "repro_frontend_watchdog_trips_total")[0][
            "value"] == 1
        outcomes = {s["labels"]["outcome"]: s["value"] for s in
                    _series(reg, "repro_frontend_requests_total")}
        assert outcomes.get("stuck") == 1
        assert fe.breaker.snapshot()[1] >= 1
    finally:
        gate.set()
        fe.close()
    assert fe.dispatcher_restarts == 0


def _force_level(fe, level):
    for _ in range(level):
        fe.degrade.tick(burn=100.0, queue_frac=1.0)
    assert fe.degrade.level == level


def test_ladder_threads_degrade_level_to_server():
    stub = _StubServer()
    reg = MetricsRegistry()
    fe = ServingFrontend(stub, max_batch=4, batch_window_ms=0.0,
                         queue_depth=8, registry=reg,
                         degrade=DegradeConfig(dwell_ticks=1),
                         degrade_tick_s=3600.0)
    try:
        assert fe.query(*_q()).degraded is False
        _force_level(fe, 2)
        assert fe.query(*_q()).degraded is True
        assert stub.calls[-1][1] == 2
        assert {s["labels"]["level"]: s["value"] for s in
                _series(reg, "repro_frontend_degraded_queries_total")} \
            == {"2": 1}
    finally:
        fe.close()


def test_l3_sheds_only_lowest_priority_class_and_recovers():
    fe = ServingFrontend(
        _StubServer(), max_batch=4, batch_window_ms=0.0, queue_depth=8,
        quotas={"gold": TenantQuota(rate_qps=1e6, priority=1),
                "bronze": TenantQuota(rate_qps=1e6, priority=0)},
        registry=MetricsRegistry(),
        degrade=DegradeConfig(dwell_ticks=1), degrade_tick_s=3600.0)
    try:
        _force_level(fe, 3)
        with pytest.raises(Rejected) as exc:
            fe.submit(*_q(), tenant="bronze")
        assert exc.value.reason == "shed"
        assert exc.value.retry_after_ms == 1000.0
        assert fe.query(*_q(), tenant="gold").ids.shape == (4,)
        for _ in range(3):
            fe.degrade.tick(burn=0.0, queue_frac=0.0)
        assert fe.degrade.level == 0
        assert fe.query(*_q(), tenant="bronze").ids.shape == (4,)
    finally:
        fe.close()


def test_uniform_priorities_never_shed():
    fe = ServingFrontend(_StubServer(), max_batch=4, batch_window_ms=0.0,
                         queue_depth=8, registry=MetricsRegistry(),
                         degrade=DegradeConfig(dwell_ticks=1),
                         degrade_tick_s=3600.0)
    try:
        _force_level(fe, 3)
        assert fe.query(*_q()).degraded is True
    finally:
        fe.close()


def test_stub_without_degrade_kwarg_still_serves():
    class _Legacy:
        k = 4

        def query_many(self, qi, qv, ctx=None):
            B = qi.shape[0]
            return QueryResult(ids=np.tile(np.arange(4, dtype=np.int64),
                                           (B, 1)),
                               scores=np.zeros((B, 4), np.float32), k=4,
                               backend="stub", trace_id="q-stub")

    fe = ServingFrontend(_Legacy(), max_batch=4, batch_window_ms=0.0,
                         queue_depth=8, registry=MetricsRegistry(),
                         degrade=DegradeConfig(dwell_ticks=1),
                         degrade_tick_s=3600.0)
    try:
        _force_level(fe, 2)
        assert fe.query(*_q()).ids.shape == (4,)
    finally:
        fe.close()


def test_http_response_carries_degraded_flag():
    fe = ServingFrontend(_StubServer(), max_batch=4, batch_window_ms=0.0,
                         queue_depth=8, registry=MetricsRegistry(),
                         degrade=DegradeConfig(dwell_ticks=1),
                         degrade_tick_s=3600.0)
    try:
        with FrontendServer(fe, port=0) as door:
            qi, qv = _q()
            doc = {"indices": qi.tolist(), "values": qv.tolist()}
            assert _post(door.url, doc)["degraded"] is False
            _force_level(fe, 1)
            assert _post(door.url, doc)["degraded"] is True
    finally:
        fe.close()


def test_engine_degrade_levels(served):
    server, qi, qv = served
    full = server.query_many(qi, qv)
    l1 = server.query_many(qi, qv, degrade=1)
    l2 = server.query_many(qi, qv, degrade=2)
    assert full.degraded is False and l1.degraded and l2.degraded
    assert l1.ids.shape == full.ids.shape == l2.ids.shape
    assert np.all(l1.scores[:, 0] <= full.scores[:, 0] + 1e-5)
    assert np.all(l2.scores[:, 0] >= full.scores[:, 0] - 1e-4)


def test_engine_degraded_front_door_identity(served):
    """A degraded front-door answer equals the same level asked directly."""
    server, qi, qv = served
    fe = ServingFrontend(server, max_batch=4, batch_window_ms=0.0,
                         queue_depth=8, registry=MetricsRegistry(),
                         degrade=DegradeConfig(dwell_ticks=1),
                         degrade_tick_s=3600.0)
    try:
        _force_level(fe, 2)
        got = fe.query(qi[1], qv[1])
    finally:
        fe.close()
    padded_i = np.full((4, 32), -1, np.int32)
    padded_v = np.zeros((4, 32), np.float32)
    L = qi.shape[1]
    padded_i[0, :L], padded_v[0, :L] = qi[1], qv[1]
    expect = server.query_many(padded_i, padded_v, degrade=2)
    np.testing.assert_array_equal(got.ids, expect.ids[0])
    np.testing.assert_array_equal(got.scores, expect.scores[0])
    assert got.degraded is True


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def test_front_doors_of_both_packages_answer_alike(corpus):
    """The same requests through repro's front door over repro's server and
    through the port's over the port's: equal ids, scores within kernel
    B's tolerance."""
    idx, val, qi, qv = corpus
    jindex = jeng.SinnamonIndex(_spec(jeng))
    jindex.insert_many(list(range(N_DOCS)), idx, val)
    jserver = JServer(jindex, k=10, kprime=40)
    tserver = _port_server(corpus)
    out = {}
    for pkg, server in (("jax", jserver), ("port", tserver)):
        fe = PACKAGES[pkg][0].ServingFrontend(server, max_batch=8,
                                              batch_window_ms=20.0,
                                              queue_depth=64,
                                              default_deadline_ms=600_000)
        try:
            fe.query(qi[0], qv[0])                 # JAX compiles here
            futs = [fe.submit(qi[b], qv[b]) for b in range(qi.shape[0])]
            out[pkg] = [f.result(timeout=120) for f in futs]
        finally:
            fe.close()
    for b, (j, t) in enumerate(zip(out["jax"], out["port"])):
        np.testing.assert_array_equal(np.asarray(j.ids), t.ids,
                                      err_msg=f"query {b}")
        np.testing.assert_allclose(t.scores, np.asarray(j.scores),
                                   rtol=1e-5, atol=1e-5)


#: (front-door module, breaker class, result class) of each package
PACKAGES = {"jax": (jfe, JBreaker, JResult),
            "port": (sys.modules[ServingFrontend.__module__], CircuitBreaker,
                     QueryResult)}


def _admission_script(pkg, stub, reg, t):
    """One submit sequence through package ``pkg``'s front door over a
    gated stub, on fake clock ``t``: returns [(outcome, reason,
    retry_after_ms or deadline_ms)] for every request, in submit order."""
    mod, breaker_cls, _ = PACKAGES[pkg]
    clock = lambda: t[0]                                    # noqa: E731
    br = breaker_cls(failure_threshold=1, reset_timeout_s=7.5,
                     name="frontend", clock=clock, registry=reg)
    fe = mod.ServingFrontend(stub, max_batch=2, batch_window_ms=0.0,
                             queue_depth=3, default_deadline_ms=1000.0,
                             quotas={"lim": mod.TenantQuota(rate_qps=4.0,
                                                            burst=2)},
                             registry=reg, clock=clock, breaker=br)
    qi, qv = _q()
    log, futs = [], []

    def submit(**kw):
        try:
            futs.append((len(log), fe.submit(qi, qv, **kw)))
            log.append(None)
        except mod.Rejected as e:
            log.append(("rejected", e.reason, round(e.retry_after_ms, 6)))

    try:
        submit()                                   # dispatched, stalls
        assert stub.entered.wait(10)
        submit(tenant="lim")
        submit(tenant="lim")
        t[0] += 0.1
        submit(tenant="lim")                       # throttled
        submit(deadline_ms=5.0)                    # queued, will expire
        submit()                                   # queue_full
        t[0] += 0.3
        submit(tenant="lim")                       # refilled, queue_full
        stub.gate.set()
        for pos, f in futs:
            try:
                f.result(timeout=30)
                log[pos] = ("ok", None, None)
            except mod.DeadlineExceeded as e:
                log[pos] = ("expired", None, round(e.deadline_ms, 6))
        stub.fail = True                           # the device breaks
        try:
            fe.query(qi, qv)
        except RuntimeError:
            log.append(("error", None, None))
        t[0] += 2.5
        submit()                                   # breaker open
    finally:
        fe.close()
    return log


class _FailingStub(_StubServer):
    fail = False

    def query_many(self, qi, qv, ctx=None, degrade=0):
        if self.fail:
            raise RuntimeError("device broken")
        return super().query_many(qi, qv, ctx=ctx, degrade=degrade)


def test_admission_outcomes_match_reference_on_a_fake_clock():
    """One submit sequence, one fake clock: the same outcomes, reject
    reasons and ``retry_after_ms`` in both packages, and the same front-door
    metric families and label sets in both expositions."""
    runs = {}
    for pkg, reg in (("jax", JRegistry()), ("port", MetricsRegistry())):
        stub = _FailingStub(gate=threading.Event(), result=PACKAGES[pkg][2])
        runs[pkg] = (_admission_script(pkg, stub, reg, [50.0]), reg)
    jlog, jreg = runs["jax"]
    tlog, treg = runs["port"]
    assert tlog == jlog
    reasons = [e[1] for e in tlog if e and e[0] == "rejected"]
    assert reasons == ["throttled", "queue_full", "queue_full",
                       "unavailable"]
    assert ("expired", None, 5.0) in tlog

    def families(reg):
        return {(n, labels)
                for n, labels in parse_exposition(reg.exposition())
                if "frontend" in n or "breaker" in n}

    assert families(treg) == families(jreg)
    assert any(n.startswith("repro_frontend_requests_total")
               for n, _ in families(treg))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_has_every_reference_flag():
    ref = vars(jlauncher.parse_args([]))
    port = vars(launcher.parse_args([]))
    missing = sorted(set(ref) - set(port))
    assert not missing, missing
    for dest, value in ref.items():
        if dest not in ("score_backend",):
            assert port[dest] == value, dest
    assert set(port) - set(ref) == {"device", "seed"}


def test_launcher_checks_match_reference(capsys):
    for argv in (["--device-budget-mb", "8", "--wal", "w", "--shards", "2"],
                 ["--snapshot-dir", "s"], ["--auto-tune", "--wal", "w"]):
        for parse in (jlauncher.parse_args, launcher.parse_args):
            with pytest.raises(SystemExit):
                parse(argv)
    launcher.main(["--docs", "64", "--queries", "4", "--device", "cpu",
                   "--shards", "2"])
    assert "indexed 64 docs over 2 shard(s)" in capsys.readouterr().out


def test_launcher_front_door_answers_a_post():
    """``--serve-port 0 --hold-seconds N --device cpu``: the printed URL
    serves ``POST /v1/query``."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--docs", "300",
         "--queries", "4", "--device", "cpu", "--m", "32", "--serve-port",
         "0", "--hold-seconds", "20"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        url = None
        for line in proc.stdout:
            m = re.search(r"front door: POST (http://\S+)/v1/query", line)
            if m:
                url = m.group(1)
                break
        assert url, proc.stderr.read()
        qi, qv = _q(nnz=10)
        doc = _post(url, {"indices": qi.tolist(), "values": qv.tolist(),
                          "k": 5})
        assert len(doc["ids"]) == 5 and doc["backend"] == "fused"
        assert urllib.request.urlopen(url + "/readyz", timeout=30).status \
            == 200
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
