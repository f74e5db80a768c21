"""Observability and fault-injection parity: ``repro_torch.obs`` and
``repro_torch.fault`` against ``repro.obs`` and ``repro.fault``.

* The same sequence of index mutations and ``QueryServer`` calls gives the
  same metric names, help texts, label sets, counter and gauge values and
  histogram counts in both packages (timing histograms compared by count
  only; the exposition text of every non-timing family is equal).
* A failpoint schedule with the same seed fires at the same calls in both
  packages: raw, at the serving ``device.dispatch`` site, and at the WAL
  ``wal.write`` site, where the surviving durable states are bit-equal.
* The same event names and fields reach the event log.
* ``latency_percentiles`` reads the same histogram as the reference's, and
  the SLO monitor and the degradation ladder, fed the same traffic, give
  the same window stats, gauges, WARN events and levels.
* The port's own parts: a span on a CUDA device closes with
  ``torch.cuda.synchronize``, ``/debug/profile`` writes a Chrome trace with
  ``torch.profiler`` and answers 409 while one runs.
"""

import contextlib
import json
import os
import threading

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, as the suite runs it)
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.data import synth  # noqa: E402
from repro.fault import degrade as jdegrade  # noqa: E402
from repro.fault import failpoints as jfp  # noqa: E402
from repro.obs import events as jevents  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.obs import slo as jslo  # noqa: E402
from repro.persist.durable import DurableSinnamonIndex as JDurable  # noqa: E402
from repro.serving.serve import QueryServer as JServer  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.fault import degrade as tdegrade  # noqa: E402
from repro_torch.fault import failpoints as tfp  # noqa: E402
from repro_torch.obs import events as tevents  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.obs import server as tserver  # noqa: E402
from repro_torch.obs import slo as tslo  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402
from repro_torch.persist.durable import DurableSinnamonIndex  # noqa: E402
from repro_torch.serving.serve import QueryServer as TServer  # noqa: E402

DS = synth.SparseDatasetSpec("t", n=300, psi_doc=16, psi_query=8,
                             value_dist="gaussian")


def _spec(pkg, capacity=64):
    return pkg.EngineSpec(n=DS.n, m=12, capacity=capacity, max_nnz=32, h=2,
                          seed=3, value_dtype="float32")


@contextlib.contextmanager
def _registries():
    """Fresh process-global registries in both packages."""
    regs = jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry()
    prev = jmetrics.set_registry(regs[0]), tmetrics.set_registry(regs[1])
    try:
        yield regs
    finally:
        jmetrics.set_registry(prev[0])
        tmetrics.set_registry(prev[1])


def _workload(index, server, idx, val, qi, qv):
    """One sequence of mutations and queries (both packages' surface)."""
    index.insert_many(list(range(40)), idx[:40], val[:40])
    keep = idx[40] >= 0
    index.insert(40, idx[40][keep], val[40][keep])
    index.delete(3)
    index.delete(7)
    index.insert_many([5, 41, 5], idx[41:44], val[41:44])   # overwrite + dup
    index.grow(96)
    index.insert_many(list(range(42, 100)), idx[42:100], val[42:100])
    index.compact()
    for lo in range(0, 12, 4):
        server.query_many(qi[lo:lo + 4], qv[lo:lo + 4])
    server.query(qi[0], qv[0])
    server.query_many(qi[:4], qv[:4], degrade=1)
    server.query_many(qi[:4], qv[:4], degrade=2)


def _both():
    idx, val = synth.make_corpus(0, DS, 100, pad=32)
    qi, qv = synth.make_queries(1, DS, 12, pad=16)
    J = jeng.SinnamonIndex(_spec(jeng))
    T = teng.SinnamonIndex(_spec(teng), device="cpu")
    return (idx, val, qi, qv), J, T


def _families(snapshot):
    """{name: (type, help, {labels: comparable series})}; timing
    histograms (``*_ms``) keep only their counts."""
    out = {}
    for name, fam in snapshot.items():
        series = {}
        for s in fam["series"]:
            key = tuple(sorted(s["labels"].items()))
            if fam["type"] != "histogram":
                series[key] = s["value"]
            elif name.endswith("_ms"):
                series[key] = s["count"]
            else:
                series[key] = (s["count"], s["sum"], tuple(s["counts"]))
        out[name] = (fam["type"], fam["help"], series)
    return out


def test_metrics_match_reference():
    (idx, val, qi, qv), J, T = _both()
    with _registries() as (jreg, treg):
        js = JServer(J, k=10, kprime=40, score_backend="reference",
                     trace_every=2, index_name="shard0")
        ts = TServer(T, k=10, kprime=40, score_backend="reference",
                     trace_every=2, index_name="shard0")
        _workload(J, js, idx, val, qi, qv)
        _workload(T, ts, idx, val, qi, qv)
        jsnap, tsnap = _families(jreg.snapshot()), _families(treg.snapshot())
        assert sorted(tsnap) == sorted(jsnap)
        for name in jsnap:
            assert tsnap[name] == jsnap[name], name
        assert tsnap["repro_engine_bytes"][2][(
            ("component", "sketch"), ("index", "shard0"))] == 2 * 2 * 12 * 192
        assert tsnap["repro_query_stage_ms"][2]

        def text(reg):
            keep, out = True, []
            for line in reg.exposition().splitlines():
                if line.startswith("# HELP"):
                    keep = not line.split()[2].endswith("_ms")
                if keep:
                    out.append(line)
            return out
        assert text(treg) == text(jreg)
    assert ts.latency_percentiles()["p50"] > 0
    assert [s.name for s in ts.last_trace.spans] == [
        s.name for s in js.last_trace.spans]


def test_failpoint_schedule_matches_reference():
    spec = "device.dispatch=error:0.3,wal.fsync=enospc:0.5,vecstore.read=error"
    regs = (jfp.FailpointRegistry(seed=11).configure(spec),
            tfp.FailpointRegistry(seed=11).configure(spec))
    fired = []
    for reg in regs:
        row = []
        for i in range(60):
            site = ("device.dispatch", "wal.fsync", "compact.swap")[i % 3]
            try:
                row.append(reg.fire(site) is not None)
            except OSError as e:
                row.append(e.errno)
        fired.append(row)
    assert fired[0] == fired[1] and any(fired[1])
    assert regs[0].sites() == regs[1].sites()
    assert [r.hits("wal.fsync") for r in regs] == [regs[0].hits("wal.fsync")] * 2


def test_serving_failpoint_fires_at_the_same_calls():
    (idx, val, qi, qv), J, T = _both()
    for index in (J, T):
        index.insert_many(list(range(60)), idx[:60], val[:60])
    out = []
    for fp, index, server_cls, err in ((jfp, J, JServer, jfp.InjectedError),
                                       (tfp, T, TServer, tfp.InjectedError)):
        server = server_cls(index, k=10, kprime=40,
                            score_backend="reference",
                            registry=(jmetrics if fp is jfp
                                      else tmetrics).NULL_REGISTRY)
        row = []
        with fp.injected("device.dispatch=error:0.4", seed=5):
            for b in range(16):
                try:
                    server.query_many(qi[b % 12:b % 12 + 1],
                                      qv[b % 12:b % 12 + 1])
                    row.append(0)
                except err:
                    row.append(1)
        out.append(row)
    assert out[0] == out[1] and 0 < sum(out[1]) < 16


def test_wal_failpoint_schedule_leaves_equal_states(tmp_path):
    """A seeded ``wal.write`` error schedule fails the same appends in both
    packages; the acknowledged writes leave bit-equal states, and each
    recovers to its live state."""
    idx, val = synth.make_corpus(2, DS, 96, pad=32)
    live = {}
    failed = {}
    for name, fp, cls, kw in (
            ("jax", jfp, JDurable, {}),
            ("port", tfp, DurableSinnamonIndex, dict(device="cpu"))):
        wd = str(tmp_path / name)
        spec = _spec(jeng if name == "jax" else teng, 96)
        index = cls.open(spec, wal_dir=wd, **kw)
        row = []
        with fp.injected("wal.write=error:0.35", seed=9):
            for lo in range(0, 96, 8):
                try:
                    index.insert_many(list(range(lo, lo + 8)),
                                      idx[lo:lo + 8], val[lo:lo + 8])
                    row.append(0)
                except OSError:
                    row.append(1)
            for e in (0, 9, 17):
                try:
                    index.delete(e)
                    row.append(0)
                except (OSError, KeyError):
                    row.append(1)
        live[name], failed[name] = index, row
        rec = cls.open(spec, wal_dir=wd, **kw)
        assert rec._id2slot == index._id2slot
    assert failed["jax"] == failed["port"] and 0 < sum(failed["port"])
    leaves = convert.state_to_numpy(live["port"].state, live["port"].spec)
    ref = jckpt._flatten(live["jax"].state)
    assert sorted(leaves) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(leaves[k], ref[k], err_msg=k)


def test_event_log_matches_reference(tmp_path):
    idx, val = synth.make_corpus(3, DS, 64, pad=32)
    qi, qv = synth.make_queries(4, DS, 4, pad=16)
    events = {}
    for name, ev, cls, server_cls, kw in (
            ("jax", jevents, JDurable, JServer, {}),
            ("port", tevents, DurableSinnamonIndex, TServer,
             dict(device="cpu"))):
        path = str(tmp_path / f"{name}.jsonl")
        prev = ev.set_event_log(ev.EventLog(path))
        try:
            spec = _spec(jeng if name == "jax" else teng)
            wd, sd = str(tmp_path / f"{name}-w"), str(tmp_path / f"{name}-s")
            index = cls.open(spec, wal_dir=wd, snapshot_dir=sd, **kw)
            index.insert_many(list(range(48)), idx[:48], val[:48])
            index.snapshot()
            server = server_cls(index, k=10, kprime=40,
                                score_backend="reference", trace_every=1)
            server.query_many(qi, qv)
            cls.open(spec, wal_dir=wd, snapshot_dir=sd, **kw)
        finally:
            ev.get_event_log().close()
            ev.set_event_log(prev)
        events[name] = [(e["event"], sorted(e)) for e in ev.read_events(path)]
    assert events["port"] == events["jax"]
    assert [e for e, _ in events["port"]] == ["recovery", "snapshot",
                                              "query", "recovery"]


def test_span_syncs_the_cuda_device(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: calls.append(device))
    dev = torch.device("cuda")
    t = ttrace.Trace(device=dev)
    with t.span("rerank"):
        pass
    assert calls == [dev, dev] and [s.name for s in t.spans] == ["rerank"]
    with ttrace.Trace(device=torch.device("cpu")).span("admission"):
        pass
    with ttrace.Trace().span("admission"):
        pass
    assert len(calls) == 2


def test_profile_endpoint_writes_a_chrome_trace(tmp_path):
    handler = tserver._profile_endpoint(str(tmp_path / "prof"))
    got = []
    t = threading.Thread(target=lambda: got.append(
        handler("", {"seconds": "0.4"})))
    t.start()
    for _ in range(200):                    # wait for the capture to start
        if os.path.isdir(tmp_path / "prof"):
            break
        threading.Event().wait(0.005)
    busy = handler("", {"seconds": "0.05"})
    t.join()
    assert busy[0] == 409
    status, body, _ = got[0]
    assert status == 200
    out = json.loads(body)["trace"]
    with open(out) as f:
        assert "traceEvents" in json.load(f)
    assert handler("", {"seconds": "x"})[0] == 400


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_write_path_metrics_count_batched_deletes(pkg):
    """The port's batched delete_many reports under the reference's
    ``delete_many`` label (the reference's sharded index has it)."""
    (idx, val, _, _), J, T = _both()
    index = J if pkg == "jax" else T
    with _registries() as regs:
        reg = regs[0] if pkg == "jax" else regs[1]
        index.insert_many(list(range(20)), idx[:20], val[:20])
        if pkg == "port":
            index.delete_many([1, 2, 2, 3])
        else:
            for e in (1, 2, 3):
                index.delete(e)
        snap = reg.snapshot()
    docs = {s["labels"]["op"]: s["value"]
            for s in snap["repro_engine_docs_total"]["series"]}
    ops = {s["labels"]["op"]: s["value"]
           for s in snap["repro_engine_ops_total"]["series"]}
    assert docs["delete"] == 3 and docs["insert"] == 20
    assert ops["delete_many" if pkg == "port" else "delete"] == (
        1 if pkg == "port" else 3)


def test_latency_percentiles_match_reference():
    """The same batches recorded (fixed wall times) give the reference's
    percentiles: both read the registry's latency histogram."""
    (idx, val, _, _), J, T = _both()
    J.insert_many(list(range(20)), idx[:20], val[:20])
    T.insert_many(list(range(20)), idx[:20], val[:20])
    with _registries():
        js = JServer(J, k=5, kprime=20, score_backend="reference")
        ts = TServer(T, k=5, kprime=20, score_backend="reference")
        assert ts.latency_percentiles() == js.latency_percentiles() == {}
        rng = np.random.default_rng(5)
        for bn, ms in zip(rng.integers(1, 64, 40), rng.gamma(2.0, 3.0, 40)):
            js._record(int(bn), float(ms), "reference")
            ts._record(int(bn), float(ms), "reference")
        pct = ts.latency_percentiles()
        assert pct == js.latency_percentiles()
        assert pct["p50"] <= pct["p90"] <= pct["p99"]
        ts.reset_stats()
        assert ts.latency_percentiles() == {}


def _slo_traffic(reg, step):
    """Step ``step`` of a fixed traffic pattern into ``reg``: request
    outcomes and front-door latencies that start healthy, burn, recover."""
    bad = 0 if step < 4 or step >= 9 else 6 + step
    for outcome, n in (("ok", 40 - bad), ("error", bad // 2),
                       ("rejected", bad - bad // 2)):
        reg.counter("repro_frontend_requests_total", "outcomes",
                    labels={"tenant": "t", "outcome": outcome}).inc(n)
    h = reg.histogram("repro_frontend_latency_ms", "lat",
                      labels={"tenant": "t"})
    for i in range(40):
        h.observe(5.0 + 2.0 * i + (300.0 if i < bad else 0.0))


@pytest.mark.parametrize("fast,slow", [(30.0, 120.0), (60.0, 600.0)])
def test_slo_and_degrade_ladder_match_reference(tmp_path, fast, slow):
    """The same traffic through ``SLOMonitor`` and a ``DegradationController``
    ticked on its fast burn and a queue fill gives equal tick output,
    registry snapshots, WARN events and ladder levels in both packages."""
    queue = [0.1, 0.2, 0.5, 0.8, 0.3, 0.1, 0.0, 0.0, 0.9, 0.2, 0.1] \
        + [0.0] * 19
    runs = {}
    for name, slo, degrade, metrics, ev in (
            ("jax", jslo, jdegrade, jmetrics, jevents),
            ("port", tslo, tdegrade, tmetrics, tevents)):
        reg = metrics.MetricsRegistry()
        log = ev.EventLog(str(tmp_path / f"{name}.jsonl"))
        t = [0.0]
        mon = slo.SLOMonitor(slo.SLOSpec(latency_ms=100.0,
                                         latency_target=0.95,
                                         availability_target=0.99),
                             reg, fast_window_s=fast, slow_window_s=slow,
                             burn_warn=3.0, event_log=log,
                             clock=lambda: t[0])
        ladder = degrade.DegradationController(
            degrade.DegradeConfig(dwell_ticks=2), registry=reg)
        ticks, levels = [mon.tick()], []
        for step, q in enumerate(queue):
            _slo_traffic(reg, step)
            t[0] = 10.0 * (step + 1)
            ticks.append(mon.tick())
            levels.append(ladder.tick(burn=mon.fast_burn(), queue_frac=q))
        report = mon.report()
        log.close()
        warns = [{k: v for k, v in e.items() if k not in ("ts", "seq")}
                 for e in ev.read_events(log.path) if e["event"] == "slo_burn"]
        runs[name] = (ticks, levels, report, reg.snapshot(), warns)
    for got, want in zip(runs["port"], runs["jax"]):
        assert got == want
    ticks, levels, _, _, warns = runs["port"]
    assert max(levels) >= 2 and levels[-1] == 0 and warns
