"""The readers of the port's own spans (``benchlib/program.py`` and the
eight metrics that use it): a traced CPU run gives the four host ones and
none of the four device ones; a window step with a missing or doubled
query trace, a device duration not read, a full ring or a port without
the ring gives None; on a card, a process without the port's trace
module is an error."""

from __future__ import annotations

import math
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from benchtest import BENCH, ROOT, run_cell  # noqa: E402

for _p in (str(BENCH), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)
from benchlib import program  # noqa: E402
from benchlib import spec as bspec  # noqa: E402
from benchlib.loop import Step  # noqa: E402
from repro_torch.obs import trace as otrace  # noqa: E402

CELL = "msmarco-splade.query_b256"
QUERY_METRICS = ("device.sketch_scan_ms", "device.topk_merge_ms",
                 "device.rerank_ms", "serve.host_issue_ms")
SETUP_METRICS = ("setup.insert_id_map_s", "device.insert_writes_s",
                 "setup.kernel_load_s", "setup.insert_prep_s")
DEVICE_METRICS = tuple(n for n in QUERY_METRICS + SETUP_METRICS
                       if n.startswith("device."))
QUERY = ("admission", "sketch_scan", "topk_merge", "rerank", "to_host")
INSERT = ("prep", "id_map", "encode", "bitmap", "sketch", "csr", "id_map")


class _Run:
    def __init__(self, window, device_kind="NVIDIA H100 80GB HBM3"):
        self.window = window
        self.device_kind = device_kind


@pytest.fixture(autouse=True)
def fresh_ring():
    otrace.clear()
    yield
    otrace.clear()


def _steps(n=4, staged=(1,)):
    out = []
    for i in range(n):
        st = Step("window")
        st.t0, st.t1 = 100.0 + i, 100.0 + i + 0.9
        st.staged = i in staged
        out.append(st)
    return out


def _keep(op, t0, names, ms=1.0, device_ms=2.0):
    tr = otrace.Trace(op, device_timed=True)
    tr.t0 = t0
    for j, name in enumerate(names):
        tr.spans.append(otrace.Span(name, ms, start_ms=float(j),
                                    device_ms=device_ms))
    tr.finish()
    return tr


def _read(name, run):
    return bspec.reader(name)(run)


def test_traced_cpu_run_reports_every_new_metric():
    rc, line, err = run_cell(CELL, seed=2**31 + 21, trace=1)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True
    m = line["metrics"]
    for name in QUERY_METRICS + SETUP_METRICS:
        if name in DEVICE_METRICS:      # the CPU records no device time
            assert name not in m, name
            continue
        assert name in m, name
        assert math.isfinite(m[name]["value"]) and m[name]["value"] >= 0.0
    assert m["setup.kernel_load_s"]["value"] == 0.0     # the CPU loads none
    assert m["setup.insert_id_map_s"]["value"] > 0.0
    assert m["setup.insert_prep_s"]["value"] > 0.0
    assert m["serve.host_issue_ms"]["value"] > 0.0
    assert {m[n]["unit"] for n in QUERY_METRICS if n in m} == {"ms"}
    assert {m[n]["unit"] for n in SETUP_METRICS if n in m} == {"s"}


def test_query_readers_match_each_unstaged_step_once():
    steps = _steps()
    run = _Run(steps)
    _keep("query", 99.5, QUERY)                         # warm-up: not read
    for i, st in enumerate(steps):
        if not st.staged:
            _keep("query", st.t0 + 0.1, QUERY, ms=0.5 + i, device_ms=3.0 + i)
    assert len(program.window_queries(run)) == 3
    # steps 0, 2, 3: device 3, 5, 6 ms; host 0.5, 2.5, 3.5 ms a span
    assert _read("device.sketch_scan_ms", run) == pytest.approx(14 / 3)
    assert _read("device.topk_merge_ms", run) == pytest.approx(14 / 3)
    assert _read("device.rerank_ms", run) == pytest.approx(14 / 3)
    assert _read("serve.host_issue_ms", run) == pytest.approx(4 * 6.5 / 3)


@pytest.mark.parametrize("fault", ("missing", "doubled", "unread"))
def test_query_readers_give_none_on_a_bad_match(fault):
    steps = _steps()
    run = _Run(steps)
    for i, st in enumerate(steps):
        if st.staged or (fault == "missing" and i == 2):
            continue
        _keep("query", st.t0 + 0.1, QUERY,
              device_ms=None if fault == "unread" and i == 3 else 2.0)
        if fault == "doubled" and i == 0:
            _keep("query", st.t0 + 0.2, QUERY)
    for name in QUERY_METRICS[:3]:
        assert _read(name, run) is None, name
    host = _read("serve.host_issue_ms", run)
    assert (host is None) == (fault != "unread")


def test_cpu_span_host_time_is_not_device_time():
    steps = _steps(2, staged=())
    for st in steps:
        _keep("query", st.t0 + 0.1, QUERY, ms=0.25, device_ms=None)
    for kind in ("cpu", "NVIDIA H100 80GB HBM3"):
        assert _read("device.sketch_scan_ms", _Run(steps, kind)) is None
        assert _read("serve.host_issue_ms",
                     _Run(steps, kind)) == pytest.approx(1.0)


def test_setup_readers_sum_the_traces_before_the_window():
    steps = _steps()
    run = _Run(steps)
    for t0 in (10.0, 20.0):
        _keep("insert_many", t0, INSERT, ms=1.5, device_ms=4.0)
    _keep("insert_many", steps[0].t0 + 0.5, INSERT)      # in the window
    _keep("kernel_load", 5.0, ("sinnamon_score",), ms=300.0, device_ms=None)
    _keep("kernel_load", 6.0, ("csr_rerank",), ms=200.0, device_ms=None)
    # two id_map spans a trace of 1.5 ms; one prep; four write spans of 4 ms
    assert _read("setup.insert_id_map_s", run) == pytest.approx(6e-3)
    assert _read("setup.insert_prep_s", run) == pytest.approx(3e-3)
    assert _read("device.insert_writes_s", run) == pytest.approx(32e-3)
    assert _read("setup.kernel_load_s", run) == pytest.approx(0.5)


def test_setup_readers_give_none_when_a_trace_may_be_missing(monkeypatch):
    run = _Run(_steps())
    assert _read("setup.insert_id_map_s", run) is None        # no insert
    assert _read("setup.kernel_load_s", run) == 0.0           # none loaded
    _keep("insert_many", 10.0, INSERT, device_ms=None)
    assert _read("device.insert_writes_s", run) is None       # not read
    assert _read("device.insert_writes_s", _Run(run.window, "cpu")) is None
    assert _read("setup.insert_prep_s", run) == pytest.approx(1e-3)
    monkeypatch.setattr(otrace, "RING", 1)                    # ring full
    assert _read("setup.insert_id_map_s", run) is None
    assert _read("setup.insert_prep_s", run) is None


def test_a_port_without_the_ring_gives_none(monkeypatch):
    steps = _steps()
    for st in steps:
        _keep("query", st.t0 + 0.1, QUERY)
    _keep("insert_many", 10.0, INSERT)
    monkeypatch.delattr(otrace, "recent")
    run = _Run(steps)
    for name in QUERY_METRICS + SETUP_METRICS:
        assert _read(name, run) is None, name


def test_a_card_run_without_the_trace_module_is_an_error(monkeypatch):
    steps = _steps()
    monkeypatch.delitem(sys.modules, program.TRACE_MODULE)
    with pytest.raises(RuntimeError, match="not loaded"):
        _read("device.sketch_scan_ms", _Run(steps))
    with pytest.raises(RuntimeError, match="not loaded"):
        _read("setup.insert_id_map_s", _Run(steps))
    assert _read("device.sketch_scan_ms", _Run(steps, "cpu")) is None
    assert _read("setup.kernel_load_s", _Run(steps, "cpu")) is None
