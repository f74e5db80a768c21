"""The G200 deployment's files: its two laws, its configuration found
through ``benchlib/spec.py``, its index bytes against the port's own
accounting, the cell tiny on the CPU (correct; the reference's float8
search in its place not correct), and ``kernels.scan_ns_per_coord``, which gives None on a port
whose traces carry no ``coords`` counter.  With the ``gpu`` marker, on the
card: the whole cell for a short window comes out correct."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from benchtest import BENCH, ROOT, run_cell  # noqa: E402

for _p in (str(BENCH), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)
from benchlib import data as bdata  # noqa: E402
from benchlib import spec as bspec  # noqa: E402
from benchlib.loop import Step  # noqa: E402
from repro_torch.obs import trace as otrace  # noqa: E402

CELL = "g200.query_b256"
TINY = ["--set", "config.data.docs=3000", "--set",
        "config.index.capacity=3072", "--set", "config.serving.kprime=100",
        "--set", "traffic.query_batch=8", "--set",
        "traffic.query_pool_batches=4", "--set",
        'traffic.check={"steps": 4, "queries_per_step": 8}']
#: The index's parts at m = 64: bitmap, [U; L] sketch, store.
BITMAP, SKETCH, STORE = 35_651_584_000, 2_281_701_376, 13_690_208_256


def _cfg() -> dict:
    return bspec.Spec(ROOT).config("g200")


# -- the laws ---------------------------------------------------------------------

def test_normal_law_draws_both_signs_at_unit_scale():
    data = _cfg()["data"]
    law = bspec.value_law(data["value_law"])
    v = law.values(bdata.generator(2**31 + 1, "corpus", 0, "cpu"),
                   (4000, 64), data, "cpu").double()
    assert float(v.mean()) == pytest.approx(0.0, abs=0.01)
    assert float(v.std()) == pytest.approx(1.0, abs=0.01)
    assert float((v < 0).double().mean()) == pytest.approx(0.5, abs=0.01)
    assert bool((v != 0).all())
    with pytest.raises(ValueError, match="nonneg"):
        law.values(bdata.generator(1, "corpus", 0, "cpu"), (2, 2),
                   dict(data, nonneg=True), "cpu")


def test_uniform_activation_spreads_evenly_over_n():
    data = _cfg()["data"]
    cdf = bdata.activation_cdf(data, "cpu")
    n = int(data["n"])
    assert cdf.shape == (n,) and float(cdf[-1]) == 1.0
    assert torch.allclose(torch.diff(cdf), torch.full((n - 1,), 1.0 / n,
                                                      dtype=torch.float64))
    gen = bdata.generator(2**31 + 2, "corpus", 0, "cpu")
    idx, val = bdata.draw_sparse(gen, 6000, data["psi_doc"],
                                 int(data["doc_pad"]), cdf, data, "cpu")
    counts = torch.bincount(idx[idx >= 0].long(), minlength=n).double()
    # 6,000 rows of about 200: about 37.5 draws a coordinate, Poisson-like
    mean = float(counts.mean())
    assert mean == pytest.approx(37.5, rel=0.02)
    assert float(counts.var()) == pytest.approx(mean, rel=0.1)
    halves = counts.view(2, -1).sum(1)
    assert float(halves[0] / halves[1]) == pytest.approx(1.0, abs=0.02)
    ok = idx >= 0
    assert float((val[ok] < 0).double().mean()) == pytest.approx(0.5,
                                                                 abs=0.01)


# -- the configuration ---------------------------------------------------------------

def test_configuration_loads_through_spec():
    spec = bspec.Spec(ROOT)
    cell = spec.cell(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("g200", "query_b256", 1)
    cfg = spec.config("g200")
    assert cfg["reduced"] == []
    assert {"docs", "m", "h", "kprime", "cells"} <= set(cfg["assumed"])
    assert set(cfg["check"]["why"]) == {"score_err", "rank_faults",
                                        "ub_band"}
    data = cfg["data"]
    assert (data["n"], data["psi_doc"], data["psi_query"]) == (32000, 200,
                                                               200)
    assert data["nonneg"] is False and cfg["index"]["positive_only"] is False
    assert bspec.reference(cfg["reference"]).states
    assert bspec.loop(spec.traffic(cell["traffic"])["loop"])
    entry = {c["name"]: c for c in spec.data["configs"]}["g200"]
    assert entry["file"] == "bench/configs/g200.json"


@pytest.mark.parametrize("m, extra", ((64, 0), (128, SKETCH)))
def test_index_bytes_match_the_port_accounting(m, extra):
    from repro_torch.core.engine import EngineSpec
    from repro_torch.eval.tune import spec_index_bytes
    ix = _cfg()["index"]
    spec = EngineSpec(n=ix["n"], m=m, capacity=ix["capacity"],
                      max_nnz=ix["max_nnz"], h=ix["h"],
                      dtype=ix["cell_dtype"], value_dtype=ix["store_dtype"])
    store = ix["capacity"] * ix["max_nnz"] * (4 + 2)
    assert store == STORE
    assert spec_index_bytes(spec) == BITMAP + SKETCH + extra
    assert spec_index_bytes(spec) + store == 51_623_493_632 + extra


# -- the cell tiny on the CPU ------------------------------------------------------

@pytest.mark.parametrize("control", (None, "f8-cells", "f8-reference"))
def test_tiny_cell_and_controls(control):
    """The cell is correct; the reference's float8 search in the system's
    place fails both numbers.  The port's float8-cell path keeps exact
    served scores, and whether its candidates differ at this size depends
    on the queries (PERF.md gives its readings at the cell's size)."""
    extra = TINY + (["--control", control] if control else [])
    rc, line, err = run_cell(CELL, seed=2**31 + 35, extra=extra)
    assert rc == 0, err[-3000:]
    checks = line["checks"]
    if control is None:
        assert line["correct"] is True, checks
        assert checks["rank_faults"]["value"] == 0
        assert set(line["metrics"]) == {"qps", "p95_ms", "setup_s"}
    elif control == "f8-cells":
        assert checks["score_err"]["value"] < checks["score_err"]["limit"]
    else:
        assert line["correct"] is False
        for name, c in checks.items():
            assert c["value"] > c["limit"], name


# -- the new metric ----------------------------------------------------------------

class _Run:
    def __init__(self, window, device_kind="NVIDIA H100 80GB HBM3"):
        self.window = window
        self.device_kind = device_kind


@pytest.fixture
def ring():
    otrace.clear()
    yield
    otrace.clear()


def _window(counters, device_ms=2.0, device_kind="NVIDIA H100 80GB HBM3"):
    steps = []
    for i, n in enumerate(counters):
        st = Step("window")
        st.t0, st.t1 = 100.0 + i, 100.0 + i + 0.9
        steps.append(st)
        tr = otrace.Trace("query", device_timed=True)
        tr.t0 = st.t0 + 0.1
        for j, name in enumerate(("admission", "sketch_scan", "rerank")):
            tr.spans.append(otrace.Span(
                name, 0.5, start_ms=float(j),
                device_ms=None if device_ms is None else device_ms * (i + 1)))
        if n is not None:
            tr.counters = {"coords": n, "lower_coords": n // 2}
        tr.finish()
    return _Run(steps, device_kind)


def test_scan_ns_per_coord_reads_time_over_pairs(ring):
    read = bspec.reader("kernels.scan_ns_per_coord")
    # 2 + 4 ms over 1,000 + 2,000 pairs: 2,000 ns a pair
    assert read(_window([1000, 2000])) == pytest.approx(2000.0)


@pytest.mark.parametrize("counters", ([None, None], [1000, None]))
def test_scan_ns_per_coord_is_none_without_counters(ring, counters):
    assert bspec.reader("kernels.scan_ns_per_coord")(
        _window(counters)) is None


def test_scan_ns_per_coord_is_none_without_device_time(ring):
    assert bspec.reader("kernels.scan_ns_per_coord")(
        _window([1000, 2000], device_ms=None)) is None


def test_scan_ns_per_coord_reads_host_time_on_the_cpu(ring):
    """The CPU's spans carry no device time; their work runs as it is
    issued, so the host time stands: 0.5 ms over 1,000 pairs each."""
    read = bspec.reader("kernels.scan_ns_per_coord")
    assert read(_window([1000, 1000], device_ms=None,
                        device_kind="cpu")) == pytest.approx(500.0)


# -- on the card --------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m gpu)")


@pytest.mark.gpu
def test_whole_cell_short_window_is_correct(card):
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", CELL, "--seed",
         str(2**31 + 37), "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900,
        env=dict(os.environ))
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["checks"]["rank_faults"]["value"] == 0
