"""``BENCHMARK.json`` against the benchmark's contract, and every name in it
resolving to its file (the configurations' laws and references and the
mixes' loops among them); a configuration, a mix and a metric added as
new files are found without editing any file that is there."""

from __future__ import annotations

import json
import re
import shutil
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from benchtest import BENCH, ROOT, run_cell  # noqa: E402

sys.path.insert(0, str(BENCH))
from benchlib import spec as bspec  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "bench/run.py"]
    assert bench["paths"] == ["bench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_units_and_lines(bench):
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names)), group
        for e in bench[group]:
            assert NAME.match(e["name"]), e["name"]
            for key in ("why", "layer", "source"):
                if key in e and isinstance(e[key], str):
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                        and "\t" not in e[key], (e["name"], key)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_cells_resolve(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    spec = bspec.Spec(ROOT)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/")
        cfg = spec.config(c["name"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert callable(bspec.value_law(cfg["data"]["value_law"]).values)
        assert callable(bspec.activation_law(cfg["data"]["activation"]).cdf)
        ref = bspec.reference(cfg["reference"])
        assert callable(ref.states) and callable(ref.mappings)
    used = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        assert callable(bspec.loop(spec.traffic(w["traffic"])["loop"]))
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        used.add(w["config"])
        assert any(m["name"] == "setup_s" for m in spec.metrics_e2e(w))
        assert len(spec.metrics_e2e(w)) >= 2
        assert spec.metrics("per_layer", w)
    assert used == set(configs)


def test_metrics_resolve_and_move(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert callable(bspec.reader(m["name"]))
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert callable(bspec.reader(m["name"]))
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in cells
            mv = e2e[m["moves"]]
            assert "workloads" not in mv or cell in mv["workloads"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_dummy_additions_need_no_edit(tmp_path):
    """A new configuration, mix and per-layer metric, as new files plus
    entries, are found and run (tiny, on the CPU)."""
    root = tmp_path / "repo"
    shutil.copytree(BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "src").symlink_to(ROOT / "src", target_is_directory=True)
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*")
              if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "msmarco-splade.json").read_text())
    cfg["name"] = "dummy-cfg"
    (root / "bench" / "configs" / "dummy-cfg.json").write_text(
        json.dumps(cfg))
    mix = json.loads((BENCH / "traffic" / "query_b256.json").read_text())
    (root / "bench" / "traffic" / "dummy_mix.json").write_text(
        json.dumps(mix))
    (root / "bench" / "metrics" / "dummy.count.py").write_text(
        "def read(run):\n    return float(len(run.window))\n")
    bench["configs"].append({"name": "dummy-cfg", "source": "a test",
                             "file": "bench/configs/dummy-cfg.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "dummy-cfg.dummy_mix",
                               "config": "dummy-cfg", "traffic": "dummy_mix",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "dummy.count", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "serving", "moves": "qps",
                               "workloads": ["dummy-cfg.dummy_mix"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "msmarco-splade.query_b256" in m["workloads"]:
            m["workloads"].append("dummy-cfg.dummy_mix")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for p, body in before.items():
        assert p.read_bytes() == body
    spec = bspec.Spec(root)
    cell = spec.cell("dummy-cfg.dummy_mix")
    assert spec.config(cell["config"])["name"] == "dummy-cfg"
    from benchtest import TINY
    TINY["dummy-cfg.dummy_mix"] = TINY["msmarco-splade.query_b256"]
    rc, line, err = run_cell("dummy-cfg.dummy_mix", trace=1, cwd=root)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True
    assert line["metrics"]["dummy.count"]["value"] >= 1
