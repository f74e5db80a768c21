"""``BENCHMARK.json`` and the files it names, found by name.

* a configuration: the ``file`` its entry names (JSON);
* a traffic mix: ``bench/traffic/<traffic>.json`` (parameters that the one
  general loop, :mod:`benchlib.loop`, reads);
* a metric, end-to-end or per-layer: ``bench/metrics/<name>.py``, a
  module with ``read(run) -> float | None`` (None: nothing to read, and
  the metric is left out of the line).

A later change adds a configuration, a mix or a metric as new files plus
entries in ``BENCHMARK.json``; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]


class Spec:
    def __init__(self, root: Path):
        self.root = Path(root)
        with open(self.root / "BENCHMARK.json") as f:
            self.data = json.load(f)

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                with open(self.root / c["file"]) as f:
                    return json.load(f)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        with open(BENCH / "traffic" / f"{name}.json") as f:
            return json.load(f)

    def metrics(self, kind: str, cell: dict) -> list:
        """The ``end_to_end`` or ``per_layer`` entries a cell reports:
        those that list it under ``workloads``, and those without the key
        (a per-layer metric without it goes wherever the end-to-end metric
        it moves is reported)."""
        e2e = {m["name"] for m in self.metrics_e2e(cell)}
        out = []
        for m in self.data[kind]:
            if "workloads" in m:
                if cell["name"] in m["workloads"]:
                    out.append(m)
            elif kind == "end_to_end" or m["moves"] in e2e:
                out.append(m)
        return out

    def metrics_e2e(self, cell: dict) -> list:
        return [m for m in self.data["end_to_end"]
                if "workloads" not in m or cell["name"] in m["workloads"]]


def reader(name: str):
    """The ``read`` function of ``bench/metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    mod_name = "bench_metric_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
