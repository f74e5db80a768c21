"""``BENCHMARK.json`` and the files it names, found by name.

* a configuration: the ``file`` its entry names (JSON);
* its data's laws: ``bench/laws/values/<value_law>.py`` (``values(gen,
  shape, data, device)``) and ``bench/laws/activations/<activation>.py``
  (``cdf(data, device)``), named by the configuration's ``data`` block;
* its reference: the module at the configuration's ``reference`` path
  (``mappings`` and ``states``, see :mod:`benchlib.check`);
* a traffic mix: ``bench/traffic/<traffic>.json``, parameters of the loop
  it names, ``bench/loops/<loop>.py`` (a class ``Loop``);
* a metric, end-to-end or per-layer: ``bench/metrics/<name>.py``, a
  module with ``read(run) -> float | None`` (None: nothing to read, and
  the metric is left out of the line).

A later change adds a configuration, a mix, a law, a loop, a reference or
a metric as new files plus entries in ``BENCHMARK.json``; nothing here
names one.  A name with no file is a ``FileNotFoundError`` that names the
file looked for.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import re
import sys
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


def load(path: Path, what: str):
    """The module of the file at ``path``, which lies under ``bench/``,
    loaded once a process (under a name made from its place there)."""
    path = Path(path).resolve()
    if not path.is_file():
        raise FileNotFoundError(f"no {what}: {path} is not a file")
    if BENCH not in path.parents:
        raise ValueError(f"the {what} lies outside {BENCH}: {path}")
    rel = str(path.relative_to(BENCH))
    # readable, and one to one: "a.b" and "a_b" differ by the digest
    mod_name = "bench_file_" + re.sub(r"[^A-Za-z0-9_]", "_", rel[:-3]) + "_" \
        + hashlib.blake2b(rel.encode(), digest_size=4).hexdigest()
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[mod_name]
        raise
    return mod


def reader(name: str):
    """The ``read`` function of ``bench/metrics/<name>.py``."""
    return load(BENCH / "metrics" / f"{name}.py", f"metric {name!r}").read


def value_law(name: str):
    """``bench/laws/values/<name>.py``: ``values(gen, shape, data,
    device)``."""
    return load(BENCH / "laws" / "values" / f"{name}.py",
                f"value law {name!r}")


def activation_law(name: str):
    """``bench/laws/activations/<name>.py``: ``cdf(data, device)``."""
    return load(BENCH / "laws" / "activations" / f"{name}.py",
                f"activation law {name!r}")


def loop(name: str):
    """The ``Loop`` class of ``bench/loops/<name>.py``."""
    return load(BENCH / "loops" / f"{name}.py", f"loop {name!r}").Loop


def reference(path: str):
    """The reference module at ``path``, relative to the checkout's root
    (a configuration's ``reference`` key)."""
    return load(BENCH.parent / path, f"reference {path!r}")
