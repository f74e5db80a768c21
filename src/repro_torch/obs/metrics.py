"""Process-local metrics: counters, gauges, and fixed-exponential-bucket
histograms behind a registry with bounded label cardinality.

Design constraints:

- stdlib only — the registry must be importable from every layer (WAL,
  kernels wrappers, benchmarks) without dragging in JAX or numpy;
- thread-safe — the WAL writer, `BackgroundCompactor`, and the metrics
  HTTP server all touch it from their own threads;
- mergeable snapshots — two registries (e.g. per-process shards) with the
  same bucket layout can be summed sample-for-sample;
- bounded label cardinality — a typo'd dynamic label (doc id, slot
  number) raises `LabelCardinalityError` instead of silently growing an
  unbounded family;
- one shared percentile implementation — `Histogram.percentile` backs
  both `QueryServer.latency_percentiles()` and the benchmark gates.

Histograms use a fixed exponential layout ``bound[i] = start * factor**i``
so percentile estimates carry at most one bucket (``factor``) of relative
error, tightened at the tails by clamping to the exact tracked min/max.
"""

from __future__ import annotations

import json
import math
import re
import threading
from bisect import bisect_left

__all__ = [
    "Buckets",
    "Counter",
    "Gauge",
    "Histogram",
    "LabelCardinalityError",
    "MetricsRegistry",
    "NULL_REGISTRY",
    "DEFAULT_LATENCY_BUCKETS",
    "DEFAULT_COUNT_BUCKETS",
    "get_registry",
    "set_registry",
    "merge_snapshots",
    "parse_exposition",
]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


class LabelCardinalityError(RuntimeError):
    """A metric family exceeded the registry's label-set budget."""


class Buckets:
    """Fixed exponential histogram layout: ``bound[i] = start * factor**i``."""

    __slots__ = ("start", "factor", "count", "bounds")

    def __init__(self, start: float, factor: float, count: int):
        if not (start > 0.0 and factor > 1.0 and count >= 1):
            raise ValueError("need start > 0, factor > 1, count >= 1")
        self.start = float(start)
        self.factor = float(factor)
        self.count = int(count)
        self.bounds = tuple(self.start * self.factor**i for i in range(self.count))

    def index(self, value: float) -> int:
        """Bucket index for `value`; `count` means the +Inf overflow bucket."""
        return bisect_left(self.bounds, value)

    def spec(self) -> dict:
        return {"start": self.start, "factor": self.factor, "count": self.count}

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Buckets)
            and (self.start, self.factor, self.count) == (other.start, other.factor, other.count)
        )

    def __hash__(self) -> int:
        return hash((self.start, self.factor, self.count))


# 1 µs .. ~14.7 s in milliseconds at ±~9% resolution (factor 2**0.25).
DEFAULT_LATENCY_BUCKETS = Buckets(1e-3, 2**0.25, 96)
# 1 .. 2**31 for batch sizes / byte counts per op.
DEFAULT_COUNT_BUCKETS = Buckets(1.0, 2.0, 32)


class Counter:
    """Monotonic counter."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0

    def snapshot(self) -> dict:
        return {"value": self._value}


class Gauge:
    """Instantaneous value."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value

    def reset(self) -> None:
        self.set(0.0)

    def snapshot(self) -> dict:
        return {"value": self._value}


class Histogram:
    """Exponential-bucket histogram with exact sum/count/min/max sidecars.

    Buckets optionally carry an *exemplar* — the id of one concrete sample
    (a flight-recorder trace id) that landed in the bucket, so a latency
    bucket in a dashboard links to a full request trace at
    ``/debug/trace/<id>``.  One exemplar per bucket, latest wins.
    """

    __slots__ = ("buckets", "_counts", "_count", "_sum", "_min", "_max",
                 "_exemplars", "_lock")

    def __init__(self, buckets: Buckets | None = None):
        self.buckets = buckets if buckets is not None else DEFAULT_LATENCY_BUCKETS
        self._counts = [0] * (self.buckets.count + 1)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._exemplars = None  # {bucket_index: (id, value)}, lazily allocated
        self._lock = threading.Lock()

    def observe(self, value: float, n: int = 1, exemplar: str | None = None) -> None:
        """Record `value`; `n > 1` records it as n identical samples (used
        for per-query latency derived from one timed batch).  `exemplar`
        attaches a trace id to the bucket the value lands in."""
        value = float(value)
        i = self.buckets.index(value)
        with self._lock:
            self._counts[i] += n
            self._count += n
            self._sum += value * n
            if value < self._min:
                self._min = value
            if value > self._max:
                self._max = value
            if exemplar is not None:
                if self._exemplars is None:
                    self._exemplars = {}
                self._exemplars[i] = (str(exemplar), value)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def percentile(self, p: float) -> float:
        """Estimate the p-th percentile (0..100) from the bucket counts.

        The estimate is the geometric midpoint of the bucket holding the
        target rank, clamped to the exact tracked [min, max] — relative
        error is at most one bucket width (`buckets.factor`).
        """
        with self._lock:
            count = self._count
            counts = list(self._counts)
            lo_clamp, hi_clamp = self._min, self._max
        if count == 0:
            return 0.0
        target = max(1, math.ceil((p / 100.0) * count))
        target = min(target, count)
        seen = 0
        bounds = self.buckets.bounds
        for i, c in enumerate(counts):
            seen += c
            if seen >= target:
                lo = bounds[i - 1] if i > 0 else bounds[0] / self.buckets.factor
                hi = bounds[i] if i < len(bounds) else hi_clamp
                est = math.sqrt(lo * hi) if hi > 0 and lo > 0 else (lo + hi) / 2.0
                return min(max(est, lo_clamp), hi_clamp)
        return hi_clamp

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * (self.buckets.count + 1)
            self._count = 0
            self._sum = 0.0
            self._min = math.inf
            self._max = -math.inf
            self._exemplars = None

    @property
    def bucket_counts(self) -> list:
        with self._lock:
            return list(self._counts)

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "buckets": self.buckets.spec(),
                "counts": list(self._counts),
                "count": self._count,
                "sum": self._sum,
                "min": None if self._count == 0 else self._min,
                "max": None if self._count == 0 else self._max,
            }
            if self._exemplars:
                out["exemplars"] = {
                    str(i): {"trace_id": tid, "value": val}
                    for i, (tid, val) in self._exemplars.items()
                }
            return out


class _Family:
    __slots__ = ("kind", "help", "buckets", "children")

    def __init__(self, kind: str, help_text: str, buckets: Buckets | None):
        self.kind = kind
        self.help = help_text
        self.buckets = buckets
        self.children = {}  # label tuple -> metric


def _label_key(labels: dict | None) -> tuple:
    if not labels:
        return ()
    items = []
    for k, v in labels.items():
        k = str(k)
        if not _LABEL_NAME_RE.match(k):
            raise ValueError(f"invalid label name: {k!r}")
        items.append((k, str(v)))
    return tuple(sorted(items))


class MetricsRegistry:
    """Named metric families plus pull-time gauge collectors.

    `max_label_sets` bounds the number of distinct label combinations per
    family — exceeding it raises `LabelCardinalityError` so accidental
    per-document labels fail loudly instead of leaking memory.
    """

    def __init__(self, max_label_sets: int = 64):
        self.max_label_sets = int(max_label_sets)
        self._families: dict[str, _Family] = {}
        self._collectors = []
        self.collector_errors = 0
        self._lock = threading.Lock()

    # -- metric accessors (create on first use, return existing after) ------

    def counter(self, name: str, help_text: str = "", labels: dict | None = None) -> Counter:
        return self._child(name, "counter", help_text, labels)

    def gauge(self, name: str, help_text: str = "", labels: dict | None = None) -> Gauge:
        return self._child(name, "gauge", help_text, labels)

    def histogram(
        self,
        name: str,
        help_text: str = "",
        labels: dict | None = None,
        buckets: Buckets | None = None,
    ) -> Histogram:
        return self._child(name, "histogram", help_text, labels, buckets)

    def _child(self, name, kind, help_text, labels, buckets=None):
        key = _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                if not _NAME_RE.match(name):
                    raise ValueError(f"invalid metric name: {name!r}")
                fam = _Family(kind, help_text, buckets)
                self._families[name] = fam
            else:
                if fam.kind != kind:
                    raise ValueError(f"{name} is a {fam.kind}, requested {kind}")
                if kind == "histogram" and buckets is not None and fam.buckets is not None:
                    if buckets != fam.buckets:
                        raise ValueError(f"{name}: conflicting bucket layouts")
            child = fam.children.get(key)
            if child is None:
                if len(fam.children) >= self.max_label_sets:
                    raise LabelCardinalityError(
                        f"{name}: more than {self.max_label_sets} label sets"
                    )
                if kind == "counter":
                    child = Counter()
                elif kind == "gauge":
                    child = Gauge()
                else:
                    child = Histogram(fam.buckets)
                fam.children[key] = child
            return child

    # -- pull-time collectors -----------------------------------------------

    def add_collector(self, fn) -> None:
        """Register `fn()` to run before every snapshot/exposition.  A
        collector that returns False (e.g. its weakref target died) is
        removed; one that raises is kept and counted in
        `collector_errors`."""
        with self._lock:
            self._collectors.append(fn)

    def collect(self) -> None:
        with self._lock:
            collectors = list(self._collectors)
        dead = []
        for fn in collectors:
            try:
                if fn() is False:
                    dead.append(fn)
            except Exception:
                self.collector_errors += 1
        if dead:
            with self._lock:
                for fn in dead:
                    if fn in self._collectors:
                        self._collectors.remove(fn)

    # -- export --------------------------------------------------------------

    def snapshot(self) -> dict:
        """Structured dump: {name: {type, help, series: [{labels, ...}]}}."""
        self.collect()
        out = {}
        with self._lock:
            families = list(self._families.items())
        for name, fam in families:
            series = []
            for key, child in list(fam.children.items()):
                entry = {"labels": dict(key)}
                entry.update(child.snapshot())
                series.append(entry)
            out[name] = {"type": fam.kind, "help": fam.help, "series": series}
        return out

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)

    def exposition(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines = []
        for name, fam in self.snapshot().items():
            if fam["help"]:
                lines.append(f"# HELP {name} {_escape_help(fam['help'])}")
            lines.append(f"# TYPE {name} {fam['type']}")
            for s in fam["series"]:
                labels = s["labels"]
                if fam["type"] in ("counter", "gauge"):
                    lines.append(f"{name}{_fmt_labels(labels)} {_fmt_value(s['value'])}")
                else:
                    spec = s["buckets"]
                    bounds = [spec["start"] * spec["factor"] ** i for i in range(spec["count"])]
                    exemplars = s.get("exemplars", {})
                    cum = 0
                    for i, (b, c) in enumerate(zip(bounds, s["counts"])):
                        cum += c
                        le = {**labels, "le": format(b, ".10g")}
                        line = f"{name}_bucket{_fmt_labels(le)} {cum}"
                        ex = exemplars.get(str(i))
                        if ex is not None:  # OpenMetrics exemplar suffix
                            line += (f' # {{trace_id="'
                                     f'{_escape_label_value(ex["trace_id"])}'
                                     f'"}} {_fmt_value(ex["value"])}')
                        lines.append(line)
                    cum += s["counts"][-1]
                    le = {**labels, "le": "+Inf"}
                    lines.append(f"{name}_bucket{_fmt_labels(le)} {cum}")
                    lines.append(f"{name}_sum{_fmt_labels(labels)} {_fmt_value(s['sum'])}")
                    lines.append(f"{name}_count{_fmt_labels(labels)} {s['count']}")
        return "\n".join(lines) + ("\n" if lines else "")


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label_value(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if v != v:
        return "NaN"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


# -- the process-global registry ---------------------------------------------


class _NullMetric:
    """Absorbs every metric call; `percentile` is 0 and `count` stays 0."""

    __slots__ = ()

    def inc(self, amount: float = 1.0) -> None:
        pass

    def dec(self, amount: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float, n: int = 1, exemplar: str | None = None) -> None:
        pass

    def reset(self) -> None:
        pass

    def percentile(self, p: float) -> float:
        return 0.0

    value = 0.0
    count = 0
    sum = 0.0

    def snapshot(self) -> dict:
        return {}


_NULL_METRIC = _NullMetric()


class NullRegistry:
    """Registry stand-in that records nothing — inject to turn metrics off."""

    max_label_sets = 0
    collector_errors = 0

    def counter(self, name, help_text="", labels=None):
        return _NULL_METRIC

    def gauge(self, name, help_text="", labels=None):
        return _NULL_METRIC

    def histogram(self, name, help_text="", labels=None, buckets=None):
        return _NULL_METRIC

    def add_collector(self, fn) -> None:
        pass

    def collect(self) -> None:
        pass

    def snapshot(self) -> dict:
        return {}

    def to_json(self) -> str:
        return "{}"

    def exposition(self) -> str:
        return ""


NULL_REGISTRY = NullRegistry()

_global_registry = MetricsRegistry()
_global_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-global registry every subsystem reports into by default."""
    return _global_registry


def set_registry(registry) -> MetricsRegistry:
    """Swap the process-global registry (tests; metrics-off benchmarking).
    Returns the previous registry so callers can restore it."""
    global _global_registry
    with _global_lock:
        old = _global_registry
        _global_registry = registry
    return old


# -- snapshot merging ---------------------------------------------------------


def merge_snapshots(a: dict, b: dict) -> dict:
    """Merge two `MetricsRegistry.snapshot()` dicts sample-for-sample.

    Counters and gauges sum; histograms require identical bucket layouts
    (ValueError otherwise) and sum counts/sums, min/max-ing the sidecars.
    """
    out = {}
    for name in sorted(set(a) | set(b)):
        fa, fb = a.get(name), b.get(name)
        if fa is None or fb is None:
            src = fa if fb is None else fb
            out[name] = json.loads(json.dumps(src))
            continue
        if fa["type"] != fb["type"]:
            raise ValueError(f"{name}: type mismatch {fa['type']} vs {fb['type']}")
        merged = {"type": fa["type"], "help": fa["help"] or fb["help"], "series": []}
        by_labels = {}
        for src in (fa, fb):
            for s in src["series"]:
                key = tuple(sorted(s["labels"].items()))
                prev = by_labels.get(key)
                if prev is None:
                    by_labels[key] = json.loads(json.dumps(s))
                elif fa["type"] == "histogram":
                    if prev["buckets"] != s["buckets"]:
                        raise ValueError(f"{name}: bucket layout mismatch")
                    prev["counts"] = [x + y for x, y in zip(prev["counts"], s["counts"])]
                    prev["count"] += s["count"]
                    prev["sum"] += s["sum"]
                    for fld, pick in (("min", min), ("max", max)):
                        vals = [v for v in (prev[fld], s[fld]) if v is not None]
                        prev[fld] = pick(vals) if vals else None
                    if "exemplars" in s:  # per-bucket: later source wins
                        prev["exemplars"] = {**prev.get("exemplars", {}),
                                             **s["exemplars"]}
                else:
                    prev["value"] += s["value"]
        merged["series"] = [by_labels[k] for k in sorted(by_labels)]
        out[name] = merged
    return out


# -- exposition parsing (CI validator) ----------------------------------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"\s+(?P<value>[^\s#]+)"
    r"(?P<exemplar>\s+#\s+\{[^}]*\}\s+[^\s]+)?\s*$"
)
_LABEL_PAIR_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_exposition(text: str) -> dict:
    """Parse Prometheus text exposition into {(name, label_tuple): value}.

    OpenMetrics exemplar suffixes (``# {trace_id="..."} 1.23``) on bucket
    lines are validated and stripped.  Raises ValueError on any malformed
    line — used by CI to validate the live `/metrics` endpoint actually
    speaks the format.
    """
    samples = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        match = _SAMPLE_RE.match(line)
        if not match:
            raise ValueError(f"line {lineno}: malformed sample {line!r}")
        labels = ()
        body = match.group("labels")
        if body:
            pairs = _LABEL_PAIR_RE.findall(body)
            rebuilt = ",".join(f'{k}="{v}"' for k, v in pairs)
            if rebuilt != body:
                raise ValueError(f"line {lineno}: malformed labels {body!r}")
            labels = tuple((k, v) for k, v in pairs)
        raw = match.group("value")
        try:
            value = float(raw.replace("+Inf", "inf").replace("-Inf", "-inf"))
        except ValueError as exc:
            raise ValueError(f"line {lineno}: bad value {raw!r}") from exc
        samples[(match.group("name"), labels)] = value
    return samples
