"""Reading a ``torch.profiler`` trace of the window.

Device activity is the union of the intervals in which a kernel, a copy or
a fill ran on the card (overlapping work counts once).  The harness's own
``record_function`` labels (``bench.*``) mark the steps and the calls into
the system; on the device timeline their mirror images
(``gpu_user_annotation``) span idle time too, so they are not activity.
"""

from __future__ import annotations

import bisect

import numpy as np

LABEL = "bench."
STEP_PLAIN = "bench.step"


def _is_device(evt) -> bool:
    return str(getattr(evt, "device_type", "")).endswith("CUDA")


def _is_annotation(evt) -> bool:
    return (getattr(evt, "is_user_annotation", False)
            or evt.name.startswith(LABEL)
            or "user_annotation" in str(getattr(evt, "activity_type", "")))


def union(intervals: np.ndarray) -> np.ndarray:
    """Disjoint sorted intervals [N, 2] covering ``intervals``."""
    if not len(intervals):
        return np.zeros((0, 2))
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    out = []
    s, e = iv[0]
    for a, b in iv[1:]:
        if a > e:
            out.append((s, e))
            s, e = a, b
        elif b > e:
            e = b
    out.append((s, e))
    return np.asarray(out, dtype=np.float64)


def covered(busy: np.ndarray, lo: float, hi: float) -> float:
    """Length of ``[lo, hi]`` that the disjoint intervals ``busy`` cover."""
    if not len(busy):
        return 0.0
    a = np.clip(busy[:, 0], lo, hi)
    b = np.clip(busy[:, 1], lo, hi)
    return float((b - a).sum())


class Timeline:
    """The profiled window: device activity, host ranges, and the
    breakdown the result line carries.  Times in seconds."""

    def __init__(self, prof):
        dev, host, ranges = [], [], []
        for e in prof.events():
            t0, t1 = e.time_range.start * 1e-6, e.time_range.end * 1e-6
            if _is_device(e):
                if not _is_annotation(e):
                    dev.append((t0, t1, e.name))
            elif e.name.startswith(LABEL):
                ranges.append((t0, t1, e.name))
            else:
                host.append((t0, t1, e.name))
        self.device = dev
        self.busy = union(np.asarray([(a, b) for a, b, _ in dev],
                                     dtype=np.float64).reshape(-1, 2))
        self.ranges = sorted(ranges)
        self.host = sorted(host)
        steps = [r for r in self.ranges if r[2].startswith("bench.step")]
        self.w0 = steps[0][0] if steps else 0.0
        self.w1 = steps[-1][1] if steps else 0.0

    @property
    def window_s(self) -> float:
        return self.w1 - self.w0

    @property
    def busy_s(self) -> float:
        return covered(self.busy, self.w0, self.w1)

    def idle_share(self, name: str = STEP_PLAIN):
        """1 - busy / time over the host ranges labelled ``name`` (the
        unstaged steps), or None without any."""
        rs = [(a, b) for a, b, n in self.ranges if n == name]
        total = sum(b - a for a, b in rs)
        if not total:
            return None
        return 1.0 - sum(covered(self.busy, a, b) for a, b in rs) / total

    def device_ops(self, top: int = 10) -> list:
        """Device operations that took most time in the window."""
        sums: dict = {}
        for a, b, name in self.device:
            a, b = max(a, self.w0), min(b, self.w1)
            if b > a:
                key = name[:120]
                sums[key] = sums.get(key, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(sums.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """Device idle time in the window, summed by what the host was
        doing at each gap's middle: the innermost harness label and the
        innermost host operation there."""
        edges = [self.w0] + [x for ab in self.busy for x in ab] + [self.w1]
        gaps = [(max(a, self.w0), min(b, self.w1))
                for a, b in zip(edges[::2], edges[1::2])]
        sums: dict = {}
        for a, b in gaps:
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            lab = _innermost(self.ranges, mid) or "outside"
            op = _innermost(self.host, mid) or "python"
            key = f"{lab}/{op}"[:120]
            sums[key] = sums.get(key, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(sums.items(),
                                          key=lambda kv: -kv[1])[:top]]


def _innermost(ranges: list, t: float, look_back: int = 256):
    """Name of the innermost range in ``ranges`` (sorted by start, nested
    on their thread) that holds ``t``: the latest-starting one, found
    within ``look_back`` ranges of the last start before ``t``."""
    i = bisect.bisect_right(ranges, (t, float("inf"), "")) - 1
    for j in range(i, max(i - look_back, -1), -1):
        if ranges[j][1] >= t:
            return ranges[j][2]
    return None
