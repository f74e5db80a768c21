"""The candidate-generation work count against a count by hand, and the
idle share and breakdown read from a synthetic profiler timeline."""

from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from benchtest import BENCH  # noqa: E402

sys.path.insert(0, str(BENCH))
from benchlib.trace import Timeline, union  # noqa: E402
from roofline.candidates import candidate_work  # noqa: E402
from roofline.peaks import least_seconds  # noqa: E402


def test_candidate_work_by_hand():
    # n = 6 coordinates, m = 4 cells, h = 1; two queries of width 3
    maps = np.array([[0, 1, 1, 2, 3, 0]])
    posting = np.array([5, 0, 2, 7, 1, 4])
    q_idx = np.array([[0, 3, -1], [3, 2, 5]])
    q_val = np.array([[1.0, 0.5, 0.0], [2.0, -1.0, 0.3]])
    C, kp = 64, 10
    nbytes, ops = candidate_work(q_idx, q_val, maps, 4, True, posting, C, 2,
                                 kp)
    # coordinates 0, 3 | 3, 2(-), 5: upper rows {0, 2, 0} and lower row
    # 1 + 4 = 5 -> 3 distinct sketch rows; bitmap rows {0, 2, 3, 5} -> 4
    want_bytes = (3 * C * 2 + 4 * C // 8 + C + 2 * 3 * 4 * (2 + 1)
                  + 2 * kp * 8)
    assert nbytes == want_bytes
    assert ops == 2 * (5 + 7 + 7 + 2 + 4)
    # without a lower sketch the negative coordinate reads nothing
    nb1, ops1 = candidate_work(q_idx, q_val, maps, 4, False, posting, C, 2,
                               kp)
    assert ops1 == 2 * (5 + 7 + 7 + 4)
    assert nb1 == 2 * C * 2 + 3 * C // 8 + C + 2 * 3 * 4 * 3 + 2 * kp * 8


def test_least_seconds_takes_the_larger_bound():
    assert least_seconds(3.35e12, 0, "NVIDIA H100 80GB HBM3") == 1.0
    assert least_seconds(0, 67e12, "NVIDIA H100 80GB HBM3") == 1.0
    assert least_seconds(1, 1, "cpu") is None


def _evt(name, t0, t1, device):
    return SimpleNamespace(name=name, device_type=f"DeviceType.{device}",
                           time_range=SimpleNamespace(start=t0, end=t1))


def test_timeline_union_idle_and_gaps():
    events = [
        _evt("bench.step", 0, 100, "CPU"),
        _evt("bench.step.staged", 100, 200, "CPU"),
        _evt("bench.query_many", 10, 90, "CPU"),
        _evt("aten::topk", 60, 70, "CPU"),
        _evt("kernel_a", 20, 50, "CUDA"),
        _evt("kernel_b", 40, 55, "CUDA"),          # overlaps: counted once
        _evt("bench.query_many", 20, 80, "CUDA"),  # annotation, not work
        _evt("kernel_a", 120, 180, "CUDA"),
    ]
    tl = Timeline(SimpleNamespace(events=lambda: events))
    assert tl.window_s == pytest.approx(200e-6)
    assert tl.busy_s == pytest.approx((35 + 60) * 1e-6)
    assert tl.idle_share() == pytest.approx(1 - 35 / 100)
    ops = dict(tl.device_ops())
    assert ops["kernel_a"] == pytest.approx(90e-6)
    gaps = dict(tl.idle_gaps())
    # gaps at 0-20 and 55-120 fall inside query_many, outside any host op
    assert gaps["bench.query_many/python"] == pytest.approx(85e-6)
    assert gaps["bench.step.staged/python"] == pytest.approx(20e-6)
    assert sum(gaps.values()) == pytest.approx(105e-6)


def test_union_merges_overlaps():
    iv = np.array([[5, 6], [0, 2], [1, 3], [3, 4]], dtype=float)
    assert union(iv).tolist() == [[0, 4], [5, 6]]
