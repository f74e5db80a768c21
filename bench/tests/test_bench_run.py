"""Each cell's run end to end on the CPU at a tiny size (the port's plain
twins), the result line's form, the control and the planted faults
coming out not correct, and the guards: no card, JAX loaded."""

from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from benchtest import BENCH, ROOT, run_cell  # noqa

CELLS = ("msmarco-splade.query_b256",)


def _expected(cell: str, kind: str) -> set:
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    out = set()
    for m in bench[kind]:
        if cell in m.get("workloads", [cell]):
            out.add(m["name"])
    return out


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", (0, 1))
def test_cell_runs_and_prints_a_result(cell, trace):
    rc, line, err = run_cell(cell, seed=2**31 + 11, trace=trace)
    assert rc == 0, err[-3000:]
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, err[-3000:]
    assert line["failed"] == 0 and line["attempted"] > 0
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    names = set(line["metrics"])
    if trace == 0:
        assert names == _expected(cell, "end_to_end")
    else:
        # on the CPU the device's readers find nothing to read
        want = {n for n in _expected(cell, "per_layer")
                if not n.startswith("device.") and "roofline" not in n}
        assert names == want
    assert line["device"]["platform"] == "cpu"
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    assert err.rstrip().splitlines()[-1].startswith("check rank_faults")
    assert "mean non-zeros a document" in err


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ("answer_altered", "half_batch"))
def test_planted_fault_is_not_correct(cell, fault):
    rc, line, err = run_cell(cell, seed=2**31 + 12, fault=fault)
    assert rc == 0, err[-3000:]
    assert line["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    """The control, the reference's own search with float8 cells and
    store in the system's place, fails both numbers."""
    rc, line, err = run_cell(cell, seed=2**31 + 13,
                             extra=["--control", "f8-reference"])
    assert rc == 0, err[-3000:]
    assert line["correct"] is False
    for name, c in line["checks"].items():
        assert c["value"] > c["limit"], name


@pytest.mark.parametrize("cell", CELLS)
def test_float8_cells_serve_and_are_judged(cell):
    """The port's own float8-cell path runs through the harness and is
    judged: its served scores stay exact (the store is unchanged), and
    whether its candidates differ depends on the queries (PERF.md gives
    its readings at the cell's size)."""
    rc, line, err = run_cell(cell, seed=2**31 + 13,
                             extra=["--control", "f8-cells"])
    assert rc == 0, err[-3000:]
    assert line["checks"]["score_err"]["value"] < 1e-5
    assert "judged" in err


def test_no_card_means_no_result():
    code = ("import sys, torch; torch.cuda.is_available = lambda: False; "
            f"sys.path.insert(0, {str(BENCH)!r}); import run; "
            "sys.exit(run.main(['--workload', 'msmarco-splade.query_b256', "
            "'--seed', '1', '--seconds', '1']))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2 and proc.stdout.strip() == ""


def test_jax_loaded_means_no_result():
    code = ("import sys, types; sys.modules['jax'] = types.ModuleType('jax');"
            f" sys.path.insert(0, {str(BENCH)!r}); import run; "
            "sys.exit(run.main(['--workload', 'msmarco-splade.query_b256', "
            "'--seed', '1', '--seconds', '0.2', '--device', 'cpu', "
            "'--set', 'config.data.docs=300', "
            "'--set', 'config.index.capacity=320', "
            "'--set', 'config.serving.kprime=20', "
            "'--set', 'traffic.query_batch=2', "
            "'--set', 'traffic.query_pool_batches=2']))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 3 and proc.stdout.strip() == ""
    assert "jax" in proc.stderr


def test_forbidden_names_are_whole_top_level_names():
    sys.path.insert(0, str(BENCH))
    import run
    names = ["torch", "repro_torch_like", "jaxish.sub", "repro_torch.core"]
    assert run.forbidden_modules(names) == []
    assert run.forbidden_modules(names + ["repro.core"]) == ["repro"]
    assert run.forbidden_modules(["jax.numpy", "flax", "jaxlib.xla"]) == \
        ["flax", "jax", "jaxlib"]


def test_harness_without_the_program_fails(tmp_path):
    """A directory with only BENCHMARK.json and bench/ gives no result."""
    import shutil
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "msmarco-splade.query_b256", "--seed", "1", "--seconds", "1",
         "--device", "cpu"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
