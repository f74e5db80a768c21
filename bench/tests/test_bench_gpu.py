"""On the card: the cell on an eighth of its corpus (1,105,228 documents
in 1,114,112 slots, one shard of ``serve_msmarco``) comes out correct, and
its controls (the port's float8-cell path; the reference's float8 search
in the system's place) come out not correct.  Skips without a card."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from benchtest import ROOT  # noqa: E402

SHARD = ["--set", "config.data.docs=1105228",
         "--set", "config.index.capacity=1114112"]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m gpu)")


def _run(cell, seed, extra=()):
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", cell, "--seed",
         str(seed), "--seconds", "3", "--trace", "0", *SHARD, *extra],
        cwd=ROOT, capture_output=True, text=True, timeout=900,
        env=dict(os.environ))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ("msmarco-splade.query_b256",))
@pytest.mark.parametrize("control", (None, "f8-cells", "f8-reference"))
def test_shard_cell_and_controls(card, cell, control):
    extra = ("--control", control) if control else ()
    line = _run(cell, 2**31 + 21, extra)
    assert line["correct"] is (control is None), line["checks"]
