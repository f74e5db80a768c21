"""Helpers of the benchmark's CPU tests: running ``bench/run.py`` on a tiny
index in a subprocess, optionally with a fault planted under it."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

#: Tiny sizes of the cell: 3,000 documents, k' = 100, 8 queries a batch.
TINY = {
    "msmarco-splade.query_b256": [
        "config.data.docs=3000", "config.index.capacity=3072",
        "config.serving.kprime=100", "traffic.query_batch=8",
        "traffic.query_pool_batches=4",
        'traffic.check={"steps": 4, "queries_per_step": 8}'],
}

#: Faults planted under the harness: Python run before ``run.main``.
FAULTS = {
    # an answer altered where it is produced: a query's best id replaced
    # by another query's
    "answer_altered": """
        orig = System.query
        def query(self, q_idx, q_val, staged=False):
            ids, scores, spans = orig(self, q_idx, q_val, staged)
            ids = ids.copy()
            ids[0, 0] = ids[-1, 0]
            return ids, scores, spans
        System.query = query
    """,
    # half of the batch left out: the first half's answers stand in for
    # the second half's
    "half_batch": """
        orig = System.query
        def query(self, q_idx, q_val, staged=False):
            h = (len(q_idx) + 1) // 2
            ids, scores, spans = orig(self, q_idx[:h], q_val[:h], staged)
            reps = -(-len(q_idx) // h)
            return (np.concatenate([ids] * reps)[:len(q_idx)],
                    np.concatenate([scores] * reps)[:len(q_idx)], spans)
        System.query = query
    """,
}


def run_cell(cell: str, seed: int = 7, trace: int = 0, seconds: float = 1.0,
             extra=(), fault: str = None, cwd: Path = ROOT,
             prelude: str = ""):
    """Run one cell tiny on the CPU; returns (returncode, last stdout line
    as JSON or None, stderr).  ``fault`` names a planted fault of
    :data:`FAULTS`; ``prelude`` is more Python run before ``run.main``."""
    args = ["--workload", cell, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", str(trace), "--device", "cpu"]
    for s in TINY.get(cell, ()):
        args += ["--set", s]
    args += list(extra)
    prelude = (textwrap.dedent(FAULTS[fault]) if fault else "") \
        + textwrap.dedent(prelude)
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(cwd / 'src')!r}, {str(cwd / 'bench')!r}]
        import numpy as np
        from benchlib.system import System
    """) + prelude + textwrap.dedent(f"""
        import run
        sys.exit(run.main({args!r}))
    """)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    last = json.loads(lines[-1]) if lines else None
    return proc.returncode, last, proc.stderr

