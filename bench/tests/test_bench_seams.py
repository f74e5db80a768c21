"""The files a cell names are found by name: the data's value and
activation laws, the mix's loop and the configuration's reference.  A
name with no file fails at set-up, naming the file looked for; a new
deployment (two laws, a loop that writes, a reference that replays the
writes, a configuration and a mix) comes as new files and appended
entries only, and runs to ``correct``; and the system's delete takes a
document out of every later answer."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from benchtest import BENCH, ROOT, run_cell  # noqa: E402

for _p in (str(BENCH), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)
from benchlib import data as bdata  # noqa: E402

CELL = "msmarco-splade.query_b256"


@pytest.mark.parametrize("key, value, looked_for", [
    ("config.data.value_law", "nope", "laws/values/nope.py"),
    ("config.data.activation", "nope", "laws/activations/nope.py"),
    ("traffic.loop", "nope", "loops/nope.py"),
    ("config.reference", "bench/reference/nope.py", "reference/nope.py"),
])
def test_unknown_name_fails_at_set_up(key, value, looked_for):
    import run
    argv = ["--workload", CELL, "--seed", "1", "--seconds", "1",
            "--device", "cpu", "--set", f"{key}={json.dumps(value)}"]
    with pytest.raises(FileNotFoundError, match=looked_for):
        run.main(argv)


# -- a new deployment as new files only ---------------------------------------

SIGNED_LAW = '''
"""N(0, value_sigma) values, either sign; an exact 0 becomes 1e-6."""
import torch
from benchlib import data as bdata


def values(gen, shape, data, device):
    v = float(data["value_sigma"]) * bdata.normal(gen, shape, device)
    return torch.where(v == 0, 1e-6, v)
'''

UNIFORM_LAW = '''
"""Every coordinate equally likely."""
import torch


def cdf(data, device):
    n = int(data["n"])
    return torch.arange(1, n + 1, dtype=torch.float64, device=device) / n
'''

FEED_LOOP = '''
"""Closed loop that inserts ``feed_docs`` documents of its own feed (the
stream "feed", one chunk a batch) before each query batch, for the first
``feed_batches`` steps, and records them in ``Step.writes``."""
import time

from benchlib import data as bdata
from benchlib.loop import Step, Write, call


class Loop:
    def __init__(self, system, traffic, queries, trace, seed=None,
                 cfg=None):
        self.system, self.seed, self.data = system, seed, cfg["data"]
        self.q_idx, self.q_val = queries
        self.feed_docs = int(traffic["feed_docs"])
        self.feed_batches = int(traffic["feed_batches"])
        self.cdf = bdata.activation_cdf(self.data, system.device)
        self.steps = []

    def _write(self, st, numbers, idx, val):
        call(st, self.system.insert, bdata.doc_id(numbers).cpu(), idx, val)

    def step(self, phase):
        s = len(self.steps)
        st = Step(phase)
        st.t0 = time.perf_counter()
        if s < self.feed_batches:
            lo = int(self.data["docs"]) + s * self.feed_docs
            numbers, idx, val = bdata.doc_rows(
                self.seed, "feed", s, lo, lo + self.feed_docs, self.data,
                self.cdf, self.system.device)
            self._write(st, numbers, idx, val)
            st.writes.append(Write("insert", numbers.cpu()))
        st.query_batch = s % self.q_idx.shape[0]
        t = time.perf_counter()
        res = call(st, self.system.query, self.q_idx[st.query_batch],
                   self.q_val[st.query_batch])
        st.query_ms = (time.perf_counter() - t) * 1e3
        if res is not None:
            st.ids, st.scores, st.spans = res
        st.t1 = time.perf_counter()
        self.steps.append(st)
        return st

    def run(self, seconds):
        t_start = time.perf_counter()
        while True:
            self.step("window")
            if self.steps[-1].t1 >= t_start + seconds:
                break
        return t_start, self.steps[-1].t1

    def window(self):
        return [s for s in self.steps if s.phase == "window"]
'''

REPLAY_REFERENCE = '''
"""The plain reference of ``sinnamon.py``, replaying each step's inserts
(redrawn from the feed's stream) before the steps it judges."""
from benchlib import data as bdata
from reference.sinnamon import RefIndex, mappings  # noqa: F401


def states(cfg, seed, device, steps, judged, cell_dtype=None,
           store_dtype=None):
    data = cfg["data"]
    docs = int(data["docs"])
    top = max([docs] + [int(w.numbers.max()) + 1 for st in steps
                        for w in st.writes])
    ref = RefIndex(cfg["index"], device, top, cell_dtype, store_dtype)
    cdf = bdata.activation_cdf(data, device)
    for c in range(bdata.n_chunks(data)):
        numbers, idx, val = bdata.corpus_chunk(seed, data, c, cdf, device)
        ref.insert(numbers, bdata.doc_id(numbers), idx, val)
    for i, st in enumerate(steps):
        for w in st.writes:
            assert w.op == "insert"
            lo, hi = int(w.numbers[0]), int(w.numbers[-1]) + 1
            chunk = (lo - docs) // len(w.numbers)
            numbers, idx, val = bdata.doc_rows(seed, "feed", chunk, lo, hi,
                                               data, cdf, device)
            ref.insert(numbers, bdata.doc_id(numbers), idx, val)
        if i in judged:
            yield [i], ref
'''

#: The planted fault: the loop records its inserts but never makes them.
WRITES_DROPPED = """
    from benchlib import spec as bspec
    bspec.loop("feed_test")._write = lambda self, st, numbers, idx, val: None
"""


def _new_deployment(root: Path) -> None:
    """Add a configuration of signed, uniformly active vectors, its mix,
    two laws, a loop that writes and a reference that replays the writes,
    as new files and appended entries in ``BENCHMARK.json``."""
    bench = root / "bench"
    (bench / "laws" / "values" / "signed_test.py").write_text(SIGNED_LAW)
    (bench / "laws" / "activations" / "uniform_test.py").write_text(
        UNIFORM_LAW)
    (bench / "loops" / "feed_test.py").write_text(FEED_LOOP)
    (bench / "reference" / "feed_test.py").write_text(REPLAY_REFERENCE)
    cfg = json.loads((bench / "configs" / "msmarco-splade.json").read_text())
    cfg["name"] = "signed-test"
    cfg["reference"] = "bench/reference/feed_test.py"
    cfg["index"]["capacity"] = 6144
    cfg["serving"]["kprime"] = 100
    cfg["data"].update(docs=3000, psi_doc=100, psi_query=43,
                       value_law="signed_test", value_sigma=1.0,
                       nonneg=False, activation="uniform_test")
    del cfg["data"]["zipf_a"]
    (bench / "configs" / "signed-test.json").write_text(json.dumps(cfg))
    mix = {"why": "a test", "loop": "feed_test", "query_batch": 8,
           "query_pool_batches": 4, "warmup_steps": 2, "feed_docs": 64,
           "feed_batches": 40,
           "check": {"steps": 4, "queries_per_step": 8}}
    (bench / "traffic" / "feed_test.json").write_text(json.dumps(mix))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "signed-test", "source": "a test",
                            "file": "bench/configs/signed-test.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "signed-test.feed_test",
                              "config": "signed-test",
                              "traffic": "feed_test", "chips": 1,
                              "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


def test_new_deployment_needs_only_new_files(tmp_path):
    root = tmp_path / "repo"
    shutil.copytree(BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    (root / "src").symlink_to(ROOT / "src", target_is_directory=True)
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*")
              if p.is_file()}
    spec_before = json.loads((root / "BENCHMARK.json").read_text())
    _new_deployment(root)

    rc, line, err = run_cell("signed-test.feed_test", seed=2**31 + 41,
                             seconds=0.5, cwd=root)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True, err[-3000:]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert "p95_ms" in line["metrics"] and "setup_s" in line["metrics"]

    rc, line, err = run_cell("signed-test.feed_test", seed=2**31 + 41,
                             seconds=0.5, cwd=root, prelude=WRITES_DROPPED)
    assert rc == 0, err[-3000:]
    assert line["correct"] is False
    assert line["checks"]["rank_faults"]["value"] > 0

    for p, body in before.items():
        assert p.read_bytes() == body, p
    spec_after = json.loads((root / "BENCHMARK.json").read_text())
    for key, entries in spec_before.items():
        if isinstance(entries, list):
            assert spec_after[key][:len(entries)] == entries, key
        else:
            assert spec_after[key] == entries, key


def test_signed_law_draws_both_signs():
    """The lower half of the sketch needs negative values: the signed law
    draws about as many as positive ones, and no zero."""
    import importlib.util
    spec = importlib.util.spec_from_loader("signed_test", loader=None)
    mod = importlib.util.module_from_spec(spec)
    exec(SIGNED_LAW, mod.__dict__)
    data = {"n": 500, "value_sigma": 1.0}
    gen = bdata.generator(5, "corpus", 0, "cpu")
    v = mod.values(gen, (2000, 16), data, "cpu")
    assert float((v < 0).float().mean()) == pytest.approx(0.5, abs=0.02)
    assert bool((v != 0).all())


# -- the system's delete --------------------------------------------------------

def test_deleted_id_is_never_served():
    from benchlib.system import System
    cfg = json.loads((BENCH / "configs" / "msmarco-splade.json").read_text())
    cfg["index"]["capacity"] = 1024
    cfg["serving"]["kprime"] = 50
    data = dict(cfg["data"], docs=1000)
    system = System(cfg, "cpu")
    cdf = bdata.activation_cdf(data, "cpu")
    numbers, idx, val = bdata.corpus_chunk(2**31 + 3, data, 0, cdf, "cpu")
    ids = bdata.doc_id(numbers)
    system.insert(ids, idx, val)
    q_idx, q_val = bdata.query_pool(2**31 + 3, data, 1, 8, cdf, "cpu")
    served, _, _ = system.query(q_idx[0], q_val[0])
    gone = np.unique(served[:, :3])
    gone = gone[gone >= 0]
    system.delete(torch.as_tensor(gone))
    after, scores, _ = system.query(q_idx[0], q_val[0])
    assert not np.isin(after, gone).any()
    assert bool((after >= 0).all())
    with pytest.raises(KeyError):
        system.delete([int(gone[0])])
    # the id comes back when it is inserted again
    row = int(np.flatnonzero(ids.numpy() == gone[0])[0])
    system.insert(ids[row:row + 1], idx[row:row + 1], val[row:row + 1])
    again, _, _ = system.query(q_idx[0], q_val[0])
    assert np.isin(again, gone[:1]).any()
    system.close()
