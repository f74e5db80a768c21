"""The generator of the cells' inputs: exactly ψ distinct coordinates a
row, drawn without replacement from the activation law, the same on every
call of one seed."""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import torch
from scipy.stats import poisson

sys.path.insert(0, str(Path(__file__).resolve().parent))
from benchtest import BENCH  # noqa: E402

sys.path.insert(0, str(BENCH))
from benchlib import data as bdata  # noqa: E402

DATA = {"n": 30000, "activation": "zipf", "zipf_a": 1.3,
        "value_law": "lognormal", "value_sigma": 0.6, "nonneg": True}


#: sha256 of the tiny cell's draws (see the test below), as the harness
#: drew them before the laws became files of their own.
DRAWS_SHA256 = \
    "6a7a83a627403d9eec5273c4e8fa7a7c0664b2ff2178261f4ff97683695ce0e8"


def _draw(data, rows, psi, pad, seed=3):
    cdf = bdata.activation_cdf(data, "cpu")
    gen = bdata.generator(seed, "corpus", 0, "cpu")
    return bdata.draw_sparse(gen, rows, psi, pad, cdf, data, "cpu")


def test_rows_hold_the_drawn_count_of_distinct_coordinates():
    idx, val = _draw(DATA, 4000, 119, 128)
    ok = idx >= 0
    nnz = ok.sum(1)
    # sorted, distinct, padding last, values only where a coordinate is
    assert bool((ok[:, 1:] <= ok[:, :-1]).all())
    later = ok[:, 1:]
    assert bool((idx[:, 1:][later] > idx[:, :-1][later]).all())
    assert bool((val[ok] > 0).all()) and bool((val[~ok] == 0).all())
    assert int(nnz.min()) >= 1 and int(nnz.max()) == 128
    # the mean is that of Poisson(119) clipped to [1, 128]: 117.71
    k = np.arange(400)
    want = float((poisson.pmf(k, 119) * np.clip(k, 1, 128)).sum())
    assert abs(float(nnz.float().mean()) - want) < 1.0


def test_same_seed_same_rows():
    a = _draw(DATA, 500, 43, 64, seed=2**31 + 5)
    b = _draw(DATA, 500, 43, 64, seed=2**31 + 5)
    c = _draw(DATA, 500, 43, 64, seed=2**31 + 6)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])


def test_law_is_sampling_without_replacement():
    """Over 20 coordinates, 5 a row (so rows often need a second round of
    draws), each coordinate's share of the rows matches Gumbel-top-5 of
    the Zipf law."""
    data = dict(DATA, n=20)
    rows = 60_000
    idx, _ = _draw(data, rows, 1000, 5)
    assert bool(((idx >= 0).sum(1) == 5).all())
    got = torch.bincount(idx.flatten().long(), minlength=20).numpy() / rows
    w = np.arange(1, 21) ** -1.3
    keys = -np.log(np.random.default_rng(0).random((rows, 20))) / (w / w.sum())
    top = np.argsort(keys, 1)[:, :5]
    want = np.bincount(top.ravel(), minlength=20) / rows
    np.testing.assert_allclose(got, want, atol=0.012)


def test_draws_are_pinned(monkeypatch):
    """Corpus chunks 0 and 1 and the query pool of ``msmarco-splade``'s
    data block at the CPU tests' tiny size (3,000 documents in chunks of
    1,500; 4 batches of 8 queries), bit for bit as they were drawn when
    the value and activation laws lived in ``benchlib/data.py``: the same
    generator calls in the same order, so the system's corpus, the query
    pool and the reference's redraw all stay the same."""
    cfg = json.loads((BENCH / "configs" / "msmarco-splade.json").read_text())
    data = dict(cfg["data"], docs=3000)
    monkeypatch.setattr(bdata, "CHUNK_DOCS", 1500)
    assert bdata.n_chunks(data) == 2
    h = hashlib.sha256()
    cdf = bdata.activation_cdf(data, "cpu")
    for c in (0, 1):
        for t in bdata.corpus_chunk(2**31 + 7, data, c, cdf, "cpu"):
            h.update(t.contiguous().numpy().tobytes())
    for t in bdata.query_pool(2**31 + 7, data, 4, 8, cdf, "cpu"):
        h.update(t.contiguous().numpy().tobytes())
    assert h.hexdigest() == DRAWS_SHA256
