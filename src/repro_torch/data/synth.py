"""Synthetic sparse-vector datasets (paper §6.1.1 and §6.5).

The paper evaluates on MS MARCO encoded by BM25 / SPLADE / Efficient-SPLADE /
uniCOIL, plus fully synthetic real-valued collections G_100 / G_200.  Offline
we reproduce the *statistical shape* of each collection (Table 3 + Figure 6):

  * value distribution of non-zero entries (uniform / gaussian / zeta / lognormal)
  * activation law: which coordinates are active (uniform Bernoulli for the
    synthetic sets; Zipf-tilted for the text-like sets, matching Fig. 6(b))
  * ψ_d / ψ_q : mean non-zeros per document / query (Table 3)

Everything is deterministic in the seed and generated in NumPy (host data
pipeline), streamed in padded (idx, val) batches.

This module is a draw-identical copy of ``repro.data.synth``: the same seed
gives the same corpus in both packages, which is how the parity tests feed
one corpus to the JAX reference and to this port.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SparseDatasetSpec:
    name: str
    n: int                  # dimensionality
    psi_doc: int            # mean active coords per document
    psi_query: int          # mean active coords per query
    value_dist: str = "gaussian"   # gaussian | uniform | zeta | lognormal
    value_param: float = 1.0       # σ for gaussian, s for zeta
    nonneg: bool = False           # non-negative collection (Sinnamon+ territory)
    activation: str = "uniform"    # uniform | zipf  (Fig. 6(b) tail shape)
    zipf_a: float = 1.3


# Paper's synthetic real-valued datasets (§6.5, Table 4).
G100 = SparseDatasetSpec("G100", n=10_000, psi_doc=100, psi_query=100,
                         value_dist="gaussian", value_param=1.0)
G200 = SparseDatasetSpec("G200", n=32_000, psi_doc=200, psi_query=200,
                         value_dist="gaussian", value_param=1.0)

# Text-like emulations (Table 3 statistics; vocabulary 30k as in SPLADE).
SPLADE_LIKE = SparseDatasetSpec("splade_like", n=30_000, psi_doc=119,
                                psi_query=43, value_dist="lognormal",
                                value_param=0.6, nonneg=True,
                                activation="zipf")
ESPLADE_LIKE = SparseDatasetSpec("esplade_like", n=30_000, psi_doc=181,
                                 psi_query=6, value_dist="lognormal",
                                 value_param=0.6, nonneg=True,
                                 activation="zipf")
BM25_LIKE = SparseDatasetSpec("bm25_like", n=30_000, psi_doc=39, psi_query=6,
                              value_dist="lognormal", value_param=0.4,
                              nonneg=True, activation="zipf")
UNICOIL_LIKE = SparseDatasetSpec("unicoil_like", n=30_000, psi_doc=68,
                                 psi_query=6, value_dist="lognormal",
                                 value_param=0.5, nonneg=True,
                                 activation="zipf")

DATASETS = {d.name: d for d in
            (G100, G200, SPLADE_LIKE, ESPLADE_LIKE, BM25_LIKE, UNICOIL_LIKE)}


def _coord_weights(spec: SparseDatasetSpec) -> np.ndarray:
    if spec.activation == "uniform":
        return np.full(spec.n, 1.0 / spec.n)
    ranks = np.arange(1, spec.n + 1, dtype=np.float64)
    w = ranks ** (-spec.zipf_a)
    return w / w.sum()


def _draw_values(gen: np.random.Generator, size: int,
                 spec: SparseDatasetSpec) -> np.ndarray:
    if spec.value_dist == "gaussian":
        v = gen.normal(0.0, spec.value_param, size)
    elif spec.value_dist == "uniform":
        v = gen.uniform(-1.0, 1.0, size)
    elif spec.value_dist == "zeta":
        levels = np.linspace(-1.0, 1.0, 1024)
        pmf = np.arange(1, 1025, dtype=np.float64) ** (-spec.value_param)
        pmf /= pmf.sum()
        v = gen.choice(levels, size=size, p=pmf)
    elif spec.value_dist == "lognormal":
        v = gen.lognormal(mean=0.0, sigma=spec.value_param, size=size)
    else:
        raise ValueError(spec.value_dist)
    if spec.nonneg:
        v = np.abs(v)
    # active coordinates are almost-surely non-zero (paper §5 footnote 3)
    v = np.where(v == 0.0, 1e-6, v)
    return v.astype(np.float32)


def sample_sparse_batch(
    seed: int, spec: SparseDatasetSpec, batch: int, psi: int, pad: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Draw ``batch`` sparse vectors with ψ ~ Poisson(psi) active coordinates.

    Returns padded (idx int32[batch, pad], val f32[batch, pad]); pad idx = -1.
    """
    gen = np.random.Generator(np.random.Philox(key=seed))
    weights = _coord_weights(spec)
    idx = np.full((batch, pad), -1, np.int32)
    val = np.zeros((batch, pad), np.float32)
    counts = np.clip(gen.poisson(psi, batch), 1, pad)
    for b in range(batch):
        c = int(counts[b])
        if spec.activation == "uniform":
            coords = gen.choice(spec.n, size=c, replace=False)
        else:
            coords = np.unique(gen.choice(spec.n, size=2 * c, p=weights))
            gen.shuffle(coords)
            coords = coords[:c]
            c = len(coords)
        idx[b, :c] = np.sort(coords)
        val[b, :c] = _draw_values(gen, c, spec)
    return idx, val


def make_corpus(seed: int, spec: SparseDatasetSpec, n_docs: int,
                pad: int | None = None):
    pad = pad or int(2.5 * spec.psi_doc)
    return sample_sparse_batch(seed, spec, n_docs, spec.psi_doc, pad)


def make_queries(seed: int, spec: SparseDatasetSpec, n_queries: int,
                 pad: int | None = None):
    pad = pad or int(2.5 * spec.psi_query)
    return sample_sparse_batch(seed ^ 0x5EED, spec, n_queries,
                               spec.psi_query, pad)


class StreamingFeed:
    """Infinite shuffled stream of (id, idx, val) insert events plus deletes.

    Models the paper's §6.4 protocol: sequential inserts of a shuffled corpus,
    optionally interleaved with random deletions of live documents.
    """

    def __init__(self, seed: int, spec: SparseDatasetSpec, pad: int,
                 delete_ratio: float = 0.0):
        self.gen = np.random.Generator(np.random.Philox(key=seed))
        self.spec = spec
        self.pad = pad
        self.delete_ratio = delete_ratio
        self._next_id = 0
        self._live: list[int] = []

    def events(self, count: int) -> Iterator[tuple]:
        for _ in range(count):
            if (self._live and self.delete_ratio > 0
                    and self.gen.random() < self.delete_ratio):
                pos = self.gen.integers(len(self._live))
                doc = self._live.pop(int(pos))
                yield ("delete", doc, None, None)
            else:
                idx, val = sample_sparse_batch(
                    int(self.gen.integers(2 ** 31)), self.spec, 1,
                    self.spec.psi_doc, self.pad)
                doc = self._next_id
                self._next_id += 1
                self._live.append(doc)
                yield ("insert", doc, idx[0], val[0])
