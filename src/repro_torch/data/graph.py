"""Graph data substrate, as ``repro.data.graph``: synthetic geometric graphs
matched to the GNN shape cells, batched small molecules, and a real fanout
neighbor sampler (minibatch_lg requires one).

The numpy Philox draws are the reference's, so every array equals its bit
for bit; each function returns a :class:`GraphBatch` of numpy arrays, and
:func:`to_device` puts one on a device as tensors.

All graphs are self-loop-free: eSCN edge frames are undefined for zero-length
edge vectors (standard geometric-GNN convention).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.models.gnn import GraphBatch


def to_device(g: GraphBatch, device=None) -> GraphBatch:
    """``g``'s arrays as tensors on ``device`` (None: the CUDA card), dtypes
    kept; ``n_graphs`` stays an int."""
    dev = resolve_device(device)
    return g._replace(**{
        k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
        for k, v in g._asdict().items() if k != "n_graphs"})


def _pad_to(x: np.ndarray, n: int, fill) -> np.ndarray:
    out = np.full((n,) + x.shape[1:], fill, x.dtype)
    out[: len(x)] = x
    return out


def random_geometric_graph(seed: int, n_nodes: int, n_edges: int,
                           d_feat: int, n_classes: int,
                           pad_nodes: int = 0, pad_edges: int = 0
                           ) -> GraphBatch:
    """Random positions in a box; random non-self edges; class labels."""
    gen = np.random.Generator(np.random.Philox(key=seed))
    pos = gen.normal(0, 1, (n_nodes, 3)).astype(np.float32)
    src = gen.integers(0, n_nodes, n_edges)
    dst = (src + gen.integers(1, n_nodes, n_edges)) % n_nodes   # no self loops
    vec = (pos[src] - pos[dst]).astype(np.float32)
    feat = gen.normal(0, 1, (n_nodes, d_feat)).astype(np.float32)
    labels = gen.integers(0, n_classes, n_nodes).astype(np.int32)
    pn = max(pad_nodes, n_nodes)
    pe = max(pad_edges, n_edges)
    return GraphBatch(
        node_feat=_pad_to(feat, pn, 0.0),
        edge_src=_pad_to(src.astype(np.int32), pe, -1),
        edge_dst=_pad_to(dst.astype(np.int32), pe, -1),
        edge_vec=_pad_to(vec, pe, 1.0),
        labels=_pad_to(labels, pn, -1),
        forces=np.zeros((pn, 3), np.float32),
        graph_id=np.zeros(pn, np.int32),
        n_graphs=1,
    )


def molecule_batch(seed: int, batch: int, nodes_per: int, edges_per: int,
                   d_feat: int = 16) -> GraphBatch:
    """Disjoint union of ``batch`` small molecules with energy/force targets."""
    gen = np.random.Generator(np.random.Philox(key=seed))
    N = batch * nodes_per
    E = batch * edges_per
    pos = gen.normal(0, 1, (N, 3)).astype(np.float32)
    src = np.zeros(E, np.int64)
    dst = np.zeros(E, np.int64)
    for b in range(batch):
        lo = b * nodes_per
        s = gen.integers(0, nodes_per, edges_per)
        d = (s + gen.integers(1, nodes_per, edges_per)) % nodes_per
        src[b * edges_per:(b + 1) * edges_per] = lo + s
        dst[b * edges_per:(b + 1) * edges_per] = lo + d
    vec = (pos[src] - pos[dst]).astype(np.float32)
    feat = gen.normal(0, 1, (N, d_feat)).astype(np.float32)
    energy = gen.normal(0, 1, batch).astype(np.float32)
    forces = gen.normal(0, 0.1, (N, 3)).astype(np.float32)
    graph_id = np.repeat(np.arange(batch, dtype=np.int32), nodes_per)
    return GraphBatch(
        node_feat=feat,
        edge_src=src.astype(np.int32), edge_dst=dst.astype(np.int32),
        edge_vec=vec, labels=energy, forces=forces,
        graph_id=graph_id, n_graphs=batch,
    )


class NeighborSampler:
    """Uniform fanout sampling from a CSR adjacency (GraphSAGE-style).

    ``sample(seeds, fanouts)`` returns a padded GraphBatch over the union of
    sampled nodes with edges pointing child → parent (messages flow toward
    the seed nodes), exactly the minibatch_lg training regime.
    """

    def __init__(self, seed: int, n_nodes: int, edges: np.ndarray,
                 feats: np.ndarray, labels: np.ndarray,
                 positions: np.ndarray | None = None):
        self.gen = np.random.Generator(np.random.Philox(key=seed))
        self.n = n_nodes
        src, dst = edges
        order = np.argsort(dst, kind="stable")
        self._nbr = src[order]
        self._off = np.zeros(n_nodes + 1, np.int64)
        np.add.at(self._off, dst + 1, 1)
        self._off = np.cumsum(self._off)
        self.feats = feats
        self.labels = labels
        self.pos = (positions if positions is not None
                    else self.gen.normal(0, 1, (n_nodes, 3)).astype(np.float32))

    def _sample_neighbors(self, nodes: np.ndarray, fanout: int):
        src_out, dst_out = [], []
        for v in nodes:
            lo, hi = self._off[v], self._off[v + 1]
            if hi == lo:
                continue
            picks = self._nbr[self.gen.integers(lo, hi, fanout)]
            picks = picks[picks != v]
            src_out.append(picks)
            dst_out.append(np.full(len(picks), v, np.int64))
        if not src_out:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return np.concatenate(src_out), np.concatenate(dst_out)

    def sample(self, seeds: np.ndarray, fanouts: Sequence[int],
               pad_nodes: int, pad_edges: int) -> GraphBatch:
        frontier = np.asarray(seeds, np.int64)
        all_src, all_dst = [], []
        seen = set(frontier.tolist())
        for f in fanouts:
            s, d = self._sample_neighbors(frontier, f)
            all_src.append(s)
            all_dst.append(d)
            new = sorted(set(s.tolist()) - seen)
            seen.update(new)
            frontier = np.asarray(new, np.int64)
            if frontier.size == 0:
                break
        src = np.concatenate(all_src) if all_src else np.zeros(0, np.int64)
        dst = np.concatenate(all_dst) if all_dst else np.zeros(0, np.int64)
        nodes = np.asarray(sorted(seen), np.int64)
        remap = {int(v): i for i, v in enumerate(nodes)}
        ls = np.array([remap[int(v)] for v in src], np.int64) if src.size else src
        ld = np.array([remap[int(v)] for v in dst], np.int64) if dst.size else dst
        vec = (self.pos[src] - self.pos[dst]).astype(np.float32) \
            if src.size else np.zeros((0, 3), np.float32)
        labels = np.full(len(nodes), -1, np.int32)
        seed_local = [remap[int(v)] for v in seeds if int(v) in remap]
        labels[seed_local] = self.labels[np.asarray(seeds)[
            [i for i, v in enumerate(seeds) if int(v) in remap]]]
        ls = ls[:pad_edges]; ld = ld[:pad_edges]; vec = vec[:pad_edges]
        return GraphBatch(
            node_feat=_pad_to(self.feats[nodes].astype(np.float32), pad_nodes, 0.0),
            edge_src=_pad_to(ls.astype(np.int32), pad_edges, -1),
            edge_dst=_pad_to(ld.astype(np.int32), pad_edges, -1),
            edge_vec=_pad_to(vec, pad_edges, 1.0),
            labels=_pad_to(labels, pad_nodes, -1),
            forces=np.zeros((pad_nodes, 3), np.float32),
            graph_id=np.zeros(pad_nodes, np.int32),
            n_graphs=1,
        )
