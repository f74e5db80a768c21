"""equiformer-v2 [gnn] — equivariant graph attention via eSCN SO(2)
convolutions [arXiv:2306.12059; unverified]."""
import dataclasses

from repro_torch.configs.common import GNN_SHAPES as SHAPES  # noqa: F401
from repro_torch.models.gnn import GNNConfig

ARCH = "equiformer-v2"
FAMILY = "gnn"


def full_config(shape: dict | None = None) -> GNNConfig:
    cfg = GNNConfig(
        name=ARCH, n_layers=12, c=128, l_max=6, m_max=2, n_heads=8,
        n_rbf=32, f_in=100, n_out=47, task="node_class", edge_chunk=65536)
    if shape:
        cfg = dataclasses.replace(
            cfg, f_in=shape["d_feat"],
            n_out=shape["n_classes"] if shape["task"] == "node_class" else 1,
            task=shape["task"], edge_chunk=shape["edge_chunk"])
    return cfg


def smoke_config() -> GNNConfig:
    return GNNConfig(
        name=ARCH + "-smoke", n_layers=2, c=16, l_max=3, m_max=2, n_heads=4,
        n_rbf=8, f_in=12, n_out=5, task="node_class", edge_chunk=64)
