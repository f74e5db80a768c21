"""Models of the port: the LM family (``models.transformer`` over
``models.layers``), the recsys family (``models.recsys``: DLRM, DIN,
SASRec, MIND), served and trained, and the GNN family (``models.gnn`` over
``models.sh``: EquiformerV2), trained."""

import torch


def tree_leaves(module, grad: bool = False) -> dict:
    """{reference leaf path: tensor} of a model's parameters in the
    reference's tree order (JAX flattens a dict by sorted keys at each
    level): ``a.b`` becomes ``a/b``.  With ``grad``, each parameter's
    ``.grad`` (zeros where it has none)."""
    out = {}
    for name, p in module.named_parameters():
        t = p
        if grad:
            t = p.grad if p.grad is not None else torch.zeros_like(p)
        out[name.replace(".", "/")] = t
    return dict(sorted(out.items(), key=lambda kv: kv[0].split("/")))
