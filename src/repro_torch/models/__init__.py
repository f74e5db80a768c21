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


def param_axes(module, axes: dict) -> dict:
    """{parameter name: logical axes} of a model from its family's
    ``logical_axes`` tree (``repro_torch.distributed.rules.flat_axes``
    paths), paired through ``module.leaves()``: a leaf that is a parameter
    takes its axes as they are, a leaf that is a transposed view of one
    (DLRM's ``bot/w{i}`` of an ``nn.Linear`` weight) takes them reversed,
    so that each placement follows its dimension."""
    from repro_torch.distributed.rules import L, flat_axes

    flat = flat_axes(axes)
    by_id = {id(p): n for n, p in module.named_parameters()}
    out = {}
    for path, t in module.leaves().items():
        ax = flat[path]
        if id(t) in by_id:
            out[by_id[id(t)]] = ax
        elif t._base is not None and id(t._base) in by_id and t.dim() == 2:
            out[by_id[id(t._base)]] = L(*reversed(ax.axes))
        else:
            raise ValueError(f"leaf {path!r} is no parameter or transposed "
                             "parameter of the model")
    if len(out) != len(by_id):
        raise ValueError("the logical axes do not cover every parameter")
    return out
