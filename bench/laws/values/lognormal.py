"""|lognormal(0, value_sigma)| values: the exp of a normal draw, positive,
so a configuration that draws them states ``nonneg``; a draw that
underflows to 0 becomes 1e-6, since an active coordinate is non-zero."""

from __future__ import annotations

import torch

from benchlib import data as bdata


def values(gen, shape, data: dict, device) -> torch.Tensor:
    if not data["nonneg"]:
        raise ValueError("lognormal values are positive: the configuration "
                         "must state nonneg")
    v = torch.exp(float(data["value_sigma"]) * bdata.normal(gen, shape, device))
    return torch.where(v == 0, 1e-6, v)
