"""N(0, value_sigma) values, either sign: value_sigma times a standard
normal draw (``benchlib.data.normal``).  A configuration that draws them
cannot state ``nonneg``; a draw that is exactly 0 becomes 1e-6, since an
active coordinate is non-zero."""

from __future__ import annotations

import torch

from benchlib import data as bdata


def values(gen, shape, data: dict, device) -> torch.Tensor:
    if data["nonneg"]:
        raise ValueError("normal values take either sign: the configuration "
                         "must not state nonneg")
    v = float(data["value_sigma"]) * bdata.normal(gen, shape, device)
    return torch.where(v == 0, 1e-6, v)
