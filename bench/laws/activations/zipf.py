"""Zipf(zipf_a) activation: coordinate r (0-based, in rank order) is drawn
with probability proportional to (r + 1) ** -zipf_a."""

from __future__ import annotations

import torch


def cdf(data: dict, device) -> torch.Tensor:
    w = torch.arange(1, int(data["n"]) + 1, dtype=torch.float64,
                     device=device) ** -float(data["zipf_a"])
    return torch.cumsum(w / w.sum(), 0)
