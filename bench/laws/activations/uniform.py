"""Uniform activation: every coordinate of the n is equally likely, so the
cumulative law is linear, (r + 1) / n at coordinate r (0-based)."""

from __future__ import annotations

import torch


def cdf(data: dict, device) -> torch.Tensor:
    n = int(data["n"])
    return torch.arange(1, n + 1, dtype=torch.float64, device=device) / n
