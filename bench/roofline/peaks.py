"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheet, SXM part, dense rates, at the full 700 W power limit), looked up
by the name ``torch.cuda.get_device_name()`` gives."""

from __future__ import annotations

#: name fragment -> peaks
PEAKS = {
    "H100": {"hbm_bytes_per_s": 3.35e12, "f32_flops": 67e12,
             "tf32_flops": 495e12, "bf16_flops": 989e12,
             "memory_bytes": 80e9},
}


def peaks(device_kind: str):
    """The peaks of a card, or None for a card not in the table."""
    for frag, p in PEAKS.items():
        if frag in (device_kind or ""):
            return p
    return None


def least_seconds(nbytes: float, f32_ops: float, device_kind: str):
    """The least time a piece of work can take on the card: the larger of
    its bytes over peak bandwidth and its f32 operations over the f32
    peak outside the tensor cores; None for an unknown card."""
    p = peaks(device_kind)
    if p is None:
        return None
    return max(nbytes / p["hbm_bytes_per_s"], f32_ops / p["f32_flops"])
