"""The table of peaks: a card's memory bandwidth by the name
``torch.cuda.get_device_name`` gives (NVIDIA's data sheet, at the full
power limit)."""
from __future__ import annotations

#: bytes per second of HBM bandwidth
BANDWIDTH = {
    "NVIDIA H100 80GB HBM3": 3.35e12,  # H100 SXM5
}


def bandwidth(kind: str) -> float | None:
    return BANDWIDTH.get(kind)
