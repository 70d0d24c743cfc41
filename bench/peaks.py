"""Datasheet peaks of the cards the benchmark runs on (NVIDIA's H100
datasheet, https://www.nvidia.com/en-us/data-center/h100/: dense rates,
without sparsity), keyed by the name ``torch.cuda.get_device_name`` gives.
A frozen copy of the numbers in the program's ``launch/roofline.PEAKS``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Peaks:
    bf16: float      # tensor-core FLOP/s, bf16 and fp16
    fp32: float      # FLOP/s outside the tensor cores
    hbm: float       # device memory bytes/s


_PEAKS = {
    "H100 SXM": Peaks(bf16=989e12, fp32=67e12, hbm=3.35e12),
    "H100 PCIe": Peaks(bf16=756e12, fp32=51e12, hbm=2.0e12),
    "H100 NVL": Peaks(bf16=835e12, fp32=60e12, hbm=3.9e12),
}


def for_device(name: str) -> Peaks:
    """The peaks of a card by its name; an H100 that names no other form
    is the SXM part (``NVIDIA H100 80GB HBM3``)."""
    if "H100" not in name:
        raise ValueError(f"no datasheet peaks for {name!r}")
    if "PCIe" in name:
        return _PEAKS["H100 PCIe"]
    if "NVL" in name:
        return _PEAKS["H100 NVL"]
    return _PEAKS["H100 SXM"]
