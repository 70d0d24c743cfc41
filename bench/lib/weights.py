"""Random weights from the seed, made on the card in the served dtype.

One ``torch.Generator`` on the device, one draw per stacked tensor (all
layers at once), in the order of the family's layout (its ``shapes``), so
a seed always gives the same weights.  The reference reads them by the
layout's names, and the family's ``program.params`` hands the program
views of the same tensors in its layout.
"""
from __future__ import annotations

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from any whole number (taken modulo
    2**63, so large and negative seeds work)."""
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


@torch.no_grad()
def make(shapes: dict, dtype: str, seed: int, device) -> dict[str, torch.Tensor]:
    """``shapes``: name -> (shape, kind, std); kind "w" is drawn in
    ``dtype``, "f32" in float32, "norm" in float32 as 1 + N(0, std)."""
    g = generator(seed, device)
    wdt = DTYPES[dtype]
    out = {}
    for name, (shape, kind, std) in shapes.items():
        dt = wdt if kind == "w" else torch.float32
        t = torch.randn(shape, generator=g, device=device, dtype=dt).mul_(std)
        if kind == "norm":
            t.add_(1.0)
        out[name] = t
    return out
