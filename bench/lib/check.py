"""What decides ``correct``: the cell's limits, the sample, the verdict.

After the window has closed and the program's state is freed, the
adapter (``lib/adapter.py``) holds a sample of the window's answers,
drawn from the seed with :func:`sample`, against the family's plain
reference at float32, and returns its numbers; :func:`judge` holds each
to its limit in ``limits/<cell>.json``.
"""
from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

LIMITS = Path(__file__).resolve().parents[1] / "limits"


def limits(cell: str) -> dict:
    return json.loads((LIMITS / f"{cell}.json").read_text())


def sample(ids: list, n: int, seed: int, longest) -> list:
    """``n`` of ``ids`` drawn from the seed, and ``longest`` among them."""
    rng = np.random.default_rng((int(seed) + 0x5EED) % (1 << 64))
    pick = [ids[i] for i in rng.permutation(len(ids))[: max(n - 1, 0)]]
    if longest not in pick:
        pick.append(longest)
    return pick


def judge(numbers: dict, lim: dict) -> tuple[bool, dict]:
    """-> (every number within its limit, {name: {"value", "limit"}}).
    A number that is missing or not finite fails."""
    out = {k: {"value": numbers.get(k, math.inf), "limit": lim[k]["limit"]} for k in lim}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in out.values())
    return ok, out
