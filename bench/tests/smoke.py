"""Smoke-size stand-ins of the cells, for the CPU tests: every width of a
configuration cut to a few, float32, and each mix's lengths and calls cut
to what a CPU runs in seconds.  The code paths are the cells' own."""
from __future__ import annotations

import dataclasses

from bench.lib import family, manifest, traffic


def family_of(config: str) -> family.Family:
    """``bench/configs/<config>.json``'s family, at smoke widths."""
    fam = family.load(manifest.ROOT / "bench" / "configs" / f"{config}.json")
    a = fam.arch
    return dataclasses.replace(fam, arch=dataclasses.replace(
        a, layers=2, d=64, heads=4, kv_heads=4 if a.kv_heads == a.heads else 2, d_ff=128,
        vocab=512, dtype="float32"))


def mix(cell: dict) -> traffic.Mix:
    m = traffic.load(manifest.ROOT / "bench" / "traffic" / f"{cell['traffic']}.json")
    raw = dict(m.raw)
    raw["prompt_tokens"] = dict(raw["prompt_tokens"], median=150, min=128, max=200, block=8)
    raw.update(table_rows=56, warm_rows=8)
    if raw["entry"] == "sem_map":
        raw.update(rows_per_call=8, max_new_tokens=6, engine={"max_slots": 4, "max_seq": 256},
                   check={"held": 2, "drawn": 2})
    else:
        raw.update(rows_per_call=16, engine={"max_seq": 256, "batch": 8}, check={"rows": 6})
    return traffic.Mix(m.name, raw)
