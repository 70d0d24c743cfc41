"""The one traffic generator: a table of rows from ``--seed`` and a mix's
parameters (``traffic/<mix>.json``).

Each row's prompt length in tokens (the prompt as the operator frames it,
``frame``, with the row rendered through ``langex``) is drawn from a
log-normal (``median``, ``sigma``) clipped to [``min``, ``max``], each row
on its own.  The lengths come from a generator of their own, seeded with
the mix's ``draw``, and the seed shuffles them only within each block of
``block`` consecutive rows (a batch, or a wave of slots).  So every seed
runs the same batches, of real draws with their own padding, in the same
order of blocks: the same work, in another order within each block, over
other text and weights.  The warm rows (:func:`warm`) span every length
from ``min`` to ``max``, so the warm call meets every shape.

Text is made of words from a fixed list; each field but the ``fill`` one
draws its length in characters (at most half of what the row has left),
and the ``fill`` field takes the rest of the row's length.  Tokens are the
byte tokenizer's (a BOS id, then the UTF-8 bytes), as the program's
``data/tokenizer.py`` defines them.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

BOS = 257
WORDS = ("study", "patients", "reported", "results", "increase", "observed", "trial",
         "dose", "effect", "group", "analysis", "data", "significant", "evidence", "claim",
         "model", "treatment", "response", "rate", "compared", "control", "higher", "lower",
         "cohort", "outcome", "measured", "levels", "risk", "associated", "with", "the", "of",
         "and", "in", "was", "were", "a", "to", "for", "after", "during", "between", "age",
         "years", "clinical", "protein", "gene", "expression", "cells", "tissue", "sample",
         "population", "survey", "city", "river", "founded", "century", "author", "novel",
         "film", "released", "award", "team", "season")


def encode(text: str) -> list[int]:
    return [BOS] + list(text.encode("utf-8"))


@dataclasses.dataclass
class Mix:
    name: str
    raw: dict

    def __getitem__(self, k):
        return self.raw[k]


def load(path: str | Path) -> Mix:
    p = Path(path)
    return Mix(p.stem, json.loads(p.read_text()))


def frame(mix: Mix, row: dict) -> str:
    """The prompt the operator builds from ``row``: the mix's ``frame`` with
    ``{template}`` the langex itself and ``{langex}`` the langex rendered."""
    lx = mix["langex"]
    rendered = lx
    for k, v in row.items():
        rendered = rendered.replace("{" + k + "}", str(v))
    return mix["frame"].replace("{template}", lx).replace("{langex}", rendered)


def lengths(mix: Mix, n: int, rng: np.random.Generator) -> np.ndarray:
    """Target prompt lengths in tokens for ``n`` rows: the mix's own draw,
    shuffled by ``rng`` within each block."""
    p = mix["prompt_tokens"]
    z = np.random.default_rng(int(p["draw"])).standard_normal(n)
    q = np.clip(np.round(p["median"] * np.exp(p["sigma"] * z)), p["min"], p["max"]).astype(np.int64)
    k = int(p["block"])
    for i in range(0, n, k):
        q[i:i + k] = q[i:i + k][rng.permutation(len(q[i:i + k]))]
    return q


def _text(rng: np.random.Generator, chars: int) -> str:
    if chars <= 0:
        return ""
    words = rng.choice(len(WORDS), size=chars // 2 + 1)
    out, size = [], 0
    for w in words:
        out.append(WORDS[w])
        size += len(WORDS[w]) + 1
        if size > chars:
            break
    return " ".join(out)[:chars].rstrip().ljust(chars, ".")


def table(mix: Mix, seed: int, n: int | None = None) -> list[dict]:
    """Rows ``{"id", <fields>...}`` whose framed prompts have the drawn
    lengths; each row also carries ``"tokens"`` (its prompt's token count)."""
    n = int(n or mix["table_rows"])
    rng = np.random.default_rng(int(seed) % (1 << 64))
    return _rows(mix, lengths(mix, n, rng), rng, 0)


def warm(mix: Mix, seed: int) -> list[dict]:
    """``warm_rows`` rows whose lengths run from ``min`` to ``max`` in equal
    ratios, with ids after the table's."""
    p = mix["prompt_tokens"]
    targets = np.round(np.geomspace(p["min"], p["max"], int(mix["warm_rows"]))).astype(np.int64)
    rng = np.random.default_rng([int(seed) % (1 << 64), 1])
    return _rows(mix, targets, rng, int(mix["table_rows"]))


def _rows(mix: Mix, targets: np.ndarray, rng: np.random.Generator, id0: int) -> list[dict]:
    fields = mix["fields"]
    fill = [k for k, v in fields.items() if v == "fill"]
    if len(fill) != 1:
        raise ValueError(f"mix {mix.name}: exactly one field is 'fill'")
    empty = {k: "" for k in fields}
    overhead = len(encode(frame(mix, empty)))
    rows = []
    for i, target in enumerate(targets):
        row = {"id": id0 + i}
        used = overhead
        for k, v in fields.items():
            if v == "fill":
                continue
            lo, hi = v["chars"]
            room = (int(target) - used) // 2     # never more than half of what is left
            row[k] = _text(rng, min(int(rng.integers(lo, hi + 1)), room))
            used += len(row[k])
        row[fill[0]] = _text(rng, max(int(target) - used, 1))
        rows.append(row)
    for row in rows:
        row["tokens"] = len(encode(frame(mix, {k: row[k] for k in fields})))
    return rows


def prompt_ids(mix: Mix, row: dict) -> list[int]:
    return encode(frame(mix, {k: row[k] for k in mix["fields"]}))
