"""Parameterized natural-language expressions ("langex", §2.1 of the paper).

A langex is a natural-language template over tuple attributes, e.g.

    "The {abstract} is about machine learning"                (sem_filter)
    "The paper {abstract:left} uses the {dataset:right}."     (sem_join)
    "the topic of each {paper}"                               (sem_group_by)

``Langex.render`` substitutes attribute values from one tuple (or a left/right
pair for joins).  Prompt *framing* (instructions, output-token contract) is
owned by the operators, not the langex — the langex is pure user intent.
"""
from __future__ import annotations

import dataclasses
import re

_FIELD_RE = re.compile(r"{([^{}:]+)(?::(left|right))?}")


@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    side: str | None  # None | "left" | "right"


@dataclasses.dataclass(frozen=True)
class Langex:
    template: str
    # declared predicate structure: an equivalence predicate ("same entity",
    # "refer to the same X") is symmetric + transitive, so the block-join
    # path may propagate verdicts through transitivity without prompting.
    # Default False: undeclared predicates are only trusted after the
    # calibration-sample structure test (optimizer.blocks.detect_equivalence)
    equivalence: bool = False

    @property
    def fields(self) -> list[Field]:
        return [Field(m.group(1).strip(), m.group(2)) for m in _FIELD_RE.finditer(self.template)]

    @property
    def is_binary(self) -> bool:
        sides = {f.side for f in self.fields}
        return "left" in sides or "right" in sides

    def validate(self, columns, right_columns=None) -> None:
        for f in self.fields:
            cols = right_columns if f.side == "right" else columns
            if cols is not None and f.name not in cols:
                raise KeyError(f"langex field {{{f.name}}} not in columns {sorted(cols)}")

    def render(self, tup: dict, right: dict | None = None) -> str:
        def sub(m: re.Match) -> str:
            name, side = m.group(1).strip(), m.group(2)
            src = right if side == "right" else tup
            if src is None:
                raise ValueError(f"langex field {{{name}:{side}}} needs a right tuple")
            return str(src[name])

        return _FIELD_RE.sub(sub, self.template)


def as_langex(l: "str | Langex") -> Langex:
    return l if isinstance(l, Langex) else Langex(l)
