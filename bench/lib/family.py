"""A configuration file (``configs/<name>.json``) and its family.

The file's ``reference`` key names the family's module,
``bench/reference/<family>.py``: its ``load`` reads the file into the
family's ``Arch``, its ``shapes`` gives the weights' layout and its
``Reference`` computes the plain logits.  The family's cost arithmetic is
``bench/costs/<family>.py`` and its mapping onto the program
``bench/program/<family>.py``.  A new family is these three files.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import re
from pathlib import Path
from types import ModuleType

from bench.lib import weights

ROOT = Path(__file__).resolve().parents[2]


@dataclasses.dataclass(frozen=True)
class Family:
    name: str
    arch: object
    reference: ModuleType
    costs: ModuleType
    program: ModuleType

    def weights(self, seed: int, device) -> dict:
        """The configuration's weights from the seed, on ``device``."""
        return weights.make(self.reference.shapes(self.arch), self.arch.dtype, seed, device)


def load(path: str | Path) -> Family:
    raw = json.loads(Path(path).read_text())
    ref = raw["reference"]
    m = re.fullmatch(r"bench/reference/([A-Za-z0-9_]+)\.py", ref)
    if not m or not (ROOT / ref).is_file():
        raise ValueError(f"{path}: reference {ref!r} is no module under bench/reference/")
    name = m.group(1)
    mods = {k: importlib.import_module(f"bench.{k}.{name}")
            for k in ("reference", "costs", "program")}
    return Family(name=name, arch=mods["reference"].load(raw), **mods)
