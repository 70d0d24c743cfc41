"""sem_agg (§2.3): commutative/associative natural-language reduction.

Gold algorithm: hierarchical reduce — batch tuples into fanout-sized groups,
aggregate each with one model call, recurse until one answer remains (higher
quality than the sequential fold for summarization-like tasks [21] and
embarrassingly parallel per level).  The fold pattern is implemented as the
comparison baseline.  A user ``partitioner`` may override grouping/order
(footnote 4: input order can matter; commutativity is an assumption the
programmer can opt out of).
"""
from __future__ import annotations

from typing import Callable, Sequence

from repro_torch.core import accounting
from repro_torch.core.langex import as_langex

AGG_INSTRUCTION = ("Task: {task}\nInputs:\n{items}\n"
                   "Produce a single combined answer for the task over all inputs.\nAnswer:")


def _agg_prompt(task: str, items: Sequence[str]) -> str:
    body = "\n".join(f"- {t}" for t in items)
    return AGG_INSTRUCTION.format(task=task, items=body)


def sem_agg_hierarchical(records: list[dict], langex, model, *, fanout: int = 8,
                         partitioner: Callable[[list[str]], list[list[str]]] | None = None
                         ) -> tuple[str, dict]:
    lx = as_langex(langex)
    with accounting.track("sem_agg") as st:
        level = [lx.render(t) for t in records]
        depth = 0
        while len(level) > 1 or depth == 0:
            if partitioner is not None and depth == 0:
                groups = partitioner(level)
            else:
                groups = [level[i:i + fanout] for i in range(0, len(level), fanout)]
            prompts = [_agg_prompt(lx.template, g) for g in groups]
            level = model.generate(prompts)
            depth += 1
            if len(groups) == 1:
                break
        st.details.update(depth=depth)
        return level[0], st.as_dict()


def sem_agg_fold(records: list[dict], langex, model) -> tuple[str, dict]:
    """Sequential fold baseline: accumulate a running partial answer."""
    lx = as_langex(langex)
    with accounting.track("sem_agg_fold") as st:
        acc = lx.render(records[0])
        for t in records[1:]:
            acc = model.generate(
                [_agg_prompt(lx.template, [f"(partial answer) {acc}", lx.render(t)])])[0]
        return acc, st.as_dict()
