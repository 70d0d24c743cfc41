"""sem_map & sem_extract (§2.3, §4.2): row-wise natural-language projection.

sem_map generates an arbitrary text attribute; sem_extract restricts the
output to substrings of the source text (entity extraction / verified quotes
— generations that do not appear verbatim in the source are snapped to the
closest matching source span or dropped).
"""
from __future__ import annotations

import difflib
import re

from repro_torch.core import accounting
from repro_torch.core.langex import as_langex

MAP_INSTRUCTION = "Task: {task}\nInput: {item}\nAnswer concisely.\nAnswer:"
EXTRACT_INSTRUCTION = ("Task: {task}\nSource text: {item}\n"
                       "Answer ONLY with an exact snippet copied from the source text.\nAnswer:")
FUSED_MAP_INSTRUCTION = ("Tasks:\n{tasks}\n"
                         "Answer every task, each on its own line as "
                         "'<task number>. <answer>'. Answer concisely.\nAnswers:")
_FUSED_ANSWER_RE = re.compile(r"^\s*(\d+)\s*[.:)]\s*(.*)$")


def sem_map(records: list[dict], langex, model) -> tuple[list[str], dict]:
    lx = as_langex(langex)
    with accounting.track("sem_map") as st:
        prompts = [MAP_INSTRUCTION.format(task=lx.template, item=lx.render(t))
                   for t in records]
        return model.generate(prompts), st.as_dict()


def sem_map_fused(records: list[dict], langexes, model
                  ) -> tuple[list[list[str]], dict]:
    """K consecutive sem_maps over the same input in ONE prompt pass: a single
    generate call per record asks all K tasks as a numbered list and the
    numbered answer lines are parsed back out (lines that fail to parse fall
    back to the whole generation, so a weak model degrades to duplicated
    rather than missing columns).  Returns (columns [K][N], stats)."""
    lxs = [as_langex(l) for l in langexes]
    with accounting.track("sem_map_fused") as st:
        prompts = []
        for t in records:
            tasks = "\n".join(f"{i + 1}. Task: {lx.template} Input: {lx.render(t)}"
                              for i, lx in enumerate(lxs))
            prompts.append(FUSED_MAP_INSTRUCTION.format(tasks=tasks))
        raw = model.generate(prompts)
        columns = [["" for _ in records] for _ in lxs]
        for n, text in enumerate(raw):
            parsed: dict[int, str] = {}
            for line in str(text).splitlines():
                m = _FUSED_ANSWER_RE.match(line)
                if m and 1 <= int(m.group(1)) <= len(lxs):
                    parsed[int(m.group(1)) - 1] = m.group(2).strip()
            for i in range(len(lxs)):
                columns[i][n] = parsed.get(i, str(text).strip())
        st.details.update(fused=len(lxs))
        return columns, st.as_dict()


def _snap_to_source(answer: str, source: str) -> str:
    """Return the closest matching source substring (verified-quote contract)."""
    if answer and answer in source:
        return answer
    sm = difflib.SequenceMatcher(a=source, b=answer)
    m = sm.find_longest_match(0, len(source), 0, len(answer))
    return source[m.a: m.a + m.size] if m.size > 0 else ""


def sem_extract(records: list[dict], langex, model, *, source_field: str
                ) -> tuple[list[str], dict]:
    lx = as_langex(langex)
    with accounting.track("sem_extract") as st:
        prompts = [EXTRACT_INSTRUCTION.format(task=lx.template, item=lx.render(t))
                   for t in records]
        raw = model.generate(prompts)
        snapped = [_snap_to_source(a.strip(), str(t[source_field]))
                   for a, t in zip(raw, records)]
        st.details.update(verbatim=sum(1 for a, t in zip(raw, records)
                                       if a.strip() and a.strip() in str(t[source_field])))
        return snapped, st.as_dict()
