"""sem_topk (§2.3, §3.4).

Gold algorithm: pairwise LLM comparisons aggregated by quick-select — each
round compares all remaining tuples to one pivot (fully batchable), then
recurses on the side containing rank k; the winning k are then ordered by
recursive quick-sort on the same comparator.

Alternatives implemented for the Table-7 study: quadratic all-pairs (Copeland
count) and a sequential heap top-k.  The reference's partition-parallel
``sem_topk_partitioned`` runs its fragments through the plan layer's
``core.plan.parallel`` and arrives with it.

Optimization (lossless): similarity-guided pivot selection — the first pivot
is the (k+eps)-th item under embedding similarity to the ranking criteria;
under rank/similarity correlation this lands near the true k-boundary and
cuts comparison rounds; an adversarial pivot costs one extra round, never
quality (§3.4).
"""
from __future__ import annotations

import threading

import numpy as np

from repro_torch.core import accounting
from repro_torch.core.langex import as_langex

COMPARE_INSTRUCTION = (
    "Criteria: {criteria}\nOption A: {a}\nOption B: {b}\n"
    "Which option better satisfies the criteria? Answer <A> or <B>.\nAnswer:")


def _render_item(lx, t) -> str:
    return lx.render(t)


def compare_prompt(lx, criteria_text, a, b) -> str:
    return COMPARE_INSTRUCTION.format(criteria=criteria_text, a=a, b=b)


class _Comparator:
    """Batched pairwise comparator with call accounting + cache.

    ``batch`` dedups within the batch before prompting: a repeated ``(i, j)``
    is asked once, and of a symmetric ``(i, j)`` / ``(j, i)`` pair only the
    first-seen orientation reaches the model (the mirror is derived by
    negation — asking both could sample *inconsistent* answers from a noisy
    comparator, and every redundant prompt is a real model call).

    Thread safety (one comparator is shared by the partitioned top-k's
    concurrent fragments): cache lookups and writes are lock-guarded, but
    the model call itself runs OUTSIDE the lock so fragments' compare
    batches genuinely overlap.  Two fragments racing on the same pair may
    both prompt it (the bounded stampede trade, as in BatchedModelCache);
    each writes both orientations atomically under the lock, so the cache
    can never hold an inconsistent (i,j)/(j,i) pair.
    """

    def __init__(self, records, langex, model):
        self.lx = as_langex(langex)
        self.texts = [_render_item(self.lx, t) for t in records]
        self.criteria = self.lx.template
        self.model = model
        self.cache: dict[tuple[int, int], bool] = {}
        self._lock = threading.Lock()

    def batch(self, pairs: list[tuple[int, int]]) -> np.ndarray:
        """pairs (i, j) -> bool[i beats j]."""
        with self._lock:
            todo: list[tuple[int, int]] = []
            queued: set[tuple[int, int]] = set()
            for i, j in pairs:
                if (i, j) in self.cache or (i, j) in queued or (j, i) in queued:
                    continue
                queued.add((i, j))
                todo.append((i, j))
        if todo:
            prompts = [compare_prompt(self.lx, self.criteria,
                                      self.texts[i], self.texts[j])
                       for i, j in todo]
            wins = self.model.compare(prompts)  # unlocked: fragments overlap
            with self._lock:
                for (i, j), w in zip(todo, wins):
                    self.cache[(i, j)] = bool(w)
                    self.cache[(j, i)] = not bool(w)
        with self._lock:
            # every requested pair is now either cached (possibly by a
            # racing fragment) or was in our own todo
            return np.asarray([self.cache[p] for p in pairs], bool)


def _order_topk(cmp: _Comparator, idx: list[int]) -> list[int]:
    """Order a small set by repeated pivot partitioning (quick-sort)."""
    if len(idx) <= 1:
        return list(idx)
    pivot = idx[len(idx) // 2]
    others = [i for i in idx if i != pivot]
    wins = cmp.batch([(i, pivot) for i in others])
    better = [i for i, w in zip(others, wins) if w]
    worse = [i for i, w in zip(others, wins) if not w]
    return _order_topk(cmp, better) + [pivot] + _order_topk(cmp, worse)


def _quickselect(cmp: _Comparator, candidates: list[int], k: int, rng,
                 *, pivot_scores=None, pivot_eps: int = 2
                 ) -> tuple[list[int], int]:
    """Pivot-partitioning selection of the (unordered) top-``k`` of
    ``candidates`` (global record indices) -> (top list, comparison rounds).
    Shared by the single-partition operator and the per-partition / merge
    phases of the partitioned one."""
    candidates = list(candidates)
    need = k
    top: list[int] = []
    rounds = 0
    first = True
    while candidates and need > 0:
        if len(candidates) <= need:
            top.extend(candidates)
            break
        if first and pivot_scores is not None:
            order = np.argsort(-np.asarray(pivot_scores)[candidates])
            pivot = candidates[order[min(need + pivot_eps - 1, len(candidates) - 1)]]
        else:
            pivot = candidates[rng.integers(len(candidates))]
        first = False
        rounds += 1
        others = [i for i in candidates if i != pivot]
        wins = cmp.batch([(i, pivot) for i in others])
        better = [i for i, w in zip(others, wins) if w]
        worse = [i for i, w in zip(others, wins) if not w]
        if len(better) + 1 == need:      # pivot is exactly rank `need`
            top.extend(better + [pivot])
            break
        if len(better) >= need:
            candidates = better
        else:
            top.extend(better + [pivot])
            need -= len(better) + 1
            candidates = worse
    return top, rounds


def sem_topk_quickselect(records, langex, k, model, *, pivot_scores=None,
                         pivot_eps: int = 2, seed: int = 0
                         ) -> tuple[list[int], dict]:
    """Returns (ordered indices of the top-k, stats).

    ``pivot_scores`` (e.g. embedding similarity to the criteria) enables the
    lossless §3.4 pivot optimization; None -> random pivots (gold algorithm).
    """
    with accounting.track("sem_topk") as st:
        cmp = _Comparator(records, langex, model)
        rng = np.random.default_rng(seed)
        top, rounds = _quickselect(cmp, list(range(len(records))), k, rng,
                                   pivot_scores=pivot_scores,
                                   pivot_eps=pivot_eps)
        ordered = _order_topk(cmp, top[:k] if len(top) >= k else top)
        st.details.update(rounds=rounds, pivot_guided=pivot_scores is not None)
        return ordered[:k], st.as_dict()


def sem_topk_quadratic(records, langex, k, model) -> tuple[list[int], dict]:
    """All-pairs comparisons, Copeland win-count ranking (Table 7 baseline)."""
    with accounting.track("sem_topk_quadratic") as st:
        cmp = _Comparator(records, langex, model)
        n = len(records)
        pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
        wins_flat = cmp.batch(pairs)
        wins = np.zeros(n)
        for (i, j), w in zip(pairs, wins_flat):
            wins[i if w else j] += 1
        order = np.argsort(-wins, kind="stable")
        return list(order[:k]), st.as_dict()


def sem_topk_heap(records, langex, k, model) -> tuple[list[int], dict]:
    """Sequential bounded min-heap (Table 7 baseline: fewer calls, no batching)."""
    import heapq

    with accounting.track("sem_topk_heap") as st:
        cmp = _Comparator(records, langex, model)

        class Item:
            __slots__ = ("i",)

            def __init__(self, i):
                self.i = i

            def __lt__(self, other):  # min-heap root = worst of the kept k
                return not cmp.batch([(self.i, other.i)])[0]

        heap: list[Item] = []
        for i in range(len(records)):
            if len(heap) < k:
                heapq.heappush(heap, Item(i))
            elif cmp.batch([(i, heap[0].i)])[0]:
                heapq.heapreplace(heap, Item(i))
        idx = [it.i for it in heap]
        ordered = _order_topk(cmp, idx)
        return ordered[:k], st.as_dict()
