"""Block-prompted join oracles and transitivity-based verdict inference.

The gold join judges one candidate pair per prompt; Trummer's semantic-join
operators show that packing B pairs into one *structured* prompt and
propagating verdicts through an equivalence predicate's transitivity cuts
the oracle bill by orders of magnitude.  This module holds the three pieces
``sem_join_block`` composes:

  * :func:`build_block_prompt` / :func:`parse_block_response` — a numbered
    multi-pair prompt with a strict output contract (exactly one
    ``<number>: YES|NO`` line per candidate pair, in order) and a parser
    that returns ``None`` on *any* miscount, duplicate, gap, or unparseable
    verdict — a partial parse is never trusted;
  * :class:`BlockJudge` — the parse-validate-retry loop: all block prompts
    of a wave go to ``oracle.generate`` in one call (so the micro-batch
    dispatcher fuses them with concurrent sessions' blocks), malformed
    blocks are retried once with a stricter-format preamble, and blocks
    that still fail fall back to pairwise ``oracle.predicate`` judging —
    verdicts are never silently dropped or misaligned;
  * :class:`MatchInference` — union-find over confirmed matches of an
    equivalence predicate, with enemy edges between classes confirmed
    disjoint, so the verdict of a pair implied by transitivity is inferred
    without prompting (the oracle bill scales with match classes, not
    pairs);
  * :func:`detect_equivalence` — a conservative structural test on the
    calibration sample: positives must form consistent classes (no labeled
    negative inside a positive-connected component) across enough
    overlapping evidence before transitivity is trusted.
"""
from __future__ import annotations

import dataclasses
import math
import re

import numpy as np

DEFAULT_BLOCK_SIZE = 16

_VERDICT_RE = re.compile(r"^\s*(\d+)\s*[.:)\-]\s*(yes|no|true|false|match|"
                         r"nomatch|no match)\b", re.IGNORECASE)
_TRUE_WORDS = ("yes", "true", "match")

_BLOCK_HEADER = (
    "You will judge several candidate pairs at once. Each numbered "
    "candidate pair below is an instance of the claim:\n  {template}\n")
_BLOCK_FOOTER = (
    "\nAnswer with exactly {n} lines, one per numbered candidate pair, in "
    "order. Each line must be '<number>: YES' if the claim holds for that "
    "pair or '<number>: NO' if it does not. No other text.\nAnswers:")
_STRICT_PREFIX = (
    "IMPORTANT: your previous answer could not be parsed. Follow the output "
    "format exactly — {n} lines, '<number>: YES' or '<number>: NO', "
    "nothing else.\n")


def blocking_k(n2: int) -> int:
    """Default per-left-row candidate block width from the right-side
    cardinality: wide enough that an embedding proxy with reasonable
    correlation covers the true matches, narrow enough that the candidate
    set stays O(n1*k) instead of O(n1*n2)."""
    return max(8, math.ceil(0.05 * max(int(n2), 1)))


def build_block_prompt(lx, left, right, pairs, *, strict: bool = False) -> str:
    """One structured prompt over ``pairs`` ([(i, j)] into left/right)."""
    lines = [_BLOCK_HEADER.format(template=lx.template)]
    if strict:
        lines.insert(0, _STRICT_PREFIX.format(n=len(pairs)))
    for k, (i, j) in enumerate(pairs, start=1):
        lines.append(f"{k}. {lx.render(left[i], right[j])}")
    lines.append(_BLOCK_FOOTER.format(n=len(pairs)))
    return "\n".join(lines)


def parse_block_response(text: str, n: int) -> list[bool] | None:
    """Parse a block response into ``n`` ordered verdicts.

    Returns ``None`` (the caller retries / falls back pairwise) when the
    response is truncated, has the wrong verdict count, repeats or skips a
    pair number, or contains an unparseable verdict line — a partial or
    ambiguous parse must never be silently aligned with the pairs."""
    if not text:
        return None
    verdicts: dict[int, bool] = {}
    for line in str(text).splitlines():
        if not line.strip():
            continue
        m = _VERDICT_RE.match(line)
        if m is None:
            continue  # chatter around the answers is tolerated; gaps are not
        k = int(m.group(1))
        if k < 1 or k > n or k in verdicts:
            return None  # out-of-range or duplicate pair id: misaligned
        verdicts[k] = m.group(2).lower() in _TRUE_WORDS
    if len(verdicts) != n:
        return None      # truncated or over-produced: wrong verdict count
    return [verdicts[k] for k in range(1, n + 1)]


@dataclasses.dataclass
class BlockJudgeStats:
    block_prompts: int = 0         # structured multi-pair prompts issued
    block_retries: int = 0         # blocks re-prompted with the strict form
    block_fallbacks: int = 0       # blocks that fell back to pairwise judging
    pairs_block_judged: int = 0    # pairs decided by a parsed block verdict
    pairs_fallback_judged: int = 0  # pairs decided by the pairwise fallback

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class BlockJudge:
    """Judge candidate pairs through block prompts with validate-retry and
    a pairwise fallback.  ``pair_prompt_fn(pairs) -> prompts`` renders the
    pairwise fallback prompts (the gold join's own prompt shape, so the
    fallback is exactly a pairwise judgment)."""

    def __init__(self, oracle, lx, left, right, pair_prompt_fn, *,
                 block_size: int = DEFAULT_BLOCK_SIZE, max_retries: int = 1):
        if block_size < 1:
            raise ValueError(f"block_size={block_size} (expected >= 1)")
        self.oracle = oracle
        self.lx = lx
        self.left = left
        self.right = right
        self.pair_prompt_fn = pair_prompt_fn
        self.block_size = int(block_size)
        self.max_retries = int(max_retries)
        self.stats = BlockJudgeStats()

    def judge_pairs(self, pairs) -> np.ndarray:
        """Verdicts for ``pairs`` in order; every pair gets exactly one."""
        pairs = [(int(i), int(j)) for i, j in pairs]
        out = np.zeros(len(pairs), bool)
        if not pairs:
            return out
        blocks = [(s, pairs[s:s + self.block_size])
                  for s in range(0, len(pairs), self.block_size)]
        pending = blocks
        for attempt in range(self.max_retries + 1):
            if not pending:
                break
            strict = attempt > 0
            prompts = [build_block_prompt(self.lx, self.left, self.right,
                                          blk, strict=strict)
                       for _, blk in pending]
            # one generate call per wave: the dispatcher fuses these block
            # prompts with blocks from concurrent sessions
            responses = self.oracle.generate(prompts)
            self.stats.block_prompts += len(prompts)
            if strict:
                self.stats.block_retries += len(prompts)
            failed = []
            for (start, blk), resp in zip(pending, responses):
                verdicts = parse_block_response(resp, len(blk))
                if verdicts is None:
                    failed.append((start, blk))
                    continue
                out[start:start + len(blk)] = verdicts
                self.stats.pairs_block_judged += len(blk)
            pending = failed
        if pending:
            # still-malformed blocks: judge every pair individually so no
            # verdict is dropped or misaligned
            flat = [(start, k, p) for start, blk in pending
                    for k, p in enumerate(blk)]
            passed, _ = self.oracle.predicate(
                self.pair_prompt_fn([p for _, _, p in flat]))
            for (start, k, _), v in zip(flat, np.asarray(passed, bool)):
                out[start + k] = bool(v)
            self.stats.block_fallbacks += len(pending)
            self.stats.pairs_fallback_judged += len(flat)
        return out


class MatchInference:
    """Transitivity closure for an equivalence join predicate.

    Union-find over the ``n_left + n_right`` records: a confirmed match
    unions the pair's classes, a confirmed non-match marks the two classes
    enemies.  ``implied(i, j)`` then answers without prompting whenever the
    verdict follows: True when both sides share a class, False when their
    classes are known-disjoint, None otherwise."""

    def __init__(self, n_left: int, n_right: int):
        self.n_left = int(n_left)
        self._parent = list(range(self.n_left + int(n_right)))
        self._rank = [0] * len(self._parent)
        self._enemies: dict[int, set[int]] = {}
        self.observed = 0
        self.inferred = 0

    def _find(self, x: int) -> int:
        root = x
        while self._parent[root] != root:
            root = self._parent[root]
        while self._parent[x] != root:       # path compression
            self._parent[x], x = root, self._parent[x]
        return root

    def _enemy_roots(self, root: int) -> set[int]:
        """Current enemy roots of ``root`` (re-normalized through unions)."""
        raw = self._enemies.get(root)
        if not raw:
            return set()
        norm = {self._find(e) for e in raw}
        norm.discard(root)
        self._enemies[root] = norm
        return norm

    def _union(self, a: int, b: int) -> None:
        ra, rb = self._find(a), self._find(b)
        if ra == rb:
            return
        if self._rank[ra] < self._rank[rb]:
            ra, rb = rb, ra
        self._parent[rb] = ra
        if self._rank[ra] == self._rank[rb]:
            self._rank[ra] += 1
        merged = self._enemy_roots(rb) | self._enemy_roots(ra)
        self._enemies.pop(rb, None)
        merged.discard(ra)
        if merged:
            self._enemies[ra] = merged
            for e in merged:
                self._enemies.setdefault(e, set()).add(ra)

    def implied(self, i: int, j: int) -> bool | None:
        ri, rj = self._find(int(i)), self._find(self.n_left + int(j))
        if ri == rj:
            return True
        if rj in self._enemy_roots(ri):
            return False
        return None

    def observe(self, i: int, j: int, verdict: bool) -> None:
        """Fold one oracle-judged pair into the closure."""
        a, b = int(i), self.n_left + int(j)
        self.observed += 1
        if verdict:
            self._union(a, b)
        else:
            ra, rb = self._find(a), self._find(b)
            if ra != rb:
                self._enemies.setdefault(ra, set()).add(rb)
                self._enemies.setdefault(rb, set()).add(ra)

    def resolve(self, i: int, j: int) -> bool | None:
        """``implied`` plus bookkeeping: counts an inference when the
        verdict came for free."""
        v = self.implied(i, j)
        if v is not None:
            self.inferred += 1
        return v

    def implied_matrix(self) -> np.ndarray:
        """Dense ``[n_left, n_right]`` grid of pairs implied *True* by the
        closure.  Two records imply a match iff they share a union-find
        root; singleton records (never unioned) imply nothing.  This is how
        the block join recovers *blocking misses*: a pair the candidate
        retrieval never surfaced still joins when transitivity settles it."""
        n_right = len(self._parent) - self.n_left
        lroots = np.fromiter((self._find(i) for i in range(self.n_left)),
                             dtype=np.int64, count=self.n_left)
        rroots = np.fromiter(
            (self._find(self.n_left + j) for j in range(n_right)),
            dtype=np.int64, count=n_right)
        return lroots[:, None] == rroots[None, :]

    def n_classes(self) -> int:
        """Distinct classes among records touched by at least one union."""
        roots = {self._find(x) for x in range(len(self._parent))
                 if self._parent[x] != x or self._rank[x] > 0}
        return len(roots)


def detect_equivalence(pairs, labels, *, min_evidence: int = 4) -> bool:
    """Conservative structural test for an equivalence predicate on the
    labeled calibration sample: positive matches must form consistent
    classes — no labeled *negative* pair may connect two records that the
    positive closure says are equivalent — and the sample must hold at
    least ``min_evidence`` overlapping pairs (pairs sharing a record with
    another labeled pair), otherwise there is no structure to test and
    transitivity stays off."""
    pairs = [(int(i), int(j)) for i, j in pairs]
    labels = np.asarray(labels, bool)
    if len(pairs) != len(labels):
        raise ValueError("pairs/labels length mismatch")
    left_seen: dict[int, int] = {}
    right_seen: dict[int, int] = {}
    for i, j in pairs:
        left_seen[i] = left_seen.get(i, 0) + 1
        right_seen[j] = right_seen.get(j, 0) + 1
    evidence = sum(1 for i, j in pairs
                   if left_seen[i] > 1 or right_seen[j] > 1)
    if evidence < min_evidence:
        return False
    n_left = max((i for i, _ in pairs), default=-1) + 1
    n_right = max((j for _, j in pairs), default=-1) + 1
    inf = MatchInference(n_left, n_right)
    for (i, j), v in zip(pairs, labels):
        if v:
            inf.observe(i, j, True)
    violations = sum(1 for (i, j), v in zip(pairs, labels)
                     if not v and inf.implied(i, j) is True)
    return violations == 0
