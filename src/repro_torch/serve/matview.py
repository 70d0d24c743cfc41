"""Semantic materialized views: multi-query subplan sharing.

The dispatcher dedups per *prompt*; the :class:`IndexRegistry` dedups per
*index build*.  This registry extends the same idea to whole subplans: a
plan fingerprint normalizes an operator subtree's semantic payload
(predicate templates + knobs) down to its leaves (a content hash for Scan,
``table@version`` for StreamScan), so two concurrent sessions running the
same filter over the same corpus version detect the overlap, latch exactly
one computation, and the rest serve from the materialization.

Fingerprints are *transparent* through Partition/Exchange wrappers — the IR
contract says fragmentation never changes results, so a partitioned and an
unpartitioned session over the same subplan share one view.  Anything whose
semantics can't be hashed (user callables, pinned index objects) poisons
its subtree to None and never materializes.

Same win-or-wait protocol as the index registry: losers poll the winner's
latch and run their session's ``wait_hook`` between polls so cancellation /
deadline checks still fire while blocked on someone else's computation.
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict

from repro_torch.core.plan import nodes as N

# operators worth materializing: deterministic given their fingerprint
# (model calls ride the seeded sample / cache machinery, so the same
# fingerprint implies the same rows)
_MATERIALIZABLE = {"Filter", "Join", "SimJoin", "Search", "TopK", "Agg",
                   "GroupBy", "Map", "FusedMap", "Extract"}

# annotations that never change results (cost/layout hints): two plans that
# differ only here must share a view
_SKIP_FIELDS = {"selectivity", "shards", "index_auto"}

_SCAN_SAMPLE_CAP = 20_000  # rows hashed in full below this


def _scan_token(records) -> str:
    """Content hash of a Scan's rows.  Above the cap, a head/tail/stride
    sample plus the count — cheap, and a collision additionally needs equal
    length and equal sampled rows."""
    h = hashlib.sha1()
    n = len(records)
    h.update(str(n).encode())
    if n <= _SCAN_SAMPLE_CAP:
        rows = records
    else:
        stride = max(n // 512, 1)
        rows = list(records[:64]) + list(records[-64:]) \
            + [records[i] for i in range(64, n - 64, stride)]
    for row in rows:
        h.update(b"\x1e")
        h.update(repr(sorted(row.items())).encode())
    return f"scan:{h.hexdigest()[:20]}"


def _node_token(node) -> str | None:
    """This node's own contribution to the fingerprint, or None when its
    semantics aren't hashable (poisons the subtree)."""
    cls = type(node).__name__
    if cls == "Scan":
        return _scan_token(node.records)
    if cls == "StreamScan":
        v = node.version if node.version is not None else node.table.version
        return f"stream:{node.table.table_id}@v{v}"
    if cls not in _MATERIALIZABLE:
        return None
    import dataclasses
    parts = [cls]
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if f.name in _SKIP_FIELDS or v is None or isinstance(v, N.LogicalNode):
            continue
        template = getattr(v, "template", None)
        if template is not None:  # a Langex: its semantics are the template
            parts.append(f"{f.name}={template}")
        elif isinstance(v, (tuple, list)) \
                and any(getattr(x, "template", None) for x in v):
            parts.append(f"{f.name}=" + "|".join(
                str(getattr(x, "template", x)) for x in v))
        elif callable(v) or f.name == "index":
            return None  # user code / pinned index object: unshareable
        else:
            parts.append(f"{f.name}={v!r}")
    return "\x1f".join(parts)


def plan_fingerprint(node, memo: dict | None = None) -> str | None:
    """Stable fingerprint of a subplan's semantics, or None when any node in
    it is unshareable.  Partition/Exchange are transparent (same key with
    and without fragmentation); ``memo`` (id -> fp) amortizes re-walks."""
    if isinstance(node, (N.Partition, N.Exchange)):
        return plan_fingerprint(node.child, memo)
    if memo is not None and id(node) in memo:
        return memo[id(node)]
    tok = _node_token(node)
    fp = None
    if tok is not None:
        child_fps = [plan_fingerprint(c, memo) for c in node.children()]
        if all(f is not None for f in child_fps):
            fp = hashlib.sha1(
                "\x1d".join([tok] + child_fps).encode()).hexdigest()[:20]
    if memo is not None:
        memo[id(node)] = fp
    return fp


class MatViewRegistry:
    """Process-wide materialized subplan results, LRU-bounded.

    ``get_or_compute`` is the whole protocol: the first session to ask for
    a key computes it (the build latch makes it exactly one, however many
    sessions race); everyone else blocks on the latch — running their
    ``wait_hook`` so cancellation still fires — and serves the rows.  A
    failed winner releases the latch without installing, so losers re-race
    instead of caching the exception.
    """

    def __init__(self, capacity: int = 64):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._views: OrderedDict[str, list[dict]] = OrderedDict()
        self._building: dict[str, threading.Event] = {}
        self.builds = 0
        self.hits = 0
        self.evictions = 0
        self.rows_served = 0

    def key_for(self, node, memo: dict | None = None) -> str | None:
        """Materialization key for a plan node: None for leaves (a scan
        costs nothing to re-run) and unshareable subtrees."""
        inner = N.plain(node)
        if type(inner).__name__ not in _MATERIALIZABLE:
            return None
        return plan_fingerprint(node, memo)

    def get_or_compute(self, key: str, compute, *, wait_hook=None):
        """Returns ``(rows, hit)``; rows are a fresh list so callers never
        alias the stored materialization."""
        while True:
            with self._lock:
                if key in self._views:
                    self._views.move_to_end(key)
                    rows = self._views[key]
                    self.hits += 1
                    self.rows_served += len(rows)
                    return list(rows), True
                latch = self._building.get(key)
                if latch is None:
                    latch = self._building[key] = threading.Event()
                    break  # this caller is the winner
            # loser: poll so the session's cancellation hook keeps firing
            while not latch.wait(0.02):
                if wait_hook is not None:
                    wait_hook(None)
        try:
            rows = list(compute())
            with self._lock:
                self._views[key] = rows
                self._views.move_to_end(key)
                self.builds += 1
                while len(self._views) > self.capacity:
                    self._views.popitem(last=False)
                    self.evictions += 1
            return list(rows), False
        finally:
            with self._lock:
                self._building.pop(key, None)
            latch.set()

    def metrics(self) -> dict:
        with self._lock:
            return {"matview_builds": self.builds,
                    "matview_hits": self.hits,
                    "matview_evictions": self.evictions,
                    "matviews_resident": len(self._views),
                    "matview_rows_served": self.rows_served}

    def clear(self) -> None:
        with self._lock:
            self._views.clear()
            self.builds = self.hits = self.evictions = self.rows_served = 0
