"""BatchedModelCache: prompt-level dedup + memoization over a model.

Layered on ``CountedModel`` so accounting only sees the prompts that actually
reach the backend: within one batched call, duplicate prompts are coalesced
to a single backend row; across pipeline stages, previously answered prompts
are served from the cache (recorded as ``cache_hits`` in the active OpStats).
This is what makes a repeated predicate — e.g. a filter re-checked after a
join, or overlapping cascade sample/mid-region prompts — never pay twice
inside one optimized pipeline.

Two storage modes:

  * **private** (default): an in-wrapper LRU ``OrderedDict`` bounded by
    ``capacity`` — the single-query ``LazySemFrame.collect()`` path;
  * **shared**: pass ``store=`` a ``repro_torch.serve.store.SharedSemanticCache``
    (or anything with its ``get_many``/``put_many`` protocol) and a
    ``namespace`` (model role) — the serving-gateway path, where one
    process-wide store with TTL/eviction/persistence is consulted by every
    session's wrapper, so a predicate answered by *any* query is a hit for
    all of them.  ``requester`` tags this wrapper's session for the store's
    cross-query-hit attribution.

The wrapper is protocol-compatible with ``GenerativeModel``, so every
operator implementation works against it unchanged.

Thread safety: one wrapper may be hit concurrently by a partitioned
operator's fragment threads, so the private LRU and the hit/miss counters
are lock-guarded.  The backend call itself runs outside the lock — two
fragments missing the same prompt may both pay it (the answers are
identical; the duplicate is bounded by the race window), which is the
standard cache-stampede trade against serializing all fragments.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Sequence

import numpy as np

from repro_torch.core import accounting
from repro_torch.obs import trace as _trace


class BatchedModelCache:
    def __init__(self, model, *, capacity: int = 100_000, store=None,
                 namespace: str | None = None, requester: str | None = None):
        self._m = model
        self.capacity = capacity
        self._store = store
        self._ns = (namespace or getattr(model, "role", "model"),) \
            if store is not None else ()
        self._requester = requester
        self._lru: OrderedDict[tuple, object] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    # -- plumbing ----------------------------------------------------------
    @property
    def role(self) -> str:  # CountedModel compat (introspection / logging)
        return getattr(self._m, "role", "model")

    def _lookup(self, keys: list[tuple]) -> list[tuple]:
        """-> [(found, row)] per key, from the shared store or the LRU."""
        if self._store is not None:
            return self._store.get_many(keys, requester=self._requester)
        with self._lock:
            out = []
            for key in keys:
                if key in self._lru:
                    self._lru.move_to_end(key)
                    out.append((True, self._lru[key]))
                else:
                    out.append((False, None))
            return out

    def _insert(self, keys: list[tuple], rows: list) -> None:
        if self._store is not None:
            self._store.put_many(keys, rows, owner=self._requester)
            return
        with self._lock:
            for key, row in zip(keys, rows):
                self._lru[key] = row
                if len(self._lru) > self.capacity:
                    self._lru.popitem(last=False)

    def _through(self, kind: str, prompts: Sequence[str], call, *,
                 extra_key: tuple = ()):
        """Dedup ``prompts`` against the cache and within the batch, answer
        the misses with one backend ``call``, and reassemble per-prompt rows.

        Reassembly reads from a batch-local row map, not the backing store:
        one batch may be larger than the cache capacity, in which case
        inserting the tail of the batch evicts its own head."""
        sp = _trace.NOOP_SPAN
        if _trace.current_tracer() is not None:
            # one lookup span per batched cache consult (not per prompt)
            role = self._ns[0] if self._ns else "private"
            sp_cm = _trace.span(f"cache/{role}.{kind}", kind="cache_lookup",
                                prompts=len(prompts))
            sp = sp_cm.__enter__()
        else:
            sp_cm = None
        try:
            return self._through_inner(kind, prompts, call,
                                       extra_key=extra_key, sp=sp)
        finally:
            if sp_cm is not None:
                sp_cm.__exit__(None, None, None)

    def _through_inner(self, kind: str, prompts: Sequence[str], call, *,
                       extra_key: tuple = (), sp=_trace.NOOP_SPAN):
        keys = [(*self._ns, kind, *extra_key, p) for p in prompts]
        batch_rows: dict[tuple, object] = {}
        fresh: list[tuple[tuple, str]] = []
        for key, p in zip(keys, prompts):
            if key not in batch_rows:
                batch_rows[key] = None  # placeholder marks in-batch dedup
                fresh.append((key, p))
        found = self._lookup([k for k, _ in fresh])
        todo = [(k, p) for (k, p), (hit, _) in zip(fresh, found) if not hit]
        for (k, _), (hit, row) in zip(fresh, found):
            if hit:
                batch_rows[k] = row
        if todo:
            rows = call([p for _, p in todo])
            for (key, _), row in zip(todo, rows):
                batch_rows[key] = row
            self._insert([k for k, _ in todo], list(rows))
        n_hit = len(prompts) - len(todo)
        sp.set(hits=n_hit, misses=len(todo))
        with self._lock:
            self.hits += n_hit
            self.misses += len(todo)
        accounting.record("cache_hit", n_hit)
        return [batch_rows[k] for k in keys]

    # -- GenerativeModel protocol -----------------------------------------
    def predicate(self, prompts):
        rows = self._through(
            "predicate", prompts,
            lambda ps: list(zip(*(np.asarray(a).tolist()
                                  for a in self._m.predicate(ps)))))
        passed = np.asarray([r[0] for r in rows], bool)
        scores = np.asarray([r[1] for r in rows], np.float32)
        return passed, scores

    def generate(self, prompts):
        return list(self._through("generate", prompts,
                                  lambda ps: list(self._m.generate(ps))))

    def compare(self, prompts):
        rows = self._through("compare", prompts,
                             lambda ps: np.asarray(self._m.compare(ps)).tolist())
        return np.asarray(rows, bool)

    def choose(self, prompts, n_options):
        rows = self._through(
            "choose", prompts,
            lambda ps: np.asarray(self._m.choose(ps, n_options)).tolist(),
            extra_key=(n_options,))
        return np.asarray(rows, int)
