"""IndexRegistry: process-wide retrieval-index sharing across serve sessions.

Every embedding-backed operator in a plan (sem_search, sem_sim_join, the
join sim-prefilter, topk pivot selection) needs an index over some corpus.
Without sharing, N concurrent gateway sessions over the same corpus embed
and build N times.  The registry keys built indexes by
``(corpus-fingerprint, embedder identity, kind, build params)`` — the
build params include the device-shard layout (``shards``), so a sharded
build and an unsharded build of the same corpus are distinct entries and a
session never receives an index laid out for a mesh it isn't using —
``repro_torch.index.backend.corpus_fingerprint`` unwraps the per-session
accounting/dispatch wrappers so sessions land on the same key — and
guarantees *exactly one build per key* under concurrency: losers of the
build race block on the winner's per-key latch instead of re-building.

Streaming corpora get a second, *versioned* protocol: ``get_or_update``
keys a :class:`~repro_torch.stream.table.CorpusTable` by its stable table id (not
a content fingerprint, which an append would invalidate) and remembers the
version each cached index covers.  An appends-only delta re-uses the base
index and applies only the new rows through the caller's ``updater``
(embed + ``index.add``); updates/deletes fall back to a rebuild — and a
request pinned *behind* the cached version builds fresh without caching,
so a session that pinned an old snapshot never sees rows from the future.

LRU capacity bounds a long-lived gateway's memory; eviction releases the
evicted key's embedder pin AND any stale build latch (waiters re-race
instead of deadlocking), so a long-lived gateway doesn't leak pinned
embedders.  ``metrics()`` reports builds / shared hits / delta updates /
evictions for benchmarks and the gateway snapshot.

``repro_torch.serve.matview`` applies the same win-or-wait latch protocol one
level up — to whole materialized subplans keyed by plan fingerprint — so
the sharing ladder is prompt (dispatcher) -> index build (here) -> subplan
(MatViewRegistry).
"""
from __future__ import annotations

import threading
from collections import OrderedDict

from repro_torch.index.backend import (RetrievalBackend, corpus_fingerprint,
                                       embedder_key)
from repro_torch.obs import trace as _trace


class IndexRegistry:
    def __init__(self, *, capacity: int = 32):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._indexes: OrderedDict[str, RetrievalBackend] = OrderedDict()
        # keys embed the backend embedder's id(); pinning the embedder (the
        # wrapper chain holds the backend) for the entry's lifetime stops a
        # GC'd embedder's address being reused by a *different* model, which
        # would silently alias its key onto a stale index
        self._pins: dict[str, object] = {}
        self._versions: dict[str, int] = {}   # stream keys: covered version
        self._building: dict[str, threading.Event] = {}
        self.builds = 0
        self.hits = 0
        self.updates = 0          # delta applications onto a cached index
        self.delta_rows = 0       # rows embedded+indexed by those updates
        self.stale_misses = 0     # pinned-version requests behind the cache
        self.evictions = 0

    @staticmethod
    def key_for(texts, embedder, *, kind: str, params: dict | None = None) -> str:
        extras = "|".join(f"{k}={v}" for k, v in sorted((params or {}).items()))
        return f"{corpus_fingerprint(texts, embedder)}:{kind}:{extras}"

    @staticmethod
    def stream_key_for(table, embedder, *, kind: str,
                       params: dict | None = None) -> str:
        extras = "|".join(f"{k}={v}" for k, v in sorted((params or {}).items()))
        return (f"stream:{table.table_id}:{embedder_key(embedder)}"
                f":{kind}:{extras}")

    # -- shared plumbing ---------------------------------------------------
    def _evict_excess(self) -> None:
        """LRU-evict past capacity (lock held): the index, its embedder pin,
        its stream version, and any stale build latch (released, so waiters
        re-race the build instead of blocking on a dead key)."""
        while len(self._indexes) > self.capacity:
            old_key, _ = self._indexes.popitem(last=False)
            self._pins.pop(old_key, None)
            self._versions.pop(old_key, None)
            latch = self._building.pop(old_key, None)
            if latch is not None:
                latch.set()
            self.evictions += 1

    def _win_or_wait(self, key: str, target: int | None = None):
        """Return (hit_index, None) on a cache hit, (base, latch) after
        winning the build/update race (base = cached-but-outdated index or
        None), or (None, "stale") when the cache is ahead of a pinned
        version.  Loops while a loser, waiting on the winner's latch."""
        while True:
            with self._lock:
                idx = self._indexes.get(key)
                if idx is not None:
                    have = self._versions.get(key)
                    if target is None or have == target:
                        self._indexes.move_to_end(key)
                        self.hits += 1
                        return idx, None
                    if have is not None and have > target:
                        self.stale_misses += 1
                        return None, "stale"
                latch = self._building.get(key)
                if latch is None:               # we won the race
                    self._building[key] = threading.Event()
                    return idx, self._building[key]
            latch.wait()                        # loser: winner is working

    def _install(self, key: str, index: RetrievalBackend, embedder,
                 version: int | None = None) -> None:
        with self._lock:
            self._indexes[key] = index
            self._indexes.move_to_end(key)
            self._pins[key] = embedder
            if version is not None:
                self._versions[key] = version
            self._evict_excess()

    def _release(self, key: str, latch: threading.Event) -> None:
        with self._lock:
            self._building.pop(key, None)
        latch.set()

    # -- frozen-corpus protocol (content-fingerprint keys) -----------------
    def get_or_build(self, texts, embedder, *, kind: str, builder,
                     params: dict | None = None) -> RetrievalBackend:
        """Return the shared index for this corpus+embedder+config, building
        it at most once process-wide (concurrent callers wait on the
        winner's latch)."""
        key = self.key_for(texts, embedder, kind=kind, params=params)
        idx, latch = self._win_or_wait(key)
        if latch is None:
            return idx
        try:
            # build races are won once per key: the span measures the single
            # process-wide build this session actually paid for
            with _trace.span(f"index_build/{kind}", kind="index_build",
                             corpus_rows=len(texts)) as sp:
                built = builder()
                sp.set(index_kind=built.kind)
            with self._lock:
                self.builds += 1
            self._install(key, built, embedder)
            return built
        finally:
            self._release(key, latch)

    # -- streaming protocol (table-id keys, versioned) ---------------------
    def get_or_update(self, table, embedder, *, kind: str, builder,
                      updater=None, params: dict | None = None,
                      version: int | None = None) -> RetrievalBackend:
        """Index over ``table``'s snapshot at ``version`` (default: current).

        ``builder(records)`` builds from a full snapshot; ``updater(index,
        added_records)`` applies an appends-only delta in place.  Exactly
        one builder/updater runs per key under concurrency; an index cached
        *ahead* of a pinned version is never served for it (fresh uncached
        build instead)."""
        target = table.version if version is None else version
        key = self.stream_key_for(table, embedder, kind=kind, params=params)
        idx, latch = self._win_or_wait(key, target)
        if latch is None:
            return idx
        if latch == "stale":  # pinned behind the cache: correctness first
            return builder(table.snapshot(target))
        try:
            with self._lock:
                # re-read: eviction may have raced us between win and update
                # — and force-released our latch, letting a re-racer install
                # a fresh index.  Whatever is resident NOW is the truth; our
                # pre-win ``idx`` may be stale.
                cur = self._indexes.get(key)
                have = self._versions.get(key)
            if cur is not idx:
                idx = cur
                if idx is not None and have == target:
                    return idx                  # finally releases the latch
                if idx is not None and have is not None and have > target:
                    # a re-racer installed a NEWER version while our latch
                    # was force-released: pinned-behind, build fresh uncached
                    with self._lock:
                        self.stale_misses += 1
                    return builder(table.snapshot(target))
            if have is None:
                idx = None
            if idx is None:
                with _trace.span(f"index_build/{kind}", kind="index_build",
                                 table=table.table_id, version=target):
                    built = builder(table.snapshot(target))
                with self._lock:
                    self.builds += 1
            else:
                delta = table.delta(have, target)
                if delta.appends_only and not delta.added:
                    built = idx                 # net no-op commits
                elif delta.appends_only and updater is not None:
                    with _trace.span(f"index_update/{kind}",
                                     kind="index_build",
                                     table=table.table_id, version=target,
                                     delta_rows=len(delta.added)):
                        updater(idx, [r for _, r in delta.added])
                    built = idx
                    with self._lock:
                        self.updates += 1
                        self.delta_rows += len(delta.added)
                else:                           # updates/deletes: rebuild
                    with _trace.span(f"index_build/{kind}",
                                     kind="index_build",
                                     table=table.table_id, version=target):
                        built = builder(table.snapshot(target))
                    with self._lock:
                        self.builds += 1
            self._install(key, built, embedder, version=target)
            return built
        finally:
            self._release(key, latch)

    def metrics(self) -> dict:
        with self._lock:
            return {"index_builds": self.builds, "index_hits": self.hits,
                    "index_updates": self.updates,
                    "index_delta_rows": self.delta_rows,
                    "index_stale_misses": self.stale_misses,
                    "index_evictions": self.evictions,
                    "indexes_resident": len(self._indexes)}

    def clear(self) -> None:
        with self._lock:
            self._indexes.clear()
            self._pins.clear()
            self._versions.clear()
            for latch in self._building.values():
                latch.set()                     # release any stuck waiters
            self._building.clear()
