"""SharedSemanticCache: the process-wide semantic answer store.

One store serves every in-flight session (and, with ``persist_path``, every
future run): keys are ``(namespace, kind, *extra, prompt)`` tuples — the same
shape ``BatchedModelCache`` uses — values are the JSON-safe per-prompt rows
the model wrappers produce (predicate ``[bool, score]``, generate ``str``,
compare ``bool``, choose ``int``).  A repeated predicate across two queries,
or across two gateway processes sharing a persistence file, is answered once.

Semantics:
  * **namespaces** — the first key element (model role: oracle/proxy/embed)
    partitions the key space, so an oracle answer never leaks to the proxy;
  * **TTL** — entries older than ``ttl_s`` count as misses and are dropped
    (clock injectable for tests);
  * **capacity** — LRU eviction beyond ``capacity`` entries;
  * **persistence** — optional append-only JSON-lines file, replayed on
    construction (last write wins; expired rows skipped).  Namespaces whose
    rows are not JSON-friendly (embeddings) stay memory-only via
    ``persist_namespaces``; ``close()`` compacts the log (rewrites live
    entries only) once dead lines — overwrites, evictions, expiries —
    outnumber live ones, so the file stays bounded across runs;
  * **attribution** — each entry remembers the session that wrote it, so a
    hit by a *different* session is counted as a cross-query hit (the number
    the gateway reports as ``cross_query_hit_rate``).

Thread-safe; every method takes the one internal lock.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict
from typing import Iterable, Sequence

LM_NAMESPACES = frozenset({"oracle", "proxy"})


class SharedSemanticCache:
    def __init__(self, *, capacity: int = 100_000, ttl_s: float | None = None,
                 persist_path: str | None = None,
                 persist_namespaces: Iterable[str] = LM_NAMESPACES,
                 clock=time.monotonic):
        self.capacity = capacity
        self.ttl_s = ttl_s
        self.persist_path = persist_path
        self.persist_namespaces = frozenset(persist_namespaces)
        self.clock = clock
        self._lock = threading.Lock()
        # key -> (row, written_at, owner)
        self._data: OrderedDict[tuple, tuple] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.cross_hits = 0      # hits on entries another session wrote
        self.evictions = 0
        self.expirations = 0
        self.loaded = 0
        self.compactions = 0
        self.invalidations = 0   # entries purged by guarantee recalibration
        self._file_lines = 0      # lines in the log, live + dead
        self._fh = None
        if persist_path:
            self._load(persist_path)
            self._fh = open(persist_path, "a", encoding="utf-8")

    # -- persistence -------------------------------------------------------
    def _load(self, path: str) -> None:
        if not os.path.exists(path):
            return
        now = self.clock()
        with open(path, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                self._file_lines += 1
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue          # torn tail write; ignore
                key = tuple(rec["k"])
                age = max(0.0, time.time() - rec.get("t", time.time()))
                if self.ttl_s is not None and age >= self.ttl_s:
                    continue
                # replayed entries restart their TTL clock minus recorded age
                self._data[key] = (rec["v"], now - age, rec.get("o"))
                self._data.move_to_end(key)
                self.loaded += 1
        while len(self._data) > self.capacity:
            self._data.popitem(last=False)

    def _append(self, key: tuple, row, owner) -> None:
        if self._fh is None or key[0] not in self.persist_namespaces:
            return
        self._fh.write(json.dumps({"k": list(key), "v": row, "o": owner,
                                   "t": time.time()}) + "\n")
        self._file_lines += 1

    def _live_persistable(self) -> int:
        """Entries a compacted log would keep (lock held): persistable
        namespace, not expired."""
        now = self.clock()
        return sum(1 for k, ent in self._data.items()
                   if k[0] in self.persist_namespaces
                   and (self.ttl_s is None or now - ent[1] < self.ttl_s))

    def compact(self) -> int:
        """Rewrite the persistence log to live entries only (the append-only
        log accumulates a dead line for every overwrite, eviction, and TTL
        expiry — across long runs dead lines dominate and the file grows
        without bound).  Atomic replace; returns the number of lines
        dropped."""
        with self._lock:
            if self._fh is None or not self.persist_path:
                return 0
            self._fh.flush()
            self._fh.close()
            now_m, now_w = self.clock(), time.time()
            tmp = self.persist_path + ".compact"
            kept = 0
            with open(tmp, "w", encoding="utf-8") as fh:
                for key, (row, written, owner) in self._data.items():
                    if key[0] not in self.persist_namespaces:
                        continue
                    if self.ttl_s is not None and now_m - written >= self.ttl_s:
                        continue
                    # recorded wall time preserves the entry's age for the
                    # TTL replay on the next load
                    fh.write(json.dumps(
                        {"k": list(key), "v": row, "o": owner,
                         "t": now_w - max(0.0, now_m - written)}) + "\n")
                    kept += 1
            os.replace(tmp, self.persist_path)
            dropped = self._file_lines - kept
            self._file_lines = kept
            self.compactions += 1
            self._fh = open(self.persist_path, "a", encoding="utf-8")
            return dropped

    def flush(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()

    def close(self) -> None:
        with self._lock:
            open_file = self._fh is not None
            live = self._live_persistable() if open_file else 0
            dead = self._file_lines - live
        if open_file and dead > live:   # dead records dominate: rewrite
            self.compact()
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                self._fh.close()
                self._fh = None

    # -- store protocol (used by BatchedModelCache and the dispatcher) -----
    def get_many(self, keys: Sequence[tuple], *, requester: str | None = None,
                 count: bool = True) -> list[tuple]:
        """-> [(found, row)] per key; expired entries are dropped and count
        as misses.  ``count=False`` is the dispatcher's second-chance lookup,
        which must not re-count prompts the session-side cache already
        counted."""
        out = []
        now = self.clock()
        with self._lock:
            for key in keys:
                ent = self._data.get(key)
                if ent is not None and self.ttl_s is not None \
                        and now - ent[1] >= self.ttl_s:
                    del self._data[key]
                    self.expirations += 1
                    ent = None
                if ent is None:
                    if count:
                        self.misses += 1
                    out.append((False, None))
                else:
                    self._data.move_to_end(key)
                    if count:
                        self.hits += 1
                        if requester is not None and ent[2] != requester:
                            self.cross_hits += 1
                    out.append((True, ent[0]))
        return out

    def put_many(self, keys: Sequence[tuple], rows: Sequence, *,
                 owner: str | None = None,
                 owners: Sequence[str | None] | None = None) -> None:
        now = self.clock()
        if owners is None:
            owners = [owner] * len(keys)
        with self._lock:
            for key, row, own in zip(keys, rows, owners):
                prev = self._data.get(key)
                if prev is not None and prev[0] == row:
                    # freshen recency/TTL, keep the original owner, and skip
                    # the persistence append (no duplicate JSONL rows when
                    # session-side caches re-put dispatcher-answered prompts)
                    self._data[key] = (row, now, prev[2])
                    self._data.move_to_end(key)
                    continue
                self._data[key] = (row, now, own)
                self._data.move_to_end(key)
                self._append(key, row, own)
                if len(self._data) > self.capacity:
                    self._data.popitem(last=False)
                    self.evictions += 1

    def invalidate(self, *, namespaces: Iterable[str] | None = None,
                   contains: str | None = None) -> int:
        """Drop cached answers matching a namespace set and/or a prompt
        substring.  The guarantee auditor's recalibration path: when a
        violation shows a predicate's cached oracle/proxy answers were
        earned under drifted model behavior, purging them forces the next
        query touching that predicate to re-score, re-label, and re-learn
        its cascade thresholds fresh.

        ``contains`` matches against the prompt (the last key element) —
        callers pass the predicate template's longest literal segment, which
        appears verbatim in every rendered prompt.  In-memory only: a
        persisted log still replays the stale rows in the *next* process
        (each entry is one overwrite away from correct there, and the purge
        is re-applied on the next violation); returns entries dropped."""
        ns = None if namespaces is None else frozenset(namespaces)
        with self._lock:
            victims = [
                k for k in self._data
                if (ns is None or k[0] in ns)
                and (contains is None or contains in str(k[-1]))]
            for k in victims:
                del self._data[k]
            self.invalidations += len(victims)
        return len(victims)

    def get(self, key: tuple, *, requester: str | None = None) -> tuple:
        return self.get_many([key], requester=requester)[0]

    def put(self, key: tuple, row, *, owner: str | None = None) -> None:
        self.put_many([key], [row], owner=owner)

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def __contains__(self, key: tuple) -> bool:
        with self._lock:
            ent = self._data.get(key)
            if ent is None:
                return False
            return self.ttl_s is None or self.clock() - ent[1] < self.ttl_s

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "entries": len(self._data), "hits": self.hits,
                "misses": self.misses, "cross_hits": self.cross_hits,
                "hit_rate": self.hits / total if total else 0.0,
                "cross_query_hit_rate": self.cross_hits / total if total else 0.0,
                "evictions": self.evictions, "expirations": self.expirations,
                "loaded": self.loaded, "persist_lines": self._file_lines,
                "compactions": self.compactions,
                "invalidations": self.invalidations,
            }
