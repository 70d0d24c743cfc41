"""CorpusTable: the versioned streaming corpus (delta-table analogue).

The paper's batch model — and PRs 1-3 — treat a corpus as frozen: any
appended row changes the registry fingerprint, forcing a full re-embed +
index rebuild and a from-scratch pipeline run.  A ``CorpusTable`` instead
gives rows stable ids and gives the *table* a monotonically increasing
version: every commit (an append batch, an update, a delete) bumps the
version by one and logs the change, so downstream consumers can ask two
delta-aware questions the frozen model cannot answer:

  * ``snapshot(v)``  — the exact row set at any past version (commits are
    replayable), which is what lets a continuous query pin a version and
    stay record-identical to a from-scratch run even while writers race;
  * ``delta(v0, v1)`` — the *net* row changes between two versions
    (add-then-delete inside the window cancels out), which is what lets the
    ``IndexRegistry`` append only new vectors to a cached index and the
    serving cache cover every already-judged row.

Snapshot order is row-id order (= insertion order; updates keep their
position), so an appends-only delta satisfies
``snapshot(v1) == snapshot(v0) + [r for _, r in delta.added]`` — the
alignment contract the incremental index path relies on (index position i
is snapshot row i at every version).

Listeners (``add_listener``) are the change feed: ``Gateway.subscribe``
registers one per table to re-execute continuous queries on new versions.
Thread-safe; listeners fire outside the lock.
"""
from __future__ import annotations

import bisect
import dataclasses
import threading
import uuid
from typing import Any, Callable, Iterable, Sequence


@dataclasses.dataclass(frozen=True)
class DeltaSet:
    """Net row changes between two table versions ``(since, to]``."""

    since: int
    to: int
    added: tuple[tuple[int, dict], ...]    # (row id, record at `to`)
    updated: tuple[tuple[int, dict], ...]  # existed at `since`, changed
    deleted: tuple[int, ...]               # existed at `since`, gone at `to`

    @property
    def appends_only(self) -> bool:
        """True when a base index/result can be extended instead of rebuilt."""
        return not self.updated and not self.deleted

    def __bool__(self) -> bool:
        return bool(self.added or self.updated or self.deleted)


class CorpusTable:
    _SNAPSHOT_CACHE = 8   # materialized historical versions kept around

    def __init__(self, records: Sequence[dict] = (), *, name: str | None = None):
        self.table_id = name or f"tbl-{uuid.uuid4().hex[:10]}"
        self._lock = threading.RLock()
        # (version, op, rid, record-or-None); records are copied on commit.
        # _log_versions mirrors the (sorted) version column so delta() and
        # _state_at() bisect to their window instead of scanning the log
        self._log: list[tuple[int, str, int, dict | None]] = []
        self._log_versions: list[int] = []
        self._live: dict[int, dict] = {}     # rid -> record, insertion order
        self._next_rid = 0
        self._version = 0
        self._schema: set[str] = set()
        self._listeners: list[Callable[[int], None]] = []
        self._snap_cache: dict[int, list[dict]] = {}
        if records:
            self.append(records)

    # -- write path --------------------------------------------------------
    def _commit(self, entries: list[tuple[str, int, dict | None]]) -> int:
        """One atomic version bump for a batch of ops (lock held by caller)."""
        self._version += 1
        v = self._version
        for op, rid, rec in entries:
            self._log.append((v, op, rid, rec))
            self._log_versions.append(v)
            if op == "delete":
                self._live.pop(rid, None)
            else:
                self._live[rid] = rec
        self._snap_cache.pop(v, None)
        return v

    def append(self, records: Iterable[dict]) -> int:
        """Append a batch of rows as ONE new version; returns it."""
        with self._lock:
            entries = []
            for rec in records:
                rec = dict(rec)
                entries.append(("append", self._next_rid, rec))
                self._next_rid += 1
                if not self._schema:
                    self._schema = set(rec.keys())
            if not entries:
                return self._version
            v = self._commit(entries)
        self._notify(v)
        return v

    def update(self, rid: int, fields: dict) -> int:
        """Merge ``fields`` into row ``rid``; returns the new version."""
        with self._lock:
            if rid not in self._live:
                raise KeyError(f"row {rid} not live in {self.table_id}")
            rec = {**self._live[rid], **fields}
            v = self._commit([("update", rid, rec)])
        self._notify(v)
        return v

    def delete(self, rid: int) -> int:
        with self._lock:
            if rid not in self._live:
                raise KeyError(f"row {rid} not live in {self.table_id}")
            v = self._commit([("delete", rid, None)])
        self._notify(v)
        return v

    # -- read path -----------------------------------------------------------
    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def __len__(self) -> int:
        with self._lock:
            return len(self._live)

    def schema(self) -> set[str]:
        with self._lock:
            return set(self._schema)

    def _state_at(self, version: int) -> dict[int, dict]:
        """rid -> record at ``version`` (lock held). Replays the log for
        historical versions; rids come out in insertion order."""
        if version == self._version:
            return self._live
        if not 0 <= version <= self._version:
            raise ValueError(f"version {version} out of range "
                             f"[0, {self._version}] for {self.table_id}")
        state: dict[int, dict] = {}
        hi = bisect.bisect_right(self._log_versions, version)
        for _, op, rid, rec in self._log[:hi]:
            if op == "delete":
                state.pop(rid, None)
            else:
                state[rid] = rec
        return state

    def snapshot(self, version: int | None = None) -> list[dict]:
        """The row set at ``version`` (default: current), in row-id order.
        Record dicts are shared (treated immutable, like ``Scan.records``);
        the list is fresh per call."""
        with self._lock:
            v = self._version if version is None else version
            cached = self._snap_cache.get(v)
            if cached is None:
                cached = list(self._state_at(v).values())
                self._snap_cache[v] = cached
                while len(self._snap_cache) > self._SNAPSHOT_CACHE:
                    self._snap_cache.pop(next(iter(self._snap_cache)))
            return list(cached)

    def row_ids(self, version: int | None = None) -> list[int]:
        with self._lock:
            v = self._version if version is None else version
            return list(self._state_at(v).keys())

    def count(self, version: int | None = None) -> int:
        return len(self.snapshot(version))

    def delta(self, since: int, to: int | None = None) -> DeltaSet:
        """Net changes over ``(since, to]`` (see class docstring)."""
        with self._lock:
            to_v = self._version if to is None else to
            if not 0 <= since <= to_v <= self._version:
                raise ValueError(f"bad delta range ({since}, {to_v}] for "
                                 f"{self.table_id}@v{self._version}")
            added: set[int] = set()
            updated: set[int] = set()
            deleted: set[int] = set()
            lo = bisect.bisect_right(self._log_versions, since)
            hi = bisect.bisect_right(self._log_versions, to_v)
            for _, op, rid, _rec in self._log[lo:hi]:
                if op == "append":
                    added.add(rid)
                elif op == "update":
                    if rid not in added:
                        updated.add(rid)
                else:  # delete
                    if rid in added:          # born and died inside the window
                        added.discard(rid)
                    else:
                        updated.discard(rid)
                        deleted.add(rid)
            state = self._state_at(to_v)
            return DeltaSet(
                since=since, to=to_v,
                added=tuple((rid, state[rid]) for rid in sorted(added)),
                updated=tuple((rid, state[rid]) for rid in sorted(updated)),
                deleted=tuple(sorted(deleted)))

    # -- change feed ---------------------------------------------------------
    def add_listener(self, fn: Callable[[int], None]) -> Callable[[int], None]:
        with self._lock:
            self._listeners.append(fn)
        return fn

    def remove_listener(self, fn: Callable[[int], None]) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    def _notify(self, version: int) -> None:
        with self._lock:
            listeners = list(self._listeners)
        for fn in listeners:
            fn(version)

    # -- frame integration ---------------------------------------------------
    def frame(self, session) -> Any:
        """Eager SemFrame over the current snapshot (a frozen copy)."""
        from repro_torch.core.frame import SemFrame
        return SemFrame(self.snapshot(), session)

    def lazy(self, session) -> Any:
        """LazySemFrame whose plan leaf is a StreamScan over this table —
        the handle ``Gateway.subscribe`` re-executes on every new version."""
        from repro_torch.core.frame import LazySemFrame
        from repro_torch.core.plan import nodes as N
        return LazySemFrame(N.StreamScan(self), session)

    def describe(self) -> dict:
        with self._lock:
            return {"table_id": self.table_id, "version": self._version,
                    "rows": len(self._live), "log_entries": len(self._log),
                    "columns": sorted(self._schema)}
