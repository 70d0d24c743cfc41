"""MicroBatchDispatcher: cross-query fusion of model calls.

Every in-flight session executes its plan on its own worker thread, but all
of their oracle/proxy/embed traffic funnels through one dispatcher.  Calls of
the same (role, kind, extra) shape are parked in a bucket; a background
thread flushes a bucket when its oldest entry has waited ``window_s`` or its
unique-prompt count reaches ``max_batch``, deduplicates prompts across the
parked calls, consults the shared semantic store, and issues **one** fused
backend call for the remainder.  Over the real-engine path the fused batch
lands on ``InferenceEngine``'s ``ContinuousBatchScheduler`` as a single
admission wave — decode slots stay full instead of draining per query.

Accounting stays per-session even though the backend call happens on the
dispatcher thread: the dispatcher computes, for each parked call, how many
unique prompts it *owned* (was first to request and went to the backend) and
how many were shared/cached, and the caller-side ``DispatchedModel`` records
those on its own thread — where the session's OpStats live.

``DispatchedModel`` / ``DispatchedEmbedder`` are protocol-compatible with
``GenerativeModel`` / ``EmbeddingModel``, so executors and the plan
optimizer use them as drop-in handles.
"""
from __future__ import annotations

import threading
import time
from typing import Sequence

import numpy as np

from repro_torch.core import accounting
from repro_torch.obs import trace as _trace


class DispatchError(RuntimeError):
    """A fused backend call failed; raised in every waiting caller."""


class _ParkedCall:
    __slots__ = ("prompts", "tag", "event", "rows", "owned", "shared", "error")

    def __init__(self, prompts: list[str], tag: str | None):
        self.prompts = prompts
        self.tag = tag                     # session id, for cross-query stats
        self.event = threading.Event()
        self.rows: list | None = None
        self.owned = 0                     # unique prompts this call paid for
        self.shared = 0                    # prompts answered by store/another call
        self.error: BaseException | None = None


class MicroBatchDispatcher:
    def __init__(self, *, oracle, proxy=None, embedder=None, store=None,
                 window_s: float = 0.002, max_batch: int = 64, tracer=None):
        self._backends = {"oracle": oracle, "proxy": proxy, "embed": embedder}
        self._background: set[str] = set()   # roles flushed lazily (audit)
        self._store = store
        # fused batches run on the dispatcher thread, outside any session's
        # trace context: batch spans root on the tracer handle directly
        self._tracer = tracer
        self.window_s = window_s
        self.max_batch = max_batch
        self._cv = threading.Condition()
        self._buckets: dict[tuple, list[_ParkedCall]] = {}
        self._bucket_t0: dict[tuple, float] = {}
        self._closed = False
        # metrics
        self.fused_batches = 0
        self.fused_calls = 0               # parked calls absorbed into batches
        self.backend_prompts = 0           # unique prompts sent to backends
        self.requested_prompts = 0         # prompts submitted by callers
        self.cross_shared = 0              # in-window LM dupes across sessions
        self.cross_shared_embed = 0        # same, embed traffic (kept apart:
                                           # embeds never do a counted store
                                           # consult, so mixing them into the
                                           # LM hit-rate would break the rate)
        # background (audit) traffic is counted apart so query-path fusion
        # rates are identical with auditing on or off
        self.audit_batches = 0
        self.audit_backend_prompts = 0
        self.audit_requested_prompts = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="microbatch-dispatcher")
        self._thread.start()

    def add_backend(self, role: str, backend, *,
                    background: bool = False) -> None:
        """Register an extra role (the gateway adds ``audit``).
        ``background=True`` gives the role a stretched flush window
        (``window_s * 8``) so its buckets yield the dispatch thread to
        latency-sensitive query traffic and fuse into wider batches."""
        with self._cv:
            self._backends[role] = backend
            if background:
                self._background.add(role)
            else:
                self._background.discard(role)

    # -- caller side -------------------------------------------------------
    def submit(self, role: str, kind: str, prompts: Sequence[str], *,
               extra: tuple = (), tag: str | None = None) -> _ParkedCall:
        """Park one call and block until the fused batch answers it."""
        if self._backends.get(role) is None:
            raise ValueError(f"dispatcher has no backend for role {role!r}")
        call = _ParkedCall(list(prompts), tag)
        key = (role, kind, extra)
        with self._cv:
            if self._closed:
                raise DispatchError("dispatcher is closed")
            bucket = self._buckets.setdefault(key, [])
            if not bucket:
                self._bucket_t0[key] = time.monotonic()
            bucket.append(call)
            self._cv.notify_all()
        call.event.wait()
        if call.error is not None:
            raise DispatchError(str(call.error)) from call.error
        return call

    # -- dispatcher thread -------------------------------------------------
    def _window_for(self, key: tuple) -> float:
        return self.window_s * (8 if key[0] in self._background
                                else 1)

    def _ready_key(self) -> tuple | None:
        """A bucket whose window elapsed or whose unique count hit max_batch
        (caller must hold the lock)."""
        now = time.monotonic()
        for key, bucket in self._buckets.items():
            if not bucket:
                continue
            if now - self._bucket_t0[key] >= self._window_for(key):
                return key
            uniq = len({p for c in bucket for p in c.prompts})
            if uniq >= self.max_batch:
                return key
        return None

    def _next_deadline(self) -> float | None:
        if not any(self._buckets.values()):
            return None
        return min(self._bucket_t0[k] + self._window_for(k)
                   for k, b in self._buckets.items() if b)

    def _loop(self) -> None:
        while True:
            with self._cv:
                while True:
                    if self._closed and not any(self._buckets.values()):
                        return
                    key = self._ready_key()
                    if key is not None or self._closed:
                        break
                    deadline = self._next_deadline()
                    self._cv.wait(timeout=None if deadline is None
                                  else max(deadline - time.monotonic(), 1e-4))
                if key is None:   # closing: flush whatever is parked
                    key = next(k for k, b in self._buckets.items() if b)
                calls = self._buckets.pop(key)
                self._bucket_t0.pop(key, None)
            self._execute(key, calls)

    def _invoke(self, role: str, kind: str, extra: tuple,
                prompts: list[str]) -> list:
        m = self._backends[role]
        if kind == "predicate":
            passed, scores = m.predicate(prompts)
            return list(zip(np.asarray(passed).tolist(),
                            np.asarray(scores).tolist()))
        if kind == "generate":
            return list(m.generate(prompts))
        if kind == "compare":
            return np.asarray(m.compare(prompts)).tolist()
        if kind == "choose":
            return np.asarray(m.choose(prompts, extra[0])).tolist()
        if kind == "embed":
            return list(np.asarray(m.embed(prompts)))
        raise ValueError(f"unknown call kind {kind!r}")

    def _execute(self, key: tuple, calls: list[_ParkedCall]) -> None:
        role, kind, extra = key
        with _trace.span_in(self._tracer, f"dispatch/{role}.{kind}",
                            "dispatch_batch", role=role, call_kind=kind) as sp:
            self._execute_batch(key, calls, sp)

    def _execute_batch(self, key: tuple, calls: list[_ParkedCall],
                       sp) -> None:
        role, kind, extra = key
        try:
            # dedup across all parked calls; first requester owns the prompt
            owner_of: dict[str, _ParkedCall] = {}
            order: list[str] = []
            for c in calls:
                for p in c.prompts:
                    if p not in owner_of:
                        owner_of[p] = c
                        order.append(p)
            rows: dict[str, object] = {}
            todo = order
            # background (audit) roles bypass the store entirely: a cached
            # gold answer would mask exactly the drift the audit exists to
            # detect, and audit answers must never warm query-visible state
            use_store = self._store is not None \
                and role not in self._background
            if use_store:
                keys = [(role, kind, *extra, p) for p in order]
                # second-chance lookup (uncounted): the session-side caches
                # already did the counted consult before parking the call
                found = self._store.get_many(keys, count=False)
                todo = []
                for p, (hit, row) in zip(order, found):
                    if hit:
                        rows[p] = row
                        owner_of[p] = None  # nobody pays: it's a cache hit
                    else:
                        todo.append(p)
            if todo:
                answered = self._invoke(role, kind, extra, todo)
                for p, row in zip(todo, answered):
                    rows[p] = row
                if use_store:
                    self._store.put_many(
                        [(role, kind, *extra, p) for p in todo], answered,
                        owners=[owner_of[p].tag for p in todo])
            # batch fusion width + dedup/store effect, on the batch span
            sp.set(fused_calls=len(calls), unique_prompts=len(order),
                   backend_prompts=len(todo),
                   store_hits=len(order) - len(todo),
                   sessions=len({c.tag for c in calls}))
            prompt_sets = [set(c.prompts) for c in calls]
            with self._cv:
                if role in self._background:
                    self.audit_batches += 1
                    self.audit_backend_prompts += len(todo)
                    self.audit_requested_prompts += sum(
                        len(c.prompts) for c in calls)
                else:
                    self.fused_batches += 1
                    self.fused_calls += len(calls)
                    self.backend_prompts += len(todo)
                    self.requested_prompts += sum(
                        len(c.prompts) for c in calls)
                if len({c.tag for c in calls}) > 1:
                    for p in order:
                        sharers = {c.tag for c, ps in zip(calls, prompt_sets)
                                   if p in ps}
                        n = max(len(sharers) - 1, 0)
                        if role == "embed":
                            self.cross_shared_embed += n
                        else:
                            self.cross_shared += n
            for c in calls:
                c.rows = [rows[p] for p in c.prompts]
                c.owned = sum(1 for p in set(c.prompts) if owner_of.get(p) is c)
                c.shared = len(c.prompts) - c.owned
                c.event.set()
        except BaseException as exc:  # propagate to every waiting caller
            for c in calls:
                c.error = exc
                c.event.set()

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=5.0)

    def stats(self) -> dict:
        with self._cv:
            return {
                "fused_batches": self.fused_batches,
                "fused_calls": self.fused_calls,
                "backend_prompts": self.backend_prompts,
                "requested_prompts": self.requested_prompts,
                "cross_shared": self.cross_shared,
                "cross_shared_embed": self.cross_shared_embed,
                "coalesce_ratio": (self.fused_calls / self.fused_batches
                                   if self.fused_batches else 0.0),
                "audit_batches": self.audit_batches,
                "audit_backend_prompts": self.audit_backend_prompts,
                "audit_requested_prompts": self.audit_requested_prompts,
            }


class DispatchedModel:
    """GenerativeModel handle that routes through the dispatcher and records
    per-session accounting on the calling thread (where the session's
    OpStats context lives)."""

    def __init__(self, dispatcher: MicroBatchDispatcher, role: str, *,
                 tag: str | None = None):
        self._d = dispatcher
        self.role = role
        self.tag = tag

    def _submit(self, kind: str, prompts, extra: tuple = ()):
        call = self._d.submit(self.role, kind, prompts, extra=extra,
                              tag=self.tag)
        accounting.record(self.role, call.owned)
        if kind in ("generate", "compare"):
            accounting.record(kind, call.owned)
        accounting.record("cache_hit", call.shared)
        return call.rows

    def predicate(self, prompts):
        rows = self._submit("predicate", prompts)
        return (np.asarray([r[0] for r in rows], bool),
                np.asarray([r[1] for r in rows], np.float32))

    def generate(self, prompts):
        return list(self._submit("generate", prompts))

    def compare(self, prompts):
        return np.asarray(self._submit("compare", prompts), bool)

    def choose(self, prompts, n_options):
        return np.asarray(self._submit("choose", prompts, (n_options,)), int)


class DispatchedEmbedder:
    def __init__(self, dispatcher: MicroBatchDispatcher, *, tag: str | None = None):
        self._d = dispatcher
        self.tag = tag

    @property
    def dim(self):
        return self._d._backends["embed"].dim

    @property
    def index_key(self):
        """Identity of the shared backend embedder, not this per-session
        handle — serve sessions must land on the same registry key."""
        from repro_torch.index.backend import embedder_key
        return embedder_key(self._d._backends["embed"])

    def embed(self, texts):
        call = self._d.submit("embed", "embed", texts, tag=self.tag)
        accounting.record("embed", call.owned)
        accounting.record("cache_hit", call.shared)
        return np.stack([np.asarray(r) for r in call.rows])
