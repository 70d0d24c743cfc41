"""ServeSession: one submitted semantic pipeline moving through the gateway.

A session is created by ``Gateway.submit()`` with a logical plan, waits in
the admission queue (FIFO within its tenant, round-robin across tenants),
executes on one worker thread, and resolves to its output records.  The
handle doubles as a future: ``result()`` blocks, ``cancel()`` requests
cooperative cancellation (honored between pipeline stages via the executor's
``stage_hook`` yield points, and immediately for still-queued sessions), and
``deadline_s`` bounds the *end-to-end* wall clock from submission — a
session that waits out its deadline in the queue expires without ever
touching a model.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any

from repro_torch.core.accounting import OpStats

PENDING = "pending"
RUNNING = "running"
DONE = "done"
FAILED = "failed"
CANCELLED = "cancelled"
EXPIRED = "expired"


class SessionCancelled(RuntimeError):
    pass


class SessionDeadlineExceeded(RuntimeError):
    pass


@dataclasses.dataclass
class ServeSession:
    sid: str
    plan: Any
    tenant: str = "default"
    optimize: bool = True
    deadline_s: float | None = None
    submitted_at: float = dataclasses.field(default_factory=time.monotonic)
    status: str = PENDING
    records: list | None = None
    error: BaseException | None = None
    stats: OpStats | None = None          # per-session accounting roll-up
    stats_log: list = dataclasses.field(default_factory=list)
    # mid-query re-plan decisions (adaptive executor), as plain dicts
    replans: list = dataclasses.field(default_factory=list)
    started_at: float | None = None
    finished_at: float | None = None
    _cancel: threading.Event = dataclasses.field(default_factory=threading.Event)
    _done: threading.Event = dataclasses.field(default_factory=threading.Event)

    # -- control -----------------------------------------------------------
    def cancel(self) -> None:
        self._cancel.set()

    @property
    def cancel_requested(self) -> bool:
        return self._cancel.is_set()

    def check(self) -> None:
        """Raise if this session should stop — the stage_hook yield point."""
        if self._cancel.is_set():
            raise SessionCancelled(self.sid)
        if self.deadline_s is not None and \
                time.monotonic() - self.submitted_at > self.deadline_s:
            raise SessionDeadlineExceeded(self.sid)

    # -- future protocol ---------------------------------------------------
    def wait(self, timeout: float | None = None) -> bool:
        return self._done.wait(timeout)

    def result(self, timeout: float | None = None) -> list[dict]:
        if not self._done.wait(timeout):
            raise TimeoutError(f"session {self.sid} still {self.status}")
        if self.status == DONE:
            return self.records
        if self.error is not None:
            raise self.error
        raise RuntimeError(f"session {self.sid} ended as {self.status}")

    # -- bookkeeping (gateway side) ----------------------------------------
    def finish(self, status: str, *, records: list | None = None,
               error: BaseException | None = None) -> None:
        self.status = status
        self.records = records
        self.error = error
        self.finished_at = time.monotonic()
        self._done.set()

    @property
    def latency_s(self) -> float | None:
        if self.finished_at is None:
            return None
        return self.finished_at - self.submitted_at

    def summary(self) -> dict:
        out = {"sid": self.sid, "tenant": self.tenant, "status": self.status,
               "rows": len(self.records) if self.records is not None else None,
               "latency_s": self.latency_s}
        if self.replans:
            out["replans"] = len(self.replans)
        if self.stats is not None:
            out["stats"] = self.stats.as_dict()
        return out
