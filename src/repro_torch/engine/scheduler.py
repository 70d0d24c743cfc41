"""Continuous-batching scheduler (vLLM-style iteration-level scheduling).

Requests are admitted into fixed decode *slots*; every engine step either
prefills one waiting request into a free slot or runs one batched decode step
across all active slots.  Finished sequences free their slot immediately
(iteration-level, not request-level, batching).

Fault tolerance / straggler mitigation:
  * per-request wall-clock deadline -> the request is cancelled and
    re-queued (fresh slot, bounded retries) — the cluster-level analogue of
    re-dispatching work from a straggling / failed worker,
  * a ``fault_hook`` is invoked around model steps so tests can inject
    worker failures (exceptions) and verify the scheduler recovers.

Under a tracer (``obs.trace``) each step that does work is a
``scheduler/step`` span (``phase`` prefill or decode, ``rids`` the requests
it advanced by a token), parent of the runner's span, so its self time is
the sampler's and the slots' bookkeeping.

The fault path catches ``RuntimeError`` only, as the reference's.  A kernel
that fails to build or launch raises ``kernels._build.KernelError``, which
is not one, and the runner re-raises a device fault that surfaces later
(torch's CUDA errors) as one too, so either ends the run instead of turning
into failed requests.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable

import numpy as np

from repro_torch.engine.runner import ModelRunner
from repro_torch.engine.sampler import Sampler
from repro_torch.obs import trace as _trace


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray                  # prompt token ids [T]
    max_new_tokens: int = 32
    stop_id: int | None = None
    extra: dict | None = None           # other inputs (the VLM's image_embeds)
    deadline_s: float | None = None     # wall-clock budget (straggler guard)
    # runtime state
    out_tokens: list = dataclasses.field(default_factory=list)
    first_logits: np.ndarray | None = None
    done: bool = False
    failed: bool = False
    retries: int = 0
    started_at: float | None = None


class ContinuousBatchScheduler:
    def __init__(self, runner: ModelRunner, *, sampler: Sampler | None = None,
                 max_retries: int = 2, fault_hook: Callable[[], None] | None = None):
        self.runner = runner
        self.sampler = sampler or Sampler()
        self.max_retries = max_retries
        self.fault_hook = fault_hook or (lambda: None)
        n = runner.max_slots
        self.slot_req: list[Request | None] = [None] * n
        self.slot_len = np.zeros(n, np.int32)
        self.slot_next = np.zeros(n, np.int32)
        self.queue: deque[Request] = deque()
        self.finished: list[Request] = []
        self.steps = 0
        self.prefill_steps = 0
        self.decode_steps = 0

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _free_slot(self) -> int | None:
        for i, r in enumerate(self.slot_req):
            if r is None:
                return i
        return None

    def _requeue_or_fail(self, req: Request) -> None:
        """Single failure path for prefill faults, decode faults, and blown
        deadlines: reset all runtime state (stale out_tokens would corrupt a
        retried sequence, a stale started_at its deadline clock) and re-queue
        within the retry budget, else surface the request as failed."""
        req.retries += 1
        req.out_tokens = []
        req.first_logits = None
        req.started_at = None
        if req.retries <= self.max_retries:
            req.failed = req.done = False
            self.queue.append(req)       # re-dispatch (straggler mitigation)
        else:
            req.failed, req.done = True, False
            self.finished.append(req)

    def _finish(self, slot: int, *, failed: bool = False) -> None:
        req = self.slot_req[slot]
        assert req is not None
        self.slot_req[slot] = None
        if failed:
            self._requeue_or_fail(req)
        else:
            req.done, req.failed = True, False
            self.finished.append(req)

    def _check_deadlines(self) -> None:
        now = time.monotonic()
        for i, req in enumerate(self.slot_req):
            if req and req.deadline_s and req.started_at and now - req.started_at > req.deadline_s:
                self._finish(i, failed=True)

    # ------------------------------------------------------------------
    def step(self) -> bool:
        """One engine iteration. Returns False when idle (nothing to do)."""
        self.steps += 1
        self._check_deadlines()

        slot = self._free_slot()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        prefill = bool(self.queue) and slot is not None
        if not prefill and not active:
            return bool(self.queue)
        tr = _trace.current_tracer()
        with _trace.span_in(tr, "scheduler/step") as sp:
            if tr is not None:
                rids = [self.queue[0].rid] if prefill else [self.slot_req[i].rid for i in active]
                sp.set(phase="prefill" if prefill else "decode", rids=rids)
            if prefill:
                self._prefill(self.queue.popleft(), slot)
            else:
                self._decode(active)
        return True

    def _prefill(self, req: Request, slot: int) -> None:
        req.started_at = time.monotonic()
        try:
            self.fault_hook()
            logits = self.runner.prefill_into_slot(req.tokens, slot, req.extra)
        except RuntimeError:
            self._requeue_or_fail(req)
            return
        self.prefill_steps += 1
        req.first_logits = logits
        tok = int(self.sampler(logits[None])[0])
        req.out_tokens.append(tok)
        self.slot_req[slot] = req
        self.slot_len[slot] = len(req.tokens)
        self.slot_next[slot] = tok
        if self._req_finished(req):
            self._finish(slot)

    def _decode(self, active: list[int]) -> None:
        try:
            self.fault_hook()
            logits = self.runner.decode(self.slot_next, self.slot_len)
        except RuntimeError:
            # worker fault mid-decode: re-queue everything in flight
            for i in list(active):
                self._finish(i, failed=True)
            return
        self.decode_steps += 1
        toks = self.sampler(logits)
        for i in active:
            req = self.slot_req[i]
            self.slot_len[i] += 1
            tok = int(toks[i])
            req.out_tokens.append(tok)
            self.slot_next[i] = tok
            if self._req_finished(req) or self.slot_len[i] + 1 >= self.runner.max_seq:
                self._finish(i)

    @staticmethod
    def _req_finished(req: Request) -> bool:
        if req.stop_id is not None and req.out_tokens and req.out_tokens[-1] == req.stop_id:
            return True
        return len(req.out_tokens) >= req.max_new_tokens

    def run_to_completion(self, max_steps: int = 100_000) -> list[Request]:
        for _ in range(max_steps):
            busy_slots = any(r is not None for r in self.slot_req)
            if not self.queue and not busy_slots:
                break
            self.step()
        return self.finished
