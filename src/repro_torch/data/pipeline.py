"""Deterministic, resumable, shard-aware token pipeline.

Sources:
  * SyntheticSource — seeded token streams (markov-ish bytes) for substrate
    tests and the train example,
  * TextFileSource — newline-delimited UTF-8 documents, byte-tokenized.

Documents are packed into fixed-length sequences (cross-doc packing with EOS
separators, labels = next token).  Batches are a pure function of
(step, shard_id, num_shards, seed) so a restart at step N reproduces the
exact stream without replaying N steps, and every data-parallel host pulls
disjoint data — the standard large-run determinism/resume contract.

``Prefetcher`` overlaps host-side batch assembly with device compute and
implements a straggler guard: if a batch misses its deadline the prefetch
thread is abandoned and the batch is rebuilt synchronously (on a cluster:
re-fetch from a healthy storage replica).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable

import numpy as np

from repro_torch.data.tokenizer import TOKENIZER


class SyntheticSource:
    """Deterministic pseudo-text token documents."""

    def __init__(self, seed: int = 0, mean_len: int = 512):
        self.seed = seed
        self.mean_len = mean_len

    def doc_tokens(self, doc_id: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, doc_id))
        n = int(rng.integers(self.mean_len // 2, self.mean_len * 2))
        # byte-range tokens with local structure (random walk over bytes)
        steps = rng.integers(-3, 4, n)
        toks = np.cumsum(steps) % 96 + 32
        return toks.astype(np.int32)


class TextFileSource:
    def __init__(self, path: str):
        with open(path, encoding="utf-8") as f:
            self.docs = [l.rstrip("\n") for l in f if l.strip()]

    def doc_tokens(self, doc_id: int) -> np.ndarray:
        text = self.docs[doc_id % len(self.docs)]
        return np.asarray(TOKENIZER.encode(text, bos=False), np.int32)


def packed_batch(source, step: int, *, batch: int, seq_len: int,
                 shard_id: int = 0, num_shards: int = 1, seed: int = 0) -> dict:
    """Pure function of (step, shard) -> {"tokens": [b,S], "labels": [b,S]}."""
    rows = []
    for b in range(batch):
        stream_id = (step * batch + b) * num_shards + shard_id
        rng = np.random.default_rng((seed, stream_id))
        buf: list[int] = [TOKENIZER.bos_id]
        doc = int(rng.integers(0, 2**31 - 1))
        while len(buf) < seq_len + 1:
            toks = source.doc_tokens(doc)
            buf.extend(toks.tolist())
            buf.append(TOKENIZER.eos_id)
            doc += 1
        arr = np.asarray(buf[: seq_len + 1], np.int32)
        rows.append(arr)
    mat = np.stack(rows)
    return {"tokens": mat[:, :-1], "labels": mat[:, 1:]}


class Prefetcher:
    """Host-side prefetch with a straggler deadline."""

    def __init__(self, make_batch: Callable[[int], dict], *, depth: int = 2,
                 deadline_s: float = 30.0):
        self.make_batch = make_batch
        self.deadline_s = deadline_s
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._next_to_schedule = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self.stragglers = 0

    def start(self, from_step: int = 0) -> "Prefetcher":
        self._next_to_schedule = from_step
        self._thread.start()
        return self

    def _work(self) -> None:
        while not self._stop.is_set():
            step = self._next_to_schedule
            batch = self.make_batch(step)
            self._next_to_schedule += 1
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue

    def get(self, step: int) -> dict:
        try:
            got_step, batch = self.q.get(timeout=self.deadline_s)
            if got_step == step:
                return batch
        except queue.Empty:
            pass
        # straggler path: rebuild deterministically, in-line
        self.stragglers += 1
        return self.make_batch(step)

    def stop(self) -> None:
        self._stop.set()
