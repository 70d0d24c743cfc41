"""Exact brute-force vector index (the FAISS flat analogue, §4: sem_index).

The gold RetrievalBackend: scores the full corpus per query.  Embeddings are
unit vectors; scores are inner products computed with the CUDA similarity
kernel (`repro_torch.kernels.similarity`) over a copy of the corpus that the
index keeps on its device, and with the kernel's plain version when the
port runs on the CPU.  Indices persist to disk (sem_index / load_sem_index)
in the same format as ``repro``'s, so each package loads the other's.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.device import current_device
from repro_torch.index.backend import RetrievalBackend


def _similarity(queries: np.ndarray, corpus) -> np.ndarray:
    from repro_torch.kernels import ops as kops
    return kops.similarity(queries, corpus)


class VectorIndex(RetrievalBackend):
    kind = "exact"

    def __init__(self, vectors: np.ndarray, ids: list | None = None, *,
                 shards: int | None = None):
        """``shards`` > 1 routes searches through the device-sharded scan
        (``ops.sharded_search``: corpus rows split across the mesh, per-shard
        top-k merged on host) — result-identical to the single-device scan,
        with per-device work cut to ``n/shards`` rows per query."""
        super().__init__(vectors, ids)
        self.shards = int(shards) if shards and shards > 1 else None
        self._dev: tuple[np.ndarray, torch.Tensor] | None = None
        self._device_vectors(self.vectors)

    def _device_vectors(self, vectors: np.ndarray) -> torch.Tensor:
        """The device copy of ``vectors``, uploaded once per array: add()
        replaces the array (never resizes it), so the first search after an
        add() sees a new array object and uploads it."""
        dev = self._dev
        if dev is None or dev[0] is not vectors:
            dev = (vectors, torch.from_numpy(vectors).to(current_device()))
            self._dev = dev
        return dev[1]

    def search(self, queries: np.ndarray, k: int, *, max_pos: int | None = None
               ) -> tuple[np.ndarray, np.ndarray]:
        """-> (scores [nq, k], indices [nq, k]) by inner product.

        ``max_pos`` bounds results to positions < max_pos — the snapshot
        cutoff for version-pinned queries over a shared stream index that a
        concurrent commit may have grown mid-query (positions are
        append-ordered, so the cutoff is a prefix)."""
        if self.shards and self.shards >= 2 and max_pos is None \
                and len(self.vectors) >= 2 * self.shards and len(queries):
            return self._search_sharded(np.asarray(queries, np.float32), k)
        vectors = self.vectors
        sims = _similarity(np.asarray(queries, np.float32),
                           self._device_vectors(vectors))
        if max_pos is not None and max_pos < sims.shape[1]:
            sims = sims[:, :max_pos]
        k = min(k, sims.shape[1])
        part = np.argpartition(-sims, k - 1, axis=1)[:, :k]
        psims = np.take_along_axis(sims, part, axis=1)
        order = np.argsort(-psims, axis=1)
        idx = np.take_along_axis(part, order, axis=1)
        d = vectors.shape[1] if vectors.ndim == 2 else 0
        self.last_stats = {"index": self.kind,
                           "scored_vectors": int(sims.shape[0] * sims.shape[1]),
                           "probed_clusters": 0, "quantize": "none",
                           "scanned_bytes": int(sims.shape[0] * sims.shape[1]
                                                * 4 * d)}
        return np.take_along_axis(sims, idx, axis=1), idx

    def _search_sharded(self, queries: np.ndarray, k: int
                        ) -> tuple[np.ndarray, np.ndarray]:
        from repro_torch.kernels import ops as kops
        with self._mut:  # consistent snapshot vs concurrent add()
            vectors = self.vectors
        scores, idx = kops.sharded_search(queries, self._device_vectors(vectors),
                                          k, shards=self.shards)
        nq, nc = len(queries), len(vectors)
        # the dispatch may clamp to the device count: report the split that
        # actually ran, not the requested layout
        eff = kops.effective_shards(self.shards)
        d = vectors.shape[1] if vectors.ndim == 2 else 0
        self.last_stats = {
            "index": self.kind, "scored_vectors": int(nq * nc),
            "probed_clusters": 0, "shards": eff, "quantize": "none",
            "scanned_bytes": int(nq * nc * 4 * d),
            "scored_vectors_per_shard": int(nq * (-(-nc // max(eff, 1))))}
        return scores, idx

    def pairwise(self, queries: np.ndarray) -> np.ndarray:
        return _similarity(np.asarray(queries, np.float32),
                           self._device_vectors(self.vectors))

    def describe(self) -> dict:
        out = super().describe()
        if self.shards:
            out["shards"] = self.shards
        return out

    # -- persistence (sem_index / load_sem_index) -------------------------
    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        np.save(os.path.join(path, "vectors.npy"), self.vectors)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"kind": self.kind, "ids": self.ids,
                       "dim": int(self.vectors.shape[1]),
                       "shards": self.shards}, f)

    @classmethod
    def load(cls, path: str) -> "VectorIndex":
        vectors = np.load(os.path.join(path, "vectors.npy"))
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        return cls(vectors, meta["ids"], shards=meta.get("shards"))
