"""IVF (inverted-file) ANN index: the pruned RetrievalBackend.

Build: spherical k-means (`index/kmeans.py`) coarse-quantizes the corpus
into ``n_clusters`` inverted lists, laid out as padded per-cluster tiles
``store [kc, L, d]`` (L = max cluster size rounded up to the 128-lane
width) with a validity mask — the static-shape layout the CUDA cluster
scan (`kernels/ivf_scan.py`) gathers from.  The numpy arrays stay on the
host (persistence, ids, the top-k merge); their device copies — centroids,
tiles, scales and mask — are made with the store and swapped with it, so a
search uploads only its queries and the small delta buffer.

Search: every query is scored against its top-``nprobe`` clusters (by
centroid score) — work is O(sum of probed cluster sizes) instead of
O(corpus).  Queries are processed in blocks of ``block_q``; a block scans
the concatenation of its queries' probe lists, so each query additionally
sees its blockmates' clusters (recall can only improve; ``last_stats``
counts the unique clusters actually scanned).  ``nprobe`` is the recall
knob: the recall@k-vs-exact contract is measured (tests/test_index.py,
benchmarks/index_bench.py), and ``nprobe = n_clusters`` degenerates to
exact-identical results.

Streaming: ``add()`` appends rows to a *delta side buffer* instead of
rebuilding — the quantizer is untouched, and every search exact-scans the
(small) buffer alongside the probed clusters and merges top-k
(``kernels.ops.ivf_delta_search``; torch contract ``ref.ivf_delta_search_ref``).
Delta rows therefore have recall 1.0 by construction and base recall is
unchanged.  A drift detector watches the spill fraction
(|delta| / |clustered rows|): past ``spill_threshold`` the buffer is folded
in by retraining the quantizer over the full corpus — in a background
thread by default (searches keep running against the old store + buffer
until the atomic swap), synchronously with ``retrain="sync"``, or never
with ``retrain="off"``.  A sync retrain is bit-identical to a fresh build
over the concatenated corpus with the same seed/params (tests enforce it).

Quantization: ``quantize="int8"`` stores the tiles as symmetric per-vector
int8 (`index/quant.py`) — ``d + 4`` HBM bytes per scanned vector instead of
``4 * d`` — and the cluster scan dequantizes in-kernel
(`kernels/ivf_scan_q.py`).  Quantized scores rank a candidate pool of
``rerank_factor * k`` per query, which an exact fp32 rerank
(:meth:`_exact_rerank`, reading the raw ``self.vectors`` rows the index
already keeps) rescores before the final top-k — the measured recall@k
contract is preserved while the scan streams ~4x fewer bytes.  The delta
side buffer quantizes incrementally in ``add()``; retrains re-quantize from
the fp32 corpus, so no drift accumulates.  ``quantize="none"`` (default)
leaves every code path and result bit-identical to the unquantized index.
"""
from __future__ import annotations

import json
import os
import threading

import numpy as np
import torch

from repro_torch.device import current_device
from repro_torch.index.backend import (DEFAULT_RERANK_FACTOR, MASKED_SCORE,
                                 RetrievalBackend, default_n_clusters,
                                 nprobe_for_recall, train_sample_size)
from repro_torch.index.kmeans import kmeans
from repro_torch.index.quant import bytes_per_vector, quantize_rows, quantize_tiles
from repro_torch.obs import audit as _audit

_LANE = 128        # pad L to a multiple of 128, as the reference does, so
                   # the layout and the cluster capacity are the reference's
_BALANCE_FACTOR = 4  # cap cluster size at this multiple of the mean: every
                     # tile is padded to the LARGEST cluster, so one skewed
                     # list would otherwise inflate the whole store


class IVFIndex(RetrievalBackend):
    kind = "ivf"

    def __init__(self, vectors: np.ndarray, ids: list | None = None, *,
                 n_clusters: int | None = None, nprobe: int | None = None,
                 recall_target: float = 0.95, kmeans_iters: int = 10,
                 block_q: int = 8, seed: int = 0,
                 spill_threshold: float = 0.10, retrain: str = "background",
                 shards: int | None = None, quantize: str = "none",
                 rerank_factor: int = DEFAULT_RERANK_FACTOR,
                 _centroids: np.ndarray | None = None,
                 _assign: np.ndarray | None = None):
        super().__init__(vectors, ids)
        if quantize not in ("none", "int8"):
            raise ValueError(f"quantize={quantize!r} (expected 'none'|'int8')")
        self.quantize = quantize
        self.rerank_factor = max(int(rerank_factor), 1)
        # shards > 1 distributes the inverted-file tiles across devices and
        # scans probed clusters on their home device (ops.sharded_ivf_search)
        # — scores, and therefore results, are identical to unsharded
        self.shards = int(shards) if shards and shards > 1 else None
        if retrain not in ("background", "sync", "off"):
            raise ValueError(f"retrain={retrain!r} (expected "
                             "'background'|'sync'|'off')")
        norms = np.linalg.norm(self.vectors, axis=1, keepdims=True)
        unit = self.vectors / np.maximum(norms, 1e-9)
        n = len(unit)
        self._n_clusters_arg = n_clusters       # retrain re-derives from size
        self.n_clusters = min(n_clusters or default_n_clusters(n), max(n, 1))
        self.block_q = int(block_q)
        self.seed = seed
        self.kmeans_iters = kmeans_iters
        self.recall_target = recall_target
        self._nprobe_explicit = nprobe is not None
        self.spill_threshold = float(spill_threshold)
        self.retrain_mode = retrain
        self.retrains = 0
        self._retrain_thread: threading.Thread | None = None
        self._retrain_queued = False
        self._retrain_guard = threading.Lock()  # one retrain at a time
        d = unit.shape[1] if unit.ndim == 2 else 0
        self._delta_unit = np.zeros((0, d), np.float32)
        self._delta_pos = np.zeros(0, np.int64)
        self._delta_q = np.zeros((0, d), np.int8)
        self._delta_scales = np.zeros(0, np.float32)
        if _centroids is not None and _assign is not None:  # load() fast path
            self.centroids, self.assign = _centroids, _assign
        else:
            self.centroids, self.assign = self._train(unit)
        self.n_clusters = len(self.centroids)
        self.nprobe = int(nprobe if nprobe is not None
                          else nprobe_for_recall(self.n_clusters, recall_target))
        self._build_store(unit)

    def _train(self, unit: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """FAISS-style: train the quantizer on a subsample, then assign the
        full corpus in one pass (the cost model prices exactly this)."""
        n = len(unit)
        kc = min(self._n_clusters_arg or default_n_clusters(n), max(n, 1))
        train_n = train_sample_size(n, kc)
        if train_n < n:
            rng = np.random.default_rng(self.seed)
            sample = unit[rng.choice(n, size=train_n, replace=False)]
            centroids, _ = kmeans(sample, kc, iters=self.kmeans_iters,
                                  seed=self.seed)
            return centroids, self._assign_all(unit, centroids)
        return kmeans(unit, kc, iters=self.kmeans_iters, seed=self.seed)

    def _assign_all(self, unit: np.ndarray, centroids: np.ndarray | None = None,
                    chunk: int = 8192) -> np.ndarray:
        centroids = self.centroids if centroids is None else centroids
        out = np.empty(len(unit), np.int64)
        for s in range(0, len(unit), chunk):
            out[s:s + chunk] = np.argmax(unit[s:s + chunk] @ centroids.T,
                                         axis=1)
        return out

    def _cluster_cap(self, n: int) -> int:
        kc = max(self.n_clusters, 1)
        return max(_LANE, int(np.ceil(_BALANCE_FACTOR * n / kc)))

    def _rebalance(self, unit: np.ndarray, cap: int) -> None:
        """Bounded-capacity repair: move an oversized cluster's lowest-
        affinity members to their next-best centroid with room.  Every
        vector stays in exactly one list (the degenerate nprobe=all contract
        is untouched); only the inverted-list layout changes."""
        sizes = np.bincount(self.assign, minlength=self.n_clusters)
        overflow: list[int] = []
        for j in np.flatnonzero(sizes > cap):
            m = np.flatnonzero(self.assign == j)
            order = np.argsort(-(unit[m] @ self.centroids[j]))
            overflow.extend(m[order[cap:]].tolist())
            sizes[j] = cap
        for i in overflow:
            prefs = np.argsort(-(unit[i] @ self.centroids.T))
            dest = next(int(c) for c in prefs if sizes[c] < cap)
            self.assign[i] = dest
            sizes[dest] += 1

    def _build_store(self, unit: np.ndarray) -> None:
        kc = self.n_clusters
        cap = self._cluster_cap(len(unit))
        if len(unit) and np.bincount(self.assign, minlength=kc).max() > cap:
            self._rebalance(unit, cap)
        members = [np.flatnonzero(self.assign == j) for j in range(kc)]
        self.cluster_sizes = np.asarray([len(m) for m in members], np.int64)
        L = int(max(self.cluster_sizes.max(initial=1), 1))
        L = -(-L // _LANE) * _LANE
        d = unit.shape[1] if unit.ndim == 2 else 0
        store = np.zeros((kc, L, d), np.float32)
        self.store_mask = np.zeros((kc, L), np.float32)
        self.store_ids = np.full((kc, L), -1, np.int32)
        for j, m in enumerate(members):
            store[j, : len(m)] = unit[m]
            self.store_mask[j, : len(m)] = 1.0
            self.store_ids[j, : len(m)] = m
        if self.quantize == "int8":
            # quantized tiles replace the fp32 store entirely — the memory
            # saving is real, not a shadow copy; exact rerank reads the raw
            # corpus rows the base index already keeps (self.vectors)
            self.store_q, self.store_scales = quantize_tiles(store)
            self.store = None
        else:
            self.store = store
            self.store_q = self.store_scales = None
        self._upload()
        # worst-case probe floor: any m probed clusters hold at least the sum
        # of the m smallest lists, so k results need at most this many probes
        self._size_cumsum = np.cumsum(np.sort(self.cluster_sizes))

    def _upload(self) -> None:
        """Device copies of what a search scans, replaced as one dict so a
        search's snapshot never mixes two builds."""
        dev = current_device()
        up = lambda a: None if a is None else torch.from_numpy(a).to(dev)
        self._dev = {"centroids": up(self.centroids), "store": up(self.store),
                     "store_q": up(self.store_q),
                     "store_scales": up(self.store_scales),
                     "store_mask": up(self.store_mask)}

    def _min_probes(self, k: int, size_cumsum: np.ndarray,
                    n_delta: int) -> int:
        # the delta buffer is exact-scanned, so it supplies n_delta of the k
        # candidates for free; the probe floor only covers the remainder
        in_store = int(size_cumsum[-1]) if len(size_cumsum) else 0
        need = min(max(k - n_delta, 0), in_store)
        if need <= 0:
            return 1
        return int(np.searchsorted(size_cumsum, need) + 1)

    # -- streaming delta path ----------------------------------------------
    @property
    def n_clustered(self) -> int:
        """Rows covered by the trained quantizer (the rest sit in the delta
        side buffer)."""
        return len(self.vectors) - len(self._delta_pos)

    @property
    def delta_rows(self) -> int:
        return len(self._delta_pos)

    def drift(self) -> float:
        """Spill fraction: |delta buffer| / |clustered rows|."""
        with self._mut:
            return len(self._delta_pos) / max(self.n_clustered, 1)

    def add(self, vectors: np.ndarray, ids: list | None = None) -> None:
        """Append rows to the delta side buffer — O(delta), no rebuild.
        Past ``spill_threshold`` the drift detector triggers a retrain per
        ``retrain_mode`` (background by default)."""
        v = np.atleast_2d(np.asarray(vectors, np.float32))
        if not len(v):
            return
        with self._mut:
            start = len(self.vectors)
            self.vectors = np.concatenate([self.vectors, v]) if start else v.copy()
            self.ids.extend(list(ids) if ids is not None
                            else range(start, start + len(v)))
            unit = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-9)
            self._delta_unit = np.concatenate([self._delta_unit, unit]) \
                if len(self._delta_unit) else unit
            self._delta_pos = np.concatenate(
                [self._delta_pos, np.arange(start, start + len(v), dtype=np.int64)])
            if self.quantize == "int8":
                # quantize incrementally: per-vector scales are independent,
                # so appending never re-touches earlier buffer rows
                dq, dscales = quantize_rows(unit)
                self._delta_q = np.concatenate([self._delta_q, dq]) \
                    if len(self._delta_q) else dq
                self._delta_scales = np.concatenate(
                    [self._delta_scales, dscales])
            spill = len(self._delta_pos) / max(self.n_clustered, 1)
        if spill > self.spill_threshold and self.retrain_mode != "off":
            self.retrain(wait=self.retrain_mode == "sync")

    def retrain(self, wait: bool = True) -> None:
        """Fold the delta buffer into the quantizer: rebuild k-means +
        inverted lists over the full corpus (same seed/params => identical
        to a fresh build), then atomically swap stores.  ``wait=False``
        runs in a daemon thread; searches keep using the old store + buffer
        until the swap."""
        if wait:
            self._retrain()
            return
        with self._mut:
            if self._retrain_queued:
                return                          # one background retrain at a time
            self._retrain_queued = True
            t = threading.Thread(target=self._retrain, daemon=True,
                                 name="ivf-retrain")
            self._retrain_thread = t
        t.start()

    def _retrain(self) -> None:
        with self._retrain_guard:
            try:
                with self._mut:
                    vectors = self.vectors      # arrays are replaced, never
                    n = len(vectors)            # resized: safe to read outside
                if n == 0:
                    return
                unit = vectors / np.maximum(
                    np.linalg.norm(vectors, axis=1, keepdims=True), 1e-9)
                centroids, assign = self._train(unit)  # heavy part: unlocked
                with self._mut:
                    self.centroids, self.assign = centroids, assign
                    self.n_clusters = len(centroids)
                    if not self._nprobe_explicit:
                        self.nprobe = int(nprobe_for_recall(self.n_clusters,
                                                            self.recall_target))
                    self._build_store(unit)
                    keep = self._delta_pos >= n  # rows added mid-retrain stay
                    self._delta_unit = self._delta_unit[keep]
                    self._delta_pos = self._delta_pos[keep]
                    if self.quantize == "int8":
                        self._delta_q = self._delta_q[keep]
                        self._delta_scales = self._delta_scales[keep]
                    self.retrains += 1
            finally:
                with self._mut:
                    self._retrain_queued = False

    def wait_retrain(self, timeout: float | None = None) -> None:
        t = self._retrain_thread
        if t is not None and t.is_alive():
            t.join(timeout)

    # -- search ------------------------------------------------------------
    def search(self, queries: np.ndarray, k: int, *, nprobe: int | None = None,
               max_pos: int | None = None) -> tuple[np.ndarray, np.ndarray]:
        """``max_pos`` bounds results to positions < max_pos (the snapshot
        cutoff for version-pinned queries; see ``VectorIndex.search``)."""
        from repro_torch.kernels import ops as kops
        q = np.atleast_2d(np.asarray(queries, np.float32))
        nq = len(q)
        with self._mut:   # consistent (store, delta) snapshot vs add/retrain
            dev = self._dev   # the device copies of the arrays the scan reads
            centroids, store = dev["centroids"], dev["store"]
            store_q, store_scales = dev["store_q"], dev["store_scales"]
            store_mask, store_ids = dev["store_mask"], self.store_ids
            cluster_sizes, size_cumsum = self.cluster_sizes, self._size_cumsum
            delta_unit, delta_pos = self._delta_unit, self._delta_pos
            delta_q, delta_scales = self._delta_q, self._delta_scales
            n_clusters, nprobe_default = self.n_clusters, self.nprobe
            vectors, n_total = self.vectors, len(self.vectors)
        quantized = self.quantize == "int8"
        d = q.shape[1] if q.ndim == 2 else 0
        nd = len(delta_pos)
        k = min(k, n_total if max_pos is None else min(n_total, max_pos))
        # only delta rows inside the snapshot cutoff count toward the probe
        # floor: rows beyond it are filtered out of the top-k
        nd_floor = nd if max_pos is None else int((delta_pos < max_pos).sum())
        if nq == 0:  # an upstream operator emptied the query side
            self.last_stats = {"index": self.kind, "scored_vectors": 0,
                               "probed_clusters": 0, "nprobe": 0,
                               "n_clusters": int(n_clusters), "delta_rows": nd,
                               "quantize": self.quantize, "scanned_bytes": 0,
                               "reranked": 0}
            return np.zeros((0, k), np.float32), np.zeros((0, k), np.int64)
        # the quantized scan ranks a wider candidate pool so the exact fp32
        # rerank has headroom to repair int8 ranking error around the top-k
        k_cand = min(self.rerank_factor * k, n_total) if quantized else k
        nprobe_eff = min(max(nprobe or nprobe_default,
                             self._min_probes(k_cand, size_cumsum, nd_floor)),
                         n_clusters)
        # accounting uses the split the dispatch actually runs (clamped to
        # the device count on the shard_map path)
        shards = None
        if self.shards and n_clusters >= self.shards:
            shards = kops.effective_shards(self.shards)
            shards = shards if shards > 1 else None
        if shards:
            # sharded probed-cluster scan; the (small) delta side buffer is
            # exact-scanned and concatenated, exactly like
            # ops.ivf_delta_search assembles it
            if quantized:
                scores, probe_blocks = kops.sharded_ivf_search_q(
                    q, centroids, store_q, store_scales, store_mask,
                    nprobe=nprobe_eff, shards=shards, block_q=self.block_q)
            else:
                scores, probe_blocks = kops.sharded_ivf_search(
                    q, centroids, store, store_mask,
                    nprobe=nprobe_eff, shards=shards, block_q=self.block_q)
            if nd:
                if quantized:
                    from repro_torch.index.quant import quantized_scores
                    qn = q / np.maximum(
                        np.linalg.norm(q, axis=1, keepdims=True), 1e-9)
                    ds = quantized_scores(qn, delta_q, delta_scales)
                else:
                    ds = kops.similarity(q, delta_unit)
                scores = np.concatenate(
                    [scores, np.asarray(ds, np.float32)], axis=1)
        elif nd:
            if quantized:
                scores, probe_blocks = kops.ivf_delta_search_q(
                    q, centroids, store_q, store_scales, store_mask,
                    delta_q, delta_scales,
                    nprobe=nprobe_eff, block_q=self.block_q)
            else:
                scores, probe_blocks = kops.ivf_delta_search(
                    q, centroids, store, store_mask, delta_unit,
                    nprobe=nprobe_eff, block_q=self.block_q)
        elif quantized:
            scores, probe_blocks = kops.ivf_search_q(
                q, centroids, store_q, store_scales, store_mask,
                nprobe=nprobe_eff, block_q=self.block_q)
        else:
            scores, probe_blocks = kops.ivf_search(
                q, centroids, store, store_mask,
                nprobe=nprobe_eff, block_q=self.block_q)
        # candidate ids per block: the probed clusters' rows (broadcast to
        # every query row in the block) plus the delta buffer's positions
        cand_ids = store_ids[probe_blocks].reshape(len(probe_blocks), -1)
        if nd:
            cand_ids = np.concatenate(
                [cand_ids,
                 np.broadcast_to(delta_pos, (len(probe_blocks), nd))], axis=1)
        out_s, out_i = self._topk_unique(scores, cand_ids, k_cand,
                                         max_pos=max_pos)
        reranked = 0
        if quantized:
            out_s, out_i, reranked = self._exact_rerank(q, out_s, out_i, k,
                                                        vectors)

        scored = nq * nd
        probed_unique = 0
        local_kc = -(-n_clusters // shards) if shards else n_clusters
        per_shard = np.zeros(shards or 1, np.int64)
        for b in range(len(probe_blocks)):
            real_q = min(nq - b * self.block_q, self.block_q)
            uniq = np.unique(probe_blocks[b])
            probed_unique += len(uniq)
            scored += real_q * int(cluster_sizes[uniq].sum())
            if shards:  # each cluster is scanned by its home device only
                np.add.at(per_shard, uniq // local_kc,
                          real_q * cluster_sizes[uniq])
        # dtype-aware bytes streamed through the scan: every scored vector
        # costs its stored width, plus (int8 only) the fp32 rows the exact
        # rerank re-reads from the raw corpus
        scanned_bytes = scored * bytes_per_vector(d, self.quantize)
        if quantized:
            scanned_bytes += reranked * bytes_per_vector(d, "none")
        self.last_stats = {"index": self.kind, "scored_vectors": scored,
                           "probed_clusters": int(probed_unique),
                           "nprobe": int(nprobe_eff),
                           "n_clusters": int(n_clusters),
                           "delta_rows": nd, "delta_scored": nq * nd,
                           "quantize": self.quantize,
                           "scanned_bytes": int(scanned_bytes),
                           "reranked": int(reranked)}
        if shards:
            self.last_stats.update(
                shards=int(shards),
                scored_vectors_per_shard=int(per_shard.max()) + nq * nd)
        # guarantee auditing: a budgeted sample of these queries gets an
        # exact re-scan of the same snapshot (vectors is the under-lock
        # reference; appends/retrain replace the arrays, never mutate them),
        # estimating live recall@k against recall_target — covering the
        # delta-buffer and int8 paths by construction
        _audit.emit_search(self, q, out_s, out_i, k,
                           vectors=vectors,
                           n_cut=n_total if max_pos is None
                           else min(n_total, max_pos),
                           recall_target=self.recall_target)
        return out_s, out_i

    def _topk_unique(self, scores: np.ndarray, cand_ids: np.ndarray, k: int,
                     max_pos: int | None = None
                     ) -> tuple[np.ndarray, np.ndarray]:
        """Per-query top-k over the scanned candidates, deduplicating rows a
        block scanned more than once (identical scores, so dedup is safe).
        ``scores`` has one row per query, ``cand_ids`` one row per block."""
        nq = len(scores)
        out_s = np.full((nq, k), MASKED_SCORE, np.float32)
        out_i = np.zeros((nq, k), np.int64)
        # a candidate id repeats at most block_q times (once per blockmate's
        # probe list; delta-buffer candidates appear exactly once), so the
        # top k*block_q scores are guaranteed to hold k unique ids —
        # argpartition to that bound instead of sorting the whole slots*L
        # row (which can exceed the corpus size).  A max_pos cutoff
        # invalidates an unbounded number of top candidates, so that (rare,
        # race-window) path sorts the full row instead.
        limit = np.inf if max_pos is None else max_pos
        for r in range(nq):
            row = scores[r]
            row_ids = cand_ids[r // self.block_q]
            bound = len(row) if max_pos is not None \
                else min(len(row), k * self.block_q)
            part = np.argpartition(-row, bound - 1)[:bound] \
                if bound < len(row) else np.arange(len(row))
            order = part[np.argsort(-row[part], kind="stable")]
            seen: set[int] = set()
            c = 0
            for t in order:
                i = int(row_ids[t])
                if i < 0 or i >= limit or i in seen:
                    continue
                seen.add(i)
                out_s[r, c] = row[t]
                out_i[r, c] = i
                c += 1
                if c == k:
                    break
        return out_s, out_i

    def _exact_rerank(self, q: np.ndarray, cand_s: np.ndarray,
                      cand_i: np.ndarray, k: int, vectors: np.ndarray
                      ) -> tuple[np.ndarray, np.ndarray, int]:
        """Exact fp32 rescore of the quantized candidate pool: gather the raw
        corpus rows for each query's top ``rerank_factor*k`` int8 candidates,
        rescore them in full precision (unit rows x unit query — the same
        math the fp32 scan computes), keep the top ``k``.  Returned *scores*
        are therefore exact; int8 error only survives in which rows made the
        candidate pool, which the pool's width absorbs.  -> (scores [nq, k],
        ids [nq, k], total rows reranked)."""
        nq = len(q)
        qn = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-9)
        out_s = np.full((nq, k), MASKED_SCORE, np.float32)
        out_i = np.zeros((nq, k), np.int64)
        reranked = 0
        for r in range(nq):
            valid = cand_s[r] > MASKED_SCORE / 2
            ids = cand_i[r][valid].astype(np.int64)
            if not len(ids):
                continue
            rows = vectors[ids]
            rows = rows / np.maximum(
                np.linalg.norm(rows, axis=1, keepdims=True), 1e-9)
            exact = (rows @ qn[r]).astype(np.float32)
            order = np.argsort(-exact, kind="stable")[:k]
            out_s[r, : len(order)] = exact[order]
            out_i[r, : len(order)] = ids[order]
            reranked += len(ids)
        return out_s, out_i, reranked

    def pairwise(self, queries: np.ndarray) -> np.ndarray:
        """Exact full matrix (proxy-calibration consumers need every score)."""
        from repro_torch.kernels import ops as kops
        return kops.similarity(np.asarray(queries, np.float32), self.vectors)

    def describe(self) -> dict:
        out = {**super().describe(), "n_clusters": int(self.n_clusters),
               "nprobe": int(self.nprobe), "block_q": self.block_q,
               "delta_rows": self.delta_rows, "retrains": self.retrains,
               "spill_threshold": self.spill_threshold,
               "quantize": self.quantize}
        if self.quantize == "int8":
            out["rerank_factor"] = self.rerank_factor
            d = self.vectors.shape[1] if self.vectors.ndim == 2 else 0
            out["bytes_per_vector"] = bytes_per_vector(d, self.quantize)
        if self.shards:
            out["shards"] = self.shards
        return out

    # -- persistence -------------------------------------------------------
    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with self._mut:
            vectors, ids = self.vectors, list(self.ids)
            centroids, assign = self.centroids, self.assign
            n_base = self.n_clustered
        np.save(os.path.join(path, "vectors.npy"), vectors)
        np.save(os.path.join(path, "centroids.npy"), centroids)
        np.save(os.path.join(path, "assign.npy"), assign.astype(np.int32))
        if self.quantize == "int8":
            with self._mut:
                np.save(os.path.join(path, "store_q.npy"), self.store_q)
                np.save(os.path.join(path, "store_scales.npy"),
                        self.store_scales)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"kind": self.kind, "ids": ids,
                       "dim": int(vectors.shape[1]),
                       "n_clusters": int(self.n_clusters),
                       "nprobe": int(self.nprobe), "block_q": self.block_q,
                       "seed": self.seed, "n_base": int(n_base),
                       "spill_threshold": self.spill_threshold,
                       "retrain": self.retrain_mode,
                       "shards": self.shards,
                       "quantize": self.quantize,
                       "rerank_factor": self.rerank_factor}, f)

    @classmethod
    def load(cls, path: str) -> "IVFIndex":
        vectors = np.load(os.path.join(path, "vectors.npy"))
        centroids = np.load(os.path.join(path, "centroids.npy"))
        assign = np.load(os.path.join(path, "assign.npy")).astype(np.int64)
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        n_base = meta.get("n_base", len(vectors))
        idx = cls(vectors[:n_base], meta["ids"][:n_base],
                  n_clusters=meta["n_clusters"], nprobe=meta["nprobe"],
                  block_q=meta["block_q"], seed=meta.get("seed", 0),
                  spill_threshold=meta.get("spill_threshold", 0.10),
                  retrain=meta.get("retrain", "background"),
                  shards=meta.get("shards"),
                  quantize=meta.get("quantize", "none"),
                  rerank_factor=meta.get("rerank_factor",
                                         DEFAULT_RERANK_FACTOR),
                  _centroids=centroids, _assign=assign)
        if idx.quantize == "int8":
            # the persisted int8 store + scales are authoritative (the
            # rebuild above re-derives identical arrays — quantization is
            # deterministic — but round-tripping the saved bytes keeps the
            # on-disk format the contract, not an implementation detail)
            idx.store_q = np.load(os.path.join(path, "store_q.npy"))
            idx.store_scales = np.load(os.path.join(path, "store_scales.npy"))
            idx._upload()
        if n_base < len(vectors):  # restore the unmerged delta side buffer
            mode, idx.retrain_mode = idx.retrain_mode, "off"
            idx.add(vectors[n_base:], meta["ids"][n_base:])
            idx.retrain_mode = mode
        return idx


def ivf_from_arrays(vectors: np.ndarray, centroids: np.ndarray,
                    assign: np.ndarray, ids: list | None = None,
                    **params) -> IVFIndex:
    """Build the port's index from a trained quantizer's numpy state — the
    ``centroids`` and ``assign`` arrays of a ``repro`` ``IVFIndex`` (or any
    other) — without re-running k-means: the constructor's load() fast
    path.  ``params`` are the constructor's keywords (``nprobe``,
    ``quantize``, ...); given the same ones the two indexes answer alike."""
    # copies: the build may rebalance ``assign`` in place
    return IVFIndex(vectors, ids, _centroids=np.array(centroids, np.float32),
                    _assign=np.array(assign, np.int64), **params)
