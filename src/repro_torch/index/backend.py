"""RetrievalBackend: the one interface every similarity consumer goes
through (§4.2 — sim-search operators are where vector-search optimizations
plug into the engine).

Two implementations:

  * ``VectorIndex`` (``index/vector_index.py``) — exact brute-force scan,
    the gold reference; scores every corpus vector per query.
  * ``IVFIndex``    (``index/ivf_index.py``)    — spherical-k-means inverted
    file with ``nprobe`` cluster pruning; scores only the probed clusters'
    vectors through the CUDA cluster-scan kernel.

Consumers (sem_search / sem_sim_join / the join sim-prefilter / sem_group_by
center scoring / sem_topk pivot selection) never touch vectors directly:
they ``build_index(...)`` (or receive one from the plan layer / the serving
``IndexRegistry``) and call ``search``/``pairwise``.  ``last_stats`` exposes
per-search accounting (scored vectors, probed clusters) so operators can
attribute retrieval cost, and ``choose_backend`` is the shared cost model
the plan optimizer and the executor use to pick exact vs IVF per node.
"""
from __future__ import annotations

import abc
import hashlib
import json
import math
import os
import threading

import numpy as np

# cost-model constants (FLOP-proportional units: one unit = scoring one
# corpus vector against one query)
IVF_MIN_CORPUS = 2048        # below this an exact scan is always cheaper
IVF_BUILD_ITERS = 10         # k-means sweeps priced into the build
IVF_TRAIN_PER_CLUSTER = 64   # quantizer trains on <= this many points/cluster
IVF_BUILD_QUERIES = 10_000   # queries a built index amortizes over (the
                             # registry shares builds across serve sessions,
                             # so serving traffic, not one call, pays it)
MIN_PROBE_FRAC = 0.02        # recall floor: never probe fewer clusters
SHARD_MIN_CORPUS = 4096      # below this a device-sharded scan can't pay
                             # the shard_map dispatch + host merge overhead
QUANT_MIN_CORPUS = 8192      # below this the exact-rerank overhead eats the
                             # int8 byte win (and fp32 tiles fit anyway)
NOMINAL_DIM = 64             # byte-cost dim when the plan layer doesn't know
                             # the embedding width (embeddings don't exist at
                             # plan time); only the fp32/int8 *ratio* matters
                             # for the decision, and that is dim-insensitive
DEFAULT_RERANK_FACTOR = 4    # quantized scan keeps rerank_factor*k
                             # candidates for the exact fp32 rerank

# score written to masked padding lanes / unfilled slots (finite, the
# reference's value).  Canonical home is here (numpy-only module) so the IVF
# index and the operator layer never pay a torch import just to read the
# constant; the kernels and their contracts (repro_torch.kernels.ref) import
# it from here.
MASKED_SCORE = -1e30


def exact_topk(vectors: np.ndarray, queries: np.ndarray, k: int
               ) -> tuple[np.ndarray, np.ndarray]:
    """Brute-force exact top-k by unit-normalized inner product.

    Shared gold reference for the guarantee auditor's sampled recall@k
    re-scans (and anything else needing a small exact answer without
    building a ``VectorIndex``).  Pure numpy: never billed, safe on the
    audit worker thread.  -> (scores [nq, k], indices [nq, k]) descending.
    """
    v = np.atleast_2d(np.asarray(vectors, np.float32))
    q = np.atleast_2d(np.asarray(queries, np.float32))
    v = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-9)
    q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-9)
    k = max(1, min(int(k), len(v)))
    scores = q @ v.T                                  # [nq, nc]
    part = np.argpartition(-scores, k - 1, axis=1)[:, :k]
    rows = np.arange(len(q))[:, None]
    order = np.argsort(-scores[rows, part], axis=1, kind="stable")
    idx = part[rows, order]
    return scores[rows, idx], idx


def train_sample_size(n_corpus: int, n_clusters: int) -> int:
    """Quantizer training subsample (FAISS-style): k-means sees at most
    ``IVF_TRAIN_PER_CLUSTER`` points per centroid; the full corpus is only
    assigned once afterwards."""
    return min(n_corpus, max(2048, IVF_TRAIN_PER_CLUSTER * n_clusters))


class RetrievalBackend(abc.ABC):
    """Uniform search surface over an embedded corpus."""

    kind: str = "abstract"

    def __init__(self, vectors: np.ndarray, ids: list | None = None):
        self.vectors = np.asarray(vectors, np.float32)
        self.ids = list(range(len(self.vectors))) if ids is None else list(ids)
        self._tls = threading.local()
        # serializes add()/retrain mutations; searches snapshot references
        # under it (registry-shared indexes are read by many sessions while
        # the streaming layer appends deltas)
        self._mut = threading.Lock()

    @property
    def last_stats(self) -> dict:
        """Per-search accounting ({"index", "scored_vectors",
        "probed_clusters", ...}), read by operators right after search().
        Thread-local: registry-shared indexes are searched concurrently by
        many serve sessions and each must see its own numbers."""
        return getattr(self._tls, "stats", {})

    @last_stats.setter
    def last_stats(self, value: dict) -> None:
        self._tls.stats = value

    def __len__(self) -> int:
        return len(self.vectors)

    @abc.abstractmethod
    def search(self, queries: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
        """-> (scores [nq, k], indices [nq, k]) by inner product, descending."""

    def add(self, vectors: np.ndarray, ids: list | None = None) -> None:
        """Append corpus rows; positions continue from ``len(self)``, so an
        appends-only corpus delta keeps index position == snapshot row.
        The exact backend searches the concatenated corpus directly; the IVF
        backend overrides this with a delta side buffer + drift retrain."""
        v = np.atleast_2d(np.asarray(vectors, np.float32))
        if not len(v):
            return
        with self._mut:
            start = len(self.vectors)
            self.vectors = np.concatenate([self.vectors, v]) if start else v.copy()
            self.ids.extend(list(ids) if ids is not None
                            else range(start, start + len(v)))

    @abc.abstractmethod
    def pairwise(self, queries: np.ndarray) -> np.ndarray:
        """Exact full score matrix [nq, nc] (proxy-scoring consumers)."""

    def describe(self) -> dict:
        return {"kind": self.kind, "size": len(self),
                "dim": int(self.vectors.shape[1]) if self.vectors.size else 0}

    @abc.abstractmethod
    def save(self, path: str) -> None: ...


# ---------------------------------------------------------------------------
# Construction / persistence dispatch
# ---------------------------------------------------------------------------


def choose_shards(n_corpus: int, device_count: int, *,
                  requested: int | None = None,
                  min_corpus: int = SHARD_MIN_CORPUS) -> int:
    """Shard layout for a corpus: an explicit request is honored (clamped to
    the device count); otherwise shard across every device once the corpus
    is big enough to amortize the per-device dispatch.  1 = unsharded."""
    if requested is not None:
        return max(1, min(int(requested), max(device_count, 1)))
    if device_count <= 1 or n_corpus < min_corpus:
        return 1
    return device_count


def build_index(vectors: np.ndarray, ids: list | None = None, *,
                kind: str = "exact", **kw) -> RetrievalBackend:
    from repro_torch.index.ivf_index import IVFIndex
    from repro_torch.index.vector_index import VectorIndex
    if kind == "auto":
        # an explicitly built index (sem_index) exists to be searched many
        # times / persisted, so price the build amortized over its lifetime
        kind, nprobe = choose_backend(len(vectors), n_queries=1, shared=True)
        if kind == "ivf":
            kw.setdefault("nprobe", nprobe)
    if kind == "exact":
        return VectorIndex(vectors, ids, shards=kw.get("shards"))
    if kind == "ivf":
        return IVFIndex(vectors, ids, **kw)
    raise ValueError(f"unknown index kind {kind!r} (expected 'exact'|'ivf'|'auto')")


def load_index(path: str) -> RetrievalBackend:
    """Load a persisted index of either format (meta.json carries the kind;
    pre-RetrievalBackend directories without one are exact)."""
    from repro_torch.index.ivf_index import IVFIndex
    from repro_torch.index.vector_index import VectorIndex
    with open(os.path.join(path, "meta.json")) as f:
        kind = json.load(f).get("kind", "exact")
    return {"exact": VectorIndex, "ivf": IVFIndex}[kind].load(path)


# ---------------------------------------------------------------------------
# Cost model (shared by the plan optimizer and the executor's "auto" path)
# ---------------------------------------------------------------------------


def default_n_clusters(n_corpus: int) -> int:
    """FAISS-style sqrt(n) coarse quantizer size."""
    return int(min(max(8, round(math.sqrt(max(n_corpus, 1)))), 4096))


# empirical recall@k -> probe-fraction curve on clustered corpora; strongly
# concave (the last few points of recall cost most of the clusters), tuned
# against benchmarks/index_bench.py and verified there at every run
_RECALL_FRAC = ((0.80, 0.02), (0.90, 0.05), (0.95, 0.10),
                (0.99, 0.20), (1.00, 0.50))


def nprobe_for_recall(n_clusters: int, recall_target: float) -> int:
    """Map the recall knob onto a probed-cluster count by linear
    interpolation between the calibration points (a target between two
    points pays a proportional probe fraction instead of jumping to the
    next point's — recall_target=0.91 probes ~6%, not the 0.95 point's 10%);
    ``recall_target=1.0`` demands every cluster (exact-identical results)."""
    if recall_target >= 1.0:
        return n_clusters
    if recall_target <= _RECALL_FRAC[0][0]:
        frac = _RECALL_FRAC[0][1]
    else:
        frac = _RECALL_FRAC[-1][1]
        for (r0, f0), (r1, f1) in zip(_RECALL_FRAC, _RECALL_FRAC[1:]):
            if recall_target <= r1:
                frac = f0 + (recall_target - r0) / (r1 - r0) * (f1 - f0)
                break
    frac = max(MIN_PROBE_FRAC, frac)
    # epsilon absorbs float noise from the interpolation (0.06*200 must be
    # 12 probes, not ceil(12.000000000000002) = 13)
    return max(1, min(n_clusters, math.ceil(frac * n_clusters - 1e-9)))


def retrieval_costs(n_corpus: int, n_queries: int, *,
                    recall_target: float = 0.95, shared: bool = False,
                    k: int = 10, dim: int = NOMINAL_DIM,
                    rerank_factor: int = DEFAULT_RERANK_FACTOR) -> dict:
    """Byte-aware costs of serving ``n_queries`` over ``n_corpus``: exact
    scan vs fp32 IVF vs int8 IVF + exact rerank.

    The scan hot loop is memory-bound, so the cost unit is *one fp32 vector
    streamed from HBM per query* (``4*dim`` bytes); an int8 vector streams
    ``dim + 4`` bytes (payload + its f32 scale;
    ``repro_torch.index.quant.bytes_per_vector``) and therefore costs a fraction
    of a unit, but every query additionally pays ``rerank_factor * k`` fp32
    rescans for the exact rerank that restores the recall contract.  Build
    costs stay FLOP-proportional in the same unit (one unit = one
    vector-vs-query score), exactly as before — quantization adds one cheap
    streaming pass (``0.25 * n_corpus`` units).

    ``shared=True`` models a registry-backed build reused across sessions:
    this batch is charged its per-query share of the build assuming
    ``IVF_BUILD_QUERIES`` lifetime queries.  ``shared=False`` (no registry:
    the index dies with the call) charges the whole build to this batch.

    Returns units (``exact`` / ``ivf`` / ``ivf_q``) plus the raw scanned
    bytes per query (``*_bytes_per_query``) for explain output."""
    from repro_torch.index.quant import bytes_per_vector
    kc = default_n_clusters(n_corpus)
    nprobe = nprobe_for_recall(kc, recall_target)
    avg_cluster = n_corpus / max(kc, 1)
    fp32_vec = bytes_per_vector(dim, "none")
    int8_frac = bytes_per_vector(dim, "int8") / fp32_vec  # ~0.27 at d=64
    exact = float(n_queries * n_corpus)
    train = train_sample_size(n_corpus, kc)
    build = float(train * kc * IVF_BUILD_ITERS + n_corpus * kc)
    # one cheap streaming quant pass on top of the k-means build; amortizes
    # over serving traffic exactly like the rest of the build
    build_q = build + 0.25 * n_corpus
    if shared:
        build *= n_queries / IVF_BUILD_QUERIES
        build_q *= n_queries / IVF_BUILD_QUERIES
    scanned = kc + nprobe * avg_cluster            # vectors per query
    scan = n_queries * scanned
    # quantized: centroids stay fp32 (tiny), probed tiles stream at the int8
    # fraction, and the rerank exact-rescans rerank_factor*k rows per query
    rerank = min(rerank_factor * k, nprobe * avg_cluster)
    scan_q = n_queries * (kc + int8_frac * nprobe * avg_cluster + rerank)
    return {"exact": exact, "ivf": build + scan, "ivf_q": build_q + scan_q,
            "n_clusters": kc, "nprobe": nprobe,
            "exact_bytes_per_query": n_corpus * fp32_vec,
            "ivf_bytes_per_query": scanned * fp32_vec,
            "ivf_q_bytes_per_query": (kc * fp32_vec
                                      + nprobe * avg_cluster
                                      * bytes_per_vector(dim, "int8")
                                      + rerank * fp32_vec)}


def choose_backend(n_corpus: int, n_queries: int, *,
                   recall_target: float = 0.95,
                   min_corpus: int = IVF_MIN_CORPUS,
                   shared: bool = False) -> tuple[str, int | None]:
    """-> ("exact", None) or ("ivf", nprobe)."""
    if n_corpus < min_corpus or recall_target >= 1.0:
        return "exact", None
    c = retrieval_costs(n_corpus, n_queries, recall_target=recall_target,
                        shared=shared)
    if c["ivf"] < c["exact"]:
        return "ivf", c["nprobe"]
    return "exact", None


def choose_retrieval_config(n_corpus: int, n_queries: int, *,
                            recall_target: float = 0.95,
                            min_corpus: int = IVF_MIN_CORPUS,
                            shared: bool = False, quantize: str = "auto",
                            min_quant_corpus: int = QUANT_MIN_CORPUS,
                            k: int = 10,
                            rerank_factor: int = DEFAULT_RERANK_FACTOR) -> dict:
    """Full retrieval choice: backend kind + nprobe + tile precision.

    Extends :func:`choose_backend` with the byte/recall trade: when IVF wins
    and the corpus clears ``min_quant_corpus``, int8 tiles are chosen
    exactly when their byte-aware cost (``ivf_q``: int8 scan + exact-rerank
    overhead) beats the fp32 scan.  ``quantize`` pins the answer ("int8" /
    "none") or lets the cost model decide ("auto"); exact retrieval is
    always full precision.

    -> {"kind", "nprobe", "quantize", "costs"} — ``costs`` is the
    :func:`retrieval_costs` dict when IVF was priced, else None."""
    if quantize not in ("auto", "int8", "none"):
        raise ValueError(f"quantize={quantize!r} (expected 'auto'|'int8'|'none')")
    kind, nprobe = choose_backend(n_corpus, n_queries,
                                  recall_target=recall_target,
                                  min_corpus=min_corpus, shared=shared)
    if kind != "ivf":
        return {"kind": kind, "nprobe": None, "quantize": "none", "costs": None}
    c = retrieval_costs(n_corpus, n_queries, recall_target=recall_target,
                        shared=shared, k=k, rerank_factor=rerank_factor)
    if quantize == "int8":
        chosen = "int8"
    elif quantize == "none" or n_corpus < min_quant_corpus:
        chosen = "none"
    else:
        chosen = "int8" if c["ivf_q"] < c["ivf"] else "none"
    return {"kind": kind, "nprobe": nprobe, "quantize": chosen, "costs": c}


# ---------------------------------------------------------------------------
# Fingerprinting (cross-session index sharing keys)
# ---------------------------------------------------------------------------


def embedder_key(embedder) -> str:
    """Stable identity of the *backend* embedding model, unwrapping the
    per-session accounting/dispatch layers so two serve sessions over the
    same model share one index."""
    key = getattr(embedder, "index_key", None)
    if key is not None:
        return key
    return f"{type(embedder).__name__}@{id(embedder):x}"


def corpus_fingerprint(texts, embedder) -> str:
    h = hashlib.sha1()
    h.update(embedder_key(embedder).encode())
    for t in texts:
        b = str(t).encode("utf-8", "replace")
        # length prefix, not a separator: ["a\x1fb"] must not collide
        # with ["a", "b"] (an aliased registry key would silently serve a
        # different corpus's index)
        h.update(f"{len(b)}:".encode())
        h.update(b)
    return h.hexdigest()
