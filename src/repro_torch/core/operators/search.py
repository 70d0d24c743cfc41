"""sem_search, sem_sim_join, sem_index (§4.2): similarity-specialized
operators served by the retrieval layer (the equi-join analogues that expose
vector-search optimization opportunities to the engine).

All three go through the `RetrievalBackend` interface: ``index="exact"``
scans the full corpus (gold), ``index="ivf"`` prunes with the ANN inverted
file (recall knob: ``nprobe`` / ``recall_target``), ``index="auto"`` lets
the shared cost model decide.  Per-search retrieval cost (index kind,
probed clusters, scored vectors) lands in the op's accounting ``details``
so BENCH_*/serve metrics can attribute it.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import accounting
from repro_torch.index.backend import (MASKED_SCORE, RetrievalBackend, build_index,
                                 load_index)


def sem_index(texts: list[str], embedder, *, path: str | None = None,
              index: str = "exact", **index_kw) -> RetrievalBackend:
    """Embed ``texts`` and build a retrieval index over them.

    ``index`` picks the backend ("exact" | "ivf" | "auto"); ``index_kw``
    (n_clusters, nprobe, recall_target, ...) flows to the IVF build.  Both
    formats persist to ``path`` and come back via :func:`load_sem_index`.
    """
    with accounting.track("sem_index") as st:
        vectors = embedder.embed(texts)
        built = build_index(vectors, kind=index, **index_kw)
        st.details.update(index=built.kind, **{
            k: v for k, v in built.describe().items() if k != "kind"})
        if path:
            built.save(path)
        return built


def load_sem_index(path: str) -> RetrievalBackend:
    """Load a persisted sem_index of either format (kind in meta.json)."""
    return load_index(path)


def _record_retrieval(st, index: RetrievalBackend) -> None:
    st.details.update(index=index.kind,
                      scored_vectors=index.last_stats.get("scored_vectors", 0),
                      probed_clusters=index.last_stats.get("probed_clusters", 0))
    # dtype-aware byte accounting: int8 IVF tiles stream d+4 bytes per
    # scanned vector (plus fp32 rerank re-reads) vs 4d at full precision
    if "scanned_bytes" in index.last_stats:
        st.details.update(
            scanned_bytes=index.last_stats["scanned_bytes"],
            quantize=index.last_stats.get("quantize", "none"))
        if index.last_stats.get("reranked"):
            st.details.update(
                rerank_exact_rows=index.last_stats["reranked"])


def sem_search(index: RetrievalBackend, query: str, embedder, *, k: int = 10,
               n_rerank: int = 0, rerank_model=None, records=None,
               rerank_langex=None, max_pos: int | None = None
               ) -> tuple[list[int], dict]:
    """Top-k by embedding similarity; optional LLM re-ranking of the top-k
    down to ``n_rerank`` results (the advanced search path of §4.2).
    ``max_pos`` bounds hits to index positions < max_pos (the snapshot
    cutoff for version-pinned queries over a shared streaming index)."""
    with accounting.track("sem_search") as st:
        qv = embedder.embed([query])
        kw = {} if max_pos is None else {"max_pos": max_pos}
        scores, idx = index.search(qv, k, **kw)
        # unfilled slots (possible only under a max_pos cutoff racing a
        # retrain) carry the masked sentinel: drop them
        hits = [int(i) for i, s in zip(idx[0], scores[0]) if s > MASKED_SCORE / 2]
        _record_retrieval(st, index)
        n_rerank = min(n_rerank, k)  # can't re-rank more than we retrieved
        if n_rerank and rerank_model is not None and records is not None:
            from repro_torch.core.operators.topk import sem_topk_quickselect
            sub = [records[i] for i in hits]
            order, _ = sem_topk_quickselect(sub, rerank_langex or "most relevant: {text}",
                                            n_rerank, rerank_model)
            hits = [hits[i] for i in order]
            st.details.update(reranked=n_rerank)
        return hits, st.as_dict()


def sem_sim_join(left_texts: list[str], right_index: RetrievalBackend, embedder,
                 *, k: int = 1, max_pos: int | None = None
                 ) -> tuple[np.ndarray, np.ndarray, dict]:
    """Left join: K most-similar right rows per left row (§4.2 Figure 4).

    Returns (scores [n1,k], indices [n1,k], stats); slots carrying the
    masked sentinel (possible only under a ``max_pos`` snapshot cutoff)
    must be skipped by the consumer."""
    with accounting.track("sem_sim_join") as st:
        emb_l = embedder.embed(left_texts)
        kw = {} if max_pos is None else {"max_pos": max_pos}
        scores, idx = right_index.search(emb_l, k, **kw)
        _record_retrieval(st, right_index)
        return scores, idx, st.as_dict()
