"""Retrieval layer: one RetrievalBackend interface, two implementations.

    build_index(vectors, kind="exact"|"ivf"|"auto")   construction
    load_index(path)                                  persistence dispatch
    choose_backend(n_corpus, n_queries, ...)          shared cost model
    choose_retrieval_config(...)                      + tile precision choice

`VectorIndex` is the exact gold reference; `IVFIndex` prunes with spherical
k-means inverted lists and a CUDA cluster-scan kernel (see
`repro_torch.kernels.ivf_scan`).  ``IVFIndex(quantize="int8")`` stores the tiles
as symmetric per-vector int8 (`repro_torch.index.quant`), scans them with the
fused dequantize+score kernel (`repro_torch.kernels.ivf_scan_q`), and exact-
reranks in fp32.  All similarity consumers — sem_search, sem_sim_join, the
join sim-prefilter, sem_group_by center scoring, sem_topk pivot selection —
go through this interface.
"""
from repro_torch.index.backend import (RetrievalBackend, build_index, choose_backend,
                                 choose_retrieval_config, choose_shards,
                                 corpus_fingerprint, embedder_key, load_index,
                                 nprobe_for_recall, retrieval_costs)
from repro_torch.index.ivf_index import IVFIndex, ivf_from_arrays
from repro_torch.index.kmeans import kmeans
from repro_torch.index.quant import (bytes_per_vector, dequantize_rows,
                               quantize_rows, quantize_tiles,
                               quantized_scores)
from repro_torch.index.vector_index import VectorIndex

__all__ = [
    "IVFIndex", "RetrievalBackend", "VectorIndex", "build_index",
    "bytes_per_vector", "choose_backend", "choose_retrieval_config",
    "choose_shards", "corpus_fingerprint", "dequantize_rows", "embedder_key",
    "ivf_from_arrays",
    "kmeans", "load_index", "nprobe_for_recall", "quantize_rows",
    "quantize_tiles", "quantized_scores", "retrieval_costs",
]
