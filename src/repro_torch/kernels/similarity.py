"""Batched similarity: fused L2-normalize + tiled inner products, the exact
vector-search hot loop behind sem_search / sem_sim_join (the hand-written
CUDA kernel ``csrc/similarity.cu``).

:func:`similarity` takes CUDA tensors only; its plain version is
``ref.similarity_ref``, which ``ops`` runs for tensors on the CPU.

``sharded_similarity_topk`` runs the row-sharded exact top-k one shard at a
time on one device, the kernel scoring each shard's rows (the single-device
simulation of ``ref.sharded_search_ref``).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import sharded_topk

launches = 0   # kernel launches since the caller last set this to 0

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + \
    [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def cost(nq: int, nc: int, d: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one launch, as its bound counts them: the f32
    products; queries and corpus read once, the score plane written once."""
    return 2 * nq * nc * d, 4 * d * (nq + nc) + 4 * nq * nc


def similarity(queries: torch.Tensor, corpus: torch.Tensor, *,
               normalize: bool = True) -> torch.Tensor:
    """queries [nq, d] f32, corpus [nc, d] f32 -> [nq, nc] f32 scores."""
    _build.require(queries, "queries", torch.float32, 2)
    _build.require(corpus, "corpus", torch.float32, 2, queries.device)
    nq, d = queries.shape
    nc = corpus.shape[0]
    if corpus.shape[1] != d:
        raise ValueError(f"corpus width {corpus.shape[1]} != query width {d}")
    if d == 0:
        raise ValueError("similarity needs d > 0")
    out = torch.empty((nq, nc), dtype=torch.float32, device=queries.device)
    if nq == 0 or nc == 0:
        return out
    fn = _build.function("similarity", "repro_similarity", _ARGS)
    rc = fn(queries.data_ptr(), corpus.data_ptr(), out.data_ptr(), nq, nc, d,
            int(normalize), queries.device.index, _build.stream_of(queries))
    _build.check(rc, "similarity", "similarity kernel")
    _build.count_launch(globals())
    if _build.cost_counter is not None:
        _build.cost_counter("similarity", lambda: cost(nq, nc, d))
    return out


def sharded_similarity_topk(queries: torch.Tensor, corpus: torch.Tensor,
                            k: int, *, n_shards: int, normalize: bool = True
                            ) -> tuple[np.ndarray, np.ndarray]:
    """Exact top-k with the corpus rows split into ``n_shards`` tiles, each
    scored by :func:`similarity` and cut to a local top-k, merged on host.
    Result-identical to ``ref.sharded_search_ref``."""
    return sharded_topk(queries, corpus, k, n_shards,
                        lambda q, c: similarity(q, c, normalize=normalize))
