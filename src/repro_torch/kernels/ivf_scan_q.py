"""Quantized IVF cluster scan: fused dequantize+score.

The int8 sibling of ``kernels/ivf_scan``: the same masked gather-scan over
padded per-cluster tiles, the same probe selection and ``MASKED_SCORE``
padding, but the tiles are symmetric per-vector int8 (``store_q [kc, L, d]``
int8 + ``scales [kc, L]`` f32; ``repro_torch.index.quant``), cutting the
bytes the hot loop streams per vector from ``4*d`` to ``d + 4``.  The CUDA
kernel ``csrc/ivf_scan_q.cu`` runs the fp32 scan's cluster-major schedule
from the same probe lists (``ivf_scan.probe_lists``): it stages each
chunk's int8 rows in shared memory, converts them to fp32 once per stage,
and multiplies each finished dot product by its vector's scale; the query
is not quantized.

:func:`cluster_scan_q` takes CUDA tensors only; its plain version is
``ref.ivf_scan_q_ref``, which ``ops`` runs for tensors on the CPU.  The recall
story lives a layer up: ``IVFIndex(quantize="int8")`` exact-reranks the top
``rerank_factor*k`` quantized candidates in fp32.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ivf_scan import (check_launch, check_scan_shapes,
                                          probe_lists)
from repro_torch.kernels.ref import (_sharded_scan, _unitize, ivf_probes,
                                     pad_queries)

launches = 0   # kernel launches since the caller last set this to 0

_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int] + \
    [ctypes.c_longlong] * 5 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def aligned_rows(queries: torch.Tensor) -> torch.Tensor:
    """``queries`` [n, d] as the kernel copies them, 16 bytes at a time:
    itself when its rows are 16-byte aligned, else a copy whose rows are
    padded with zeros to a multiple of 4 floats."""
    d = queries.shape[1]
    if d % 4 == 0 and queries.data_ptr() % 16 == 0:
        return queries
    out = torch.zeros((queries.shape[0], d + (-d) % 4), dtype=queries.dtype,
                      device=queries.device)
    out[:, :d] = queries
    return out


def cluster_scan_q(queries: torch.Tensor, store_q: torch.Tensor,
                   scales: torch.Tensor, mask: torch.Tensor,
                   probe_blocks: torch.Tensor, *, block_q: int = 8,
                   normalize: bool = True) -> torch.Tensor:
    """queries [nb*bq, d] f32, store_q [kc, L, d] int8, scales [kc, L] f32,
    mask [kc, L] f32, probe_blocks [nb, slots] int32 -> scores
    [nb*bq, slots*L] f32 (padding lanes = MASKED_SCORE)."""
    dev = queries.device
    _build.require(queries, "queries", torch.float32, 2)
    _build.require(store_q, "store_q", torch.int8, 3, dev)
    _build.require(scales, "scales", torch.float32, 2, dev)
    _build.require(mask, "mask", torch.float32, 2, dev)
    _build.require(probe_blocks, "probe_blocks", torch.int32, 2, dev)
    check_scan_shapes(queries, store_q, mask, probe_blocks, block_q)
    if scales.shape != mask.shape:
        raise ValueError(f"scales shape {tuple(scales.shape)} != {tuple(mask.shape)}")
    kc, L, d = store_q.shape
    nb, slots = probe_blocks.shape
    check_launch(nb, slots, kc, L)
    out = torch.empty((nb * block_q, slots * L), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    fn = _build.function("ivf_scan_q", "repro_cluster_scan_q", _ARGS)
    order, starts = probe_lists(probe_blocks, kc)
    qa = aligned_rows(queries)
    rc = fn(qa.data_ptr(), store_q.data_ptr(), scales.data_ptr(),
            mask.data_ptr(), order.data_ptr(), starts.data_ptr(), out.data_ptr(),
            nb, block_q, kc, L, d, qa.shape[1], slots, int(normalize), dev.index,
            _build.stream_of(queries))
    _build.check(rc, "ivf_scan_q", "cluster_scan_q kernel")
    _build.count_launch(globals())
    return out


def ivf_search_q(queries: torch.Tensor, centroids: torch.Tensor,
                 store_q: torch.Tensor, scales: torch.Tensor,
                 mask: torch.Tensor, *, nprobe: int, block_q: int = 8
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Centroid scoring + per-query top-``nprobe`` probe selection (both
    fp32 — centroids are tiny) + quantized cluster scan.
    -> (scores [nq, bq*nprobe*L], probe_blocks [nb, bq*nprobe])."""
    q, _ = pad_queries(queries, block_q)
    q = _unitize(q)  # same normalization as the torch reference, by definition
    probe_blocks = ivf_probes(q, centroids, nprobe, block_q)
    scores = cluster_scan_q(q, store_q, scales, mask, probe_blocks,
                            block_q=block_q, normalize=False)
    return scores[: len(queries)], probe_blocks


def sharded_ivf_search_q(queries: torch.Tensor, centroids: torch.Tensor,
                         store_q: torch.Tensor, scales: torch.Tensor,
                         mask: torch.Tensor, *, nprobe: int, n_shards: int,
                         block_q: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """The sharding of ``ref.sharded_ivf_search_q_ref`` run one shard after
    another on one device, :func:`cluster_scan_q` scanning each shard."""
    q, _ = pad_queries(queries, block_q)
    q = _unitize(q)
    probe_blocks = ivf_probes(q, centroids, nprobe, block_q)
    kc, L, _ = store_q.shape
    combined = _sharded_scan(
        q, probe_blocks, kc, L, n_shards, block_q,
        lambda lo, hi, p: cluster_scan_q(q, store_q[lo:hi], scales[lo:hi],
                                         mask[lo:hi], p, block_q=block_q,
                                         normalize=False))
    return combined[: len(queries)], probe_blocks
