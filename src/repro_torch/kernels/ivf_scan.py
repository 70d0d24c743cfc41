"""IVF cluster scan: the ANN hot loop behind ``IVFIndex.search``.

One pipeline per search, all on the index's device:

  1. centroid scoring  — queries x coarse-quantizer centroids (one fp32 matmul);
  2. probe selection   — per-query top-``nprobe`` clusters (stable sort);
  3. cluster scan      — the hand-written CUDA kernel ``csrc/ivf_scan.cu``:
     a masked gather-scan over *only the probed clusters'* vectors, run
     cluster by cluster from the probe lists of :func:`probe_lists`, so
     each valid row of a probed cluster is read from device memory once.

The inverted file is laid out as padded per-cluster tiles ``store [kc, L, d]``
with a validity mask ``mask [kc, L]``.  A block of ``block_q`` queries scans
the concatenation of its queries' top-``nprobe`` lists, so the output plane
is ``[nb*block_q, slots*L]`` with ``slots = block_q*nprobe``; row i's
candidate j came from cluster ``probe_blocks[i // block_q, j // L]``, slot
``j % L``.  ``block_q`` defines that plane, not a tile size.

:func:`cluster_scan` takes CUDA tensors only; its plain version is
``ref.ivf_scan_ref``, which ``ops`` runs for tensors on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (_sharded_scan, _unitize, ivf_probes,
                                     pad_queries)

launches = 0   # kernel launches since the caller last set this to 0

BLOCK_Q = (1, 2, 4, 8, 16)          # query-block sizes the kernels are built for

_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int] + \
    [ctypes.c_longlong] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def probe_lists(probe_blocks: torch.Tensor, kc: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The probe map inverted, on the tensors' device with no host sync:
    probe_blocks [nb, slots] -> (order [nb*slots] int32, starts [kc+2] int32).

    ``order`` lists the flat pair indices ``b*slots + s`` grouped by the
    cluster they probe, in ascending pair order within a cluster (a stable
    sort), and ``order[starts[p]:starts[p+1]]`` are cluster p's probers; ids
    outside ``[0, kc)`` form the last group, p = kc."""
    flat = probe_blocks.reshape(-1).long()
    key = torch.where((flat >= 0) & (flat < kc), flat, torch.full_like(flat, kc))
    keys, order = torch.sort(key, stable=True)
    starts = torch.searchsorted(keys, torch.arange(kc + 2, device=keys.device))
    return order.to(torch.int32), starts.to(torch.int32)


def check_scan_shapes(queries, store, mask, probe_blocks, block_q: int) -> None:
    """Shape checks shared by both cluster scans (their launch limits are
    :func:`check_launch`)."""
    nq, d = queries.shape
    kc, L, ds = store.shape
    nb, _ = probe_blocks.shape
    if ds != d:
        raise ValueError(f"store width {ds} != query width {d}")
    if tuple(mask.shape) != (kc, L):
        raise ValueError(f"mask shape {tuple(mask.shape)} != {(kc, L)}")
    if nq != nb * block_q:
        raise ValueError("queries must be pre-padded to full blocks")
    if block_q not in BLOCK_Q:
        raise ValueError(f"block_q={block_q}: the kernels are built for {BLOCK_Q}")


CHUNK = 128                          # rows of a cluster one CTA scans
INT32_MAX = 2**31 - 1


def check_launch(nb: int, slots: int, kc: int, L: int) -> None:
    """The launch limits both cluster scans share (``csrc/cluster_major.cuh``,
    ``plan_grid``): the probe lists hold the ``nb*slots`` (block, slot) pairs
    as int32, and one CTA per (cluster, 128-row chunk), the ``kc + 1``
    clusters including the bucket of ids outside the store, must fit one
    launch's grid."""
    if nb * slots > INT32_MAX:
        raise ValueError(f"{nb} x {slots} probes exceed the int32 probe lists")
    if (kc + 1) * -(-L // CHUNK) > INT32_MAX:
        raise ValueError(f"{kc + 1} clusters x {-(-L // CHUNK)} chunks of {CHUNK} rows "
                         "exceed one launch")


def cluster_scan(queries: torch.Tensor, store: torch.Tensor, mask: torch.Tensor,
                 probe_blocks: torch.Tensor, *, block_q: int = 8,
                 normalize: bool = True) -> torch.Tensor:
    """queries [nb*bq, d] f32, store [kc, L, d] f32, mask [kc, L] f32,
    probe_blocks [nb, slots] int32 -> scores [nb*bq, slots*L] f32
    (padding lanes = MASKED_SCORE)."""
    dev = queries.device
    _build.require(queries, "queries", torch.float32, 2)
    _build.require(store, "store", torch.float32, 3, dev)
    _build.require(mask, "mask", torch.float32, 2, dev)
    _build.require(probe_blocks, "probe_blocks", torch.int32, 2, dev)
    check_scan_shapes(queries, store, mask, probe_blocks, block_q)
    kc, L, d = store.shape
    nb, slots = probe_blocks.shape
    check_launch(nb, slots, kc, L)
    out = torch.empty((nb * block_q, slots * L), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    fn = _build.function("ivf_scan", "repro_cluster_scan", _ARGS)
    order, starts = probe_lists(probe_blocks, kc)
    rc = fn(queries.data_ptr(), store.data_ptr(), mask.data_ptr(),
            order.data_ptr(), starts.data_ptr(), out.data_ptr(), nb, block_q, kc,
            L, d, slots, int(normalize), dev.index, _build.stream_of(queries))
    _build.check(rc, "ivf_scan", "cluster_scan kernel")
    _build.count_launch(globals())
    return out


def ivf_search(queries: torch.Tensor, centroids: torch.Tensor,
               store: torch.Tensor, mask: torch.Tensor, *, nprobe: int,
               block_q: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """Stages 1-3 above, no host round trip between them.
    -> (scores [nq, bq*nprobe*L], probe_blocks [nb, bq*nprobe])."""
    q, _ = pad_queries(queries, block_q)
    q = _unitize(q)  # same normalization as the torch reference, by definition
    probe_blocks = ivf_probes(q, centroids, nprobe, block_q)
    scores = cluster_scan(q, store, mask, probe_blocks, block_q=block_q,
                          normalize=False)
    return scores[: len(queries)], probe_blocks


def sharded_ivf_search(queries: torch.Tensor, centroids: torch.Tensor,
                       store: torch.Tensor, mask: torch.Tensor, *, nprobe: int,
                       n_shards: int, block_q: int = 8
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The cluster-axis sharding of ``ref.sharded_ivf_search_ref`` run one
    shard after another on one device, :func:`cluster_scan` scanning each
    shard's tiles; the combined plane equals :func:`ivf_search`'s."""
    q, _ = pad_queries(queries, block_q)
    q = _unitize(q)
    probe_blocks = ivf_probes(q, centroids, nprobe, block_q)
    kc, L, _ = store.shape
    combined = _sharded_scan(
        q, probe_blocks, kc, L, n_shards, block_q,
        lambda lo, hi, p: cluster_scan(q, store[lo:hi], mask[lo:hi], p,
                                       block_q=block_q, normalize=False))
    return combined[: len(queries)], probe_blocks
