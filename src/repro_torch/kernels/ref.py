"""Plain PyTorch contracts of the hand-written kernels.

These define the numerics the CUDA kernels in ``kernels/csrc`` must match
(the tests hold each kernel against them on the card, and hold them against
the ``repro`` jnp originals on the CPU).  Each function is the torch form of
the same-named function in ``repro.kernels.ref`` and runs on whatever device
its tensors are on; inputs may be numpy arrays or tensors.

Three normalizations exist, and each is copied where its original uses it:
``similarity_ref`` divides by ``max(||x||, 1e-9)``, ``_unitize`` multiplies
by ``rsqrt(max(sum(x^2), 1e-18))`` (the kernels' form), and the numpy index
code divides by ``max(norm, 1e-9)``.

Top-k selections break ties toward the lowest index, as ``jax.lax.top_k``
does: ``torch.topk`` makes no such promise, so they take the first ``k`` of
a stable descending sort.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.index.backend import MASKED_SCORE  # canonical, numpy-only home

NEG_INF = -1e30   # the attention mask value: finite, so no row turns into NaN


def _f32(x, device=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.to(device=device, dtype=torch.float32)


def _topk_low_index(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def attn_scale(hd: int) -> float:
    """``1 / sqrt(hd)`` rounded to f32, as the reference computes it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """q:[B,Sq,H,hd], k/v:[B,Sk,Hk,hd] (GQA) -> [B,Sq,H,hd] in ``v.dtype``.

    Scores and softmax in f32; masks compare absolute positions counted from
    0 on both axes; the probabilities are rounded to ``v.dtype`` before the
    PV product, which sums in f32 and rounds once, as the reference's bf16
    einsum does."""
    h, hk = q.shape[2], k.shape[2]
    if hk != h:
        v = v.repeat_interleave(h // hk, dim=2)
    p = torch.softmax(_masked_scores(q, k, causal, window), dim=-1)
    out = torch.einsum("bhqs,bshd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def _masked_scores(q: torch.Tensor, k: torch.Tensor, causal: bool, window: int
                   ) -> torch.Tensor:
    """The contract's f32 scores [B,H,Sq,Sk], masked ones NEG_INF."""
    h, hk = q.shape[2], k.shape[2]
    if hk != h:
        k = k.repeat_interleave(h // hk, dim=2)
    s = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float()) * attn_scale(q.shape[-1])
    sq, sk = q.shape[1], k.shape[1]
    q_pos = torch.arange(sq, device=q.device)
    k_pos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]
    if window:
        mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
    return torch.where(mask[None, None], s, NEG_INF)


def flash_attention_stats_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                              causal: bool = True, window: int = 0
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each row's softmax statistics of :func:`flash_attention_ref`: the max m
    of its masked scores and l = sum(exp(s - m)), f32 [B,H,Sq] each, as the
    bf16 forward kernel saves them for its backward (``v`` is not read).  A
    row that no key may see has m = NEG_INF and l = Sk: its softmax is
    uniform.  The two are kept apart, not as m + log(l): in f32, NEG_INF +
    log(Sk) rounds back to NEG_INF, which would lose that row's 1 / Sk."""
    del v
    s = _masked_scores(q, k, causal, window)
    m = s.amax(dim=-1)
    return m, torch.exp(s - m[..., None]).sum(dim=-1)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            out: torch.Tensor, dout: torch.Tensor, *, causal: bool = True,
                            window: int = 0
                            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_attention_ref` at q, k, v for the output
    gradient ``dout``: torch autograd through the contract.  ``out`` (the
    forward's output) is taken for the kernel's signature and not read.
    Masked scores get no gradient; a row that no key may see sends its
    uniform probabilities into dv only; dk and dv sum over each kv-head's
    group of q-heads."""
    del out
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        o = flash_attention_ref(*leaves, causal=causal, window=window)
        return torch.autograd.grad(o, leaves, dout)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lens: torch.Tensor, *, window: int = 0) -> torch.Tensor:
    """q:[B,1,H,hd], k/v:[B,S,Hk,hd], lens:[B] -> [B,1,H,hd] in ``v.dtype``.

    Row b attends to cache positions ``0..lens[b]`` inclusive (the new
    token already written), among the S that exist, so ``lens[b] >= S``
    means all S.  ``window > 0`` also requires ``lens[b] - k_pos < window``,
    the mask of the model's decode; ``window=0`` is the reference's
    contract.  Scores and softmax in f32; p is rounded to ``v.dtype`` before
    the PV product, as in :func:`flash_attention_ref`."""
    h, hk = q.shape[2], k.shape[2]
    if hk != h:
        k = k.repeat_interleave(h // hk, dim=2)
        v = v.repeat_interleave(h // hk, dim=2)
    s = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float()) * attn_scale(q.shape[-1])
    lens = torch.as_tensor(lens, device=q.device).long()
    k_pos = torch.arange(k.shape[1], device=q.device)
    valid = k_pos[None, :] <= lens[:, None]
    if window:
        valid = valid & (lens[:, None] - k_pos[None, :] < window)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqs,bshd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5
                ) -> torch.Tensor:
    """x:[..., d], scale:[d] -> like ``x``; statistics and scaling in f32."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def similarity_ref(queries, corpus, *, normalize: bool = True) -> torch.Tensor:
    """queries:[nq,d], corpus:[nc,d] -> [nq,nc] cosine/inner-product scores."""
    q = _f32(queries)
    c = _f32(corpus, q.device)
    if normalize:
        q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-9)
        c = c / torch.clamp(torch.linalg.vector_norm(c, dim=-1, keepdim=True), min=1e-9)
    return q @ c.T


# -- IVF cluster scan (shared helpers + torch reference) --------------------


def _unitize(q: torch.Tensor) -> torch.Tensor:
    return q * torch.rsqrt(torch.clamp((q * q).sum(-1, keepdim=True), min=1e-18))


def pad_queries(q: torch.Tensor, block_q: int) -> tuple[torch.Tensor, int]:
    """Pad [nq, d] -> [nb*block_q, d] by edge replication (replicated rows
    probe the same clusters as the last real query, so padding never drags
    unrelated clusters into a block's scan).  -> (padded, nb)."""
    nq = q.shape[0]
    nb = max(1, -(-nq // block_q))
    pad = nb * block_q - nq
    if pad:
        q = torch.cat([q, q[-1:].expand(pad, -1)], dim=0)
    return q, nb


def ivf_probes(q: torch.Tensor, centroids, nprobe: int, block_q: int) -> torch.Tensor:
    """Per-query top-``nprobe`` clusters by centroid score, concatenated per
    query block -> [nb, block_q*nprobe] int32.  Shared verbatim by the kernel
    path and the torch reference so probe selection can never diverge.  The
    centroid product is one plain fp32 matmul (TF32 is off, see
    ``repro_torch.device``)."""
    cs = _f32(q) @ _f32(centroids, q.device).T                 # [nb*bq, kc]
    _, probe = _topk_low_index(cs, nprobe)                      # [nb*bq, nprobe]
    return probe.to(torch.int32).reshape(-1, block_q * nprobe)


def _scan_blocks(q, tiles, scales, mask, probe_blocks, block_q: int) -> torch.Tensor:
    """Gather-scan one query block at a time, so the gathered tiles of only
    one block are ever materialized."""
    nb, slots = probe_blocks.shape
    L = tiles.shape[1]
    qb = q.reshape(nb, block_q, -1)
    pb = probe_blocks.to(device=q.device, dtype=torch.long)
    mask = _f32(mask, q.device)
    out = torch.empty((nb, block_q, slots, L), dtype=torch.float32, device=q.device)
    for b in range(nb):
        v = tiles[pb[b]].to(torch.float32)                      # [slots, L, d]
        s = torch.einsum("qd,sld->qsl", qb[b], v)
        if scales is not None:
            s = s * scales[pb[b]][None]
        out[b] = torch.where(mask[pb[b]][None] > 0, s,
                             torch.full_like(s, MASKED_SCORE))
    return out.reshape(nb * block_q, slots * L)


def ivf_scan_ref(queries, store, mask, probe_blocks, *, block_q: int = 8,
                 normalize: bool = True) -> torch.Tensor:
    """Reference masked gather-scan: queries [nb*bq, d], store [kc, L, d],
    mask [kc, L], probe_blocks [nb, slots] -> [nb*bq, slots*L]."""
    q = _f32(queries)
    if normalize:
        q = _unitize(q)
    return _scan_blocks(q, _f32(store, q.device), None, mask,
                        torch.as_tensor(probe_blocks), block_q)


def ivf_search_ref(queries, centroids, store, mask, *, nprobe: int,
                   block_q: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """Torch reference for ``kernels.ivf_scan.ivf_search`` (same pipeline:
    centroid scoring -> per-query probes -> masked cluster scan)."""
    q, _ = pad_queries(_f32(queries), block_q)
    q = _unitize(q)
    probe_blocks = ivf_probes(q, centroids, nprobe, block_q)
    scores = ivf_scan_ref(q, store, mask, probe_blocks, block_q=block_q,
                          normalize=False)
    return scores[: len(queries)], probe_blocks


def ivf_delta_search_ref(queries, centroids, store, mask, delta_vectors, *,
                         nprobe: int, block_q: int = 8
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Delta-aware IVF reference: the probed main-store scan of
    :func:`ivf_search_ref` with an *exact* scan of the append-only delta side
    buffer (unit rows) concatenated along the candidate axis
    -> (scores [nq, slots*L + nd], probe_blocks)."""
    s, probe_blocks = ivf_search_ref(queries, centroids, store, mask,
                                     nprobe=nprobe, block_q=block_q)
    q = _unitize(_f32(queries))
    ds = q @ _f32(delta_vectors, q.device).T
    return torch.cat([s, ds], dim=1), probe_blocks


# -- quantized IVF scan (torch contracts for kernels/ivf_scan_q) ------------


def ivf_scan_q_ref(queries, store_q, scales, mask, probe_blocks, *,
                   block_q: int = 8, normalize: bool = True) -> torch.Tensor:
    """Reference fused dequantize+score gather-scan: queries [nb*bq, d],
    store_q [kc, L, d] int8, scales [kc, L] f32, mask [kc, L],
    probe_blocks [nb, slots] -> [nb*bq, slots*L].

    The per-vector scale multiplies each score AFTER the dot product (it
    factors out of it), exactly as the kernel does."""
    q = _f32(queries)
    if normalize:
        q = _unitize(q)
    st = store_q if isinstance(store_q, torch.Tensor) \
        else torch.from_numpy(np.asarray(store_q, np.int8))
    return _scan_blocks(q, st.to(q.device), _f32(scales, q.device), mask,
                        torch.as_tensor(probe_blocks), block_q)


def ivf_search_q_ref(queries, centroids, store_q, scales, mask, *,
                     nprobe: int, block_q: int = 8
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The :func:`ivf_search_ref` pipeline (shared probe selection included)
    with the quantized cluster scan in stage 3."""
    q, _ = pad_queries(_f32(queries), block_q)
    q = _unitize(q)
    probe_blocks = ivf_probes(q, centroids, nprobe, block_q)
    scores = ivf_scan_q_ref(q, store_q, scales, mask, probe_blocks,
                            block_q=block_q, normalize=False)
    return scores[: len(queries)], probe_blocks


def ivf_delta_search_q_ref(queries, centroids, store_q, scales, mask,
                           delta_q, delta_scales, *, nprobe: int,
                           block_q: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantized delta-aware IVF reference: the probed quantized main-store
    scan plus an exact dequantize-fused scan of the int8 delta buffer."""
    s, probe_blocks = ivf_search_q_ref(queries, centroids, store_q, scales,
                                       mask, nprobe=nprobe, block_q=block_q)
    q = _unitize(_f32(queries))
    ds = (q @ _f32(delta_q, q.device).T) * _f32(delta_scales, q.device)[None, :]
    return torch.cat([s, ds], dim=1), probe_blocks


def _sharded_scan(q, probe_blocks, kc: int, L: int, n_shards: int, block_q: int,
                  scan_shard) -> torch.Tensor:
    """The cluster-axis sharding discipline shared by both IVF flavours:
    each shard scans only the probed clusters it owns (out-of-shard slots
    score MASKED_SCORE) and the per-shard planes combine by elementwise max.
    ``scan_shard(lo, hi, local_probes)`` scores one shard's tiles."""
    local = max(1, -(-kc // n_shards))
    nb, slots = probe_blocks.shape
    combined = torch.full((nb * block_q, slots * L), MASKED_SCORE,
                          dtype=torch.float32, device=q.device)
    for s in range(n_shards):
        lo, hi = s * local, min((s + 1) * local, kc)
        if hi <= lo:   # a trailing shard that owns no cluster scores nothing
            break
        in_range = (probe_blocks >= lo) & (probe_blocks < hi)   # [nb, slots]
        safe = torch.where(in_range, probe_blocks, torch.full_like(probe_blocks, lo))
        sc = scan_shard(lo, hi, (safe - lo).to(torch.int32))
        keep = in_range.repeat_interleave(L, dim=1).repeat_interleave(block_q, dim=0)
        combined = torch.maximum(combined, torch.where(keep, sc, MASKED_SCORE))
    return combined


def sharded_ivf_search_ref(queries, centroids, store, mask, *, nprobe: int,
                           n_shards: int, block_q: int = 8
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Torch contract for ``ops.sharded_ivf_search``: the padded per-cluster
    tiles are partitioned across ``n_shards`` along the cluster axis; the
    combined plane is *identical* to the unsharded :func:`ivf_search_ref`."""
    q, _ = pad_queries(_f32(queries), block_q)
    q = _unitize(q)
    probe_blocks = ivf_probes(q, centroids, nprobe, block_q)
    st, mk = _f32(store, q.device), _f32(mask, q.device)
    kc, L, _ = st.shape
    combined = _sharded_scan(
        q, probe_blocks, kc, L, n_shards, block_q,
        lambda lo, hi, p: ivf_scan_ref(q, st[lo:hi], mk[lo:hi], p,
                                       block_q=block_q, normalize=False))
    return combined[: len(queries)], probe_blocks


def sharded_ivf_search_q_ref(queries, centroids, store_q, scales, mask, *,
                             nprobe: int, n_shards: int, block_q: int = 8
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Torch contract for ``ops.sharded_ivf_search_q``: the sharding
    discipline of :func:`sharded_ivf_search_ref` over the quantized store."""
    q, _ = pad_queries(_f32(queries), block_q)
    q = _unitize(q)
    probe_blocks = ivf_probes(q, centroids, nprobe, block_q)
    st = torch.as_tensor(np.asarray(store_q, np.int8)) \
        if not isinstance(store_q, torch.Tensor) else store_q
    st, sc, mk = st.to(q.device), _f32(scales, q.device), _f32(mask, q.device)
    kc, L, _ = st.shape
    combined = _sharded_scan(
        q, probe_blocks, kc, L, n_shards, block_q,
        lambda lo, hi, p: ivf_scan_q_ref(q, st[lo:hi], sc[lo:hi], mk[lo:hi], p,
                                         block_q=block_q, normalize=False))
    return combined[: len(queries)], probe_blocks


# -- device-sharded exact search (torch contracts) --------------------------


def pad_corpus_shards(corpus: torch.Tensor, n_shards: int
                      ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Pad [nc, d] -> [n_shards*local, d] plus a validity mask [padded] so
    every shard holds an identically-shaped tile.  -> (padded, valid, local)."""
    nc = corpus.shape[0]
    local = max(1, -(-nc // n_shards))
    pad = n_shards * local - nc
    valid = torch.cat([torch.ones(nc, dtype=torch.float32, device=corpus.device),
                       torch.zeros(pad, dtype=torch.float32, device=corpus.device)])
    if pad:
        corpus = torch.cat([corpus, corpus.new_zeros((pad, corpus.shape[1]))])
    return corpus, valid, local


def shard_topk_merge(scores, indices, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Host-side merge of per-shard top-k candidate lists: [nq, S*k] each ->
    (scores [nq, k], idx [nq, k]) descending, ties to the lowest index.

    Candidates arrive grouped by shard, so ties are broken by explicit index
    rather than stable position."""
    s = scores.cpu().numpy() if isinstance(scores, torch.Tensor) else np.asarray(scores)
    i = indices.cpu().numpy() if isinstance(indices, torch.Tensor) else np.asarray(indices)
    # lexsort: primary descending score, secondary ascending global index —
    # the same tie rule a full-corpus top-k applies
    order = np.lexsort((i, -s), axis=1)
    k = min(k, s.shape[1])
    take = order[:, :k]
    return (np.take_along_axis(s, take, axis=1),
            np.take_along_axis(i, take, axis=1))


def sharded_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                 n_shards: int, score) -> tuple[np.ndarray, np.ndarray]:
    """The corpus is row-partitioned into ``n_shards`` equal tiles (the
    layout of :func:`pad_corpus_shards`), every shard scores its rows with
    ``score(q, rows)`` and keeps a local top-k, and the candidates are
    merged on host.  A shard's padding rows score MASKED_SCORE without the
    corpus ever being copied into a padded buffer."""
    nc = corpus.shape[0]
    local = max(1, -(-nc // n_shards))
    k_l = min(k, local)
    all_s, all_i = [], []
    for s in range(n_shards):
        lo, hi = min(s * local, nc), min((s + 1) * local, nc)
        sc = score(queries, corpus[lo:hi]) if hi > lo else \
            queries.new_zeros((queries.shape[0], 0))
        if hi - lo < local:
            sc = torch.cat([sc, sc.new_full((sc.shape[0], local - (hi - lo)),
                                            MASKED_SCORE)], dim=1)
        vals, loc = _topk_low_index(sc, k_l)
        all_s.append(vals)
        all_i.append(loc + s * local)
    return shard_topk_merge(torch.cat(all_s, dim=1), torch.cat(all_i, dim=1), k)


def sharded_search_ref(queries, corpus, k: int, n_shards: int, *,
                       normalize: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """Torch contract for ``ops.sharded_search``.  Lossless: each global
    winner is its home shard's local winner, so the merged top-k equals a
    full exact scan's.  -> (scores [nq, k], idx [nq, k])."""
    q = _f32(queries)
    c = _f32(corpus, q.device)
    if normalize:
        q = _unitize(q)
        c = _unitize(c)
    return sharded_topk(q, c, k, n_shards, lambda a, b: a @ b.T)
