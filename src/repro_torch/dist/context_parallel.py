"""Context-parallel decode attention: the KV cache sharded over its sequence.

At long contexts the decode step is KV-cache-bandwidth-bound, so the cache
is sharded along its *sequence* dimension across the ``model`` axis (or a
tuple of axes); each rank attends over its local KV slice with flash-style
partial-softmax statistics (m, l, o) that are combined with one MAX and two
SUM ``all_reduce``s over those axes (the reference's ``pmax`` + ``psum``).
The new token's K/V is written only by the rank whose slice holds
``cache_len``, so the caches keep the sharded layout they arrived with.

The reference runs this body under ``shard_map``; here each rank runs it on
its own shards.  The body is plain torch, as the reference's is ``einsum``
outside any Pallas kernel: the context-parallel path launches no
``decode_attention``.
"""
from __future__ import annotations

import torch

from repro_torch.dist import sharding as shd
from repro_torch.kernels.ref import NEG_INF, attn_scale
from repro_torch.models.attention import _repeat_kv, out_proj, project_qkv
from repro_torch.models.layers import einsum, einsum_f32


def cp_decode_self_attention(params, x, k_cache, v_cache, cache_len, *, cfg, mesh,
                             axis="model"):
    """Sequence-sharded decode attention on this rank's shards.

    x: this rank's batch rows [b,1,D]; caches: its shards [b, s_l, Hk, hd]
    of the [B, Smax, Hk, hd] caches, cut along the sequence by ``axis`` (a
    mesh axis or a tuple, major to minor); ``cache_len`` a scalar or the
    rows' [b] lengths.  The batch rows are the caller's: where the batch is
    sharded (the reference's ``dp_spec``), x, the caches and ``cache_len``
    already hold this rank's rows.  Returns (out [b,1,D], k_cache, v_cache),
    the caches written in place."""
    b, s_l = k_cache.shape[0], k_cache.shape[1]
    lens = torch.as_tensor(cache_len, dtype=torch.int32, device=x.device).expand(b)
    start = shd.shard_index(mesh, axis) * s_l
    pos = start + torch.arange(s_l, device=x.device)

    q, k_new, v_new = project_qkv(params, x, cfg=cfg, positions=lens[:, None])
    # write the new K/V where this rank's slice holds position ``lens``; the
    # other rows write back what they read, so no index leaves the slice
    local = lens - start
    own = ((local >= 0) & (local < s_l))[:, None, None]
    idx = local.clamp(0, s_l - 1).long()
    bidx = torch.arange(b, device=x.device)
    k_cache[bidx, idx] = torch.where(own, k_new[:, 0].to(k_cache.dtype), k_cache[bidx, idx])
    v_cache[bidx, idx] = torch.where(own, v_new[:, 0].to(v_cache.dtype), v_cache[bidx, idx])

    k_valid = pos[None, :] <= lens[:, None]
    if cfg.sliding_window:
        k_valid = k_valid & (lens[:, None] - pos[None, :] < cfg.sliding_window)

    h = q.shape[2]
    k_full = _repeat_kv(k_cache, h)
    v_full = _repeat_kv(v_cache, h)
    scores = einsum_f32("bqhd,bshd->bhqs", q, k_full) * attn_scale(q.shape[-1])
    scores = torch.where(k_valid[:, None, None, :], scores, NEG_INF)

    m = shd.all_reduce(scores.amax(dim=-1), mesh, axis, "max")             # [b,h,1]
    p = torch.exp(scores - m[..., None])
    l = shd.all_reduce(p.sum(dim=-1), mesh, axis)                           # [b,h,1]
    o = shd.all_reduce(einsum("bhqs,bshd->bqhd", p.to(v_full.dtype), v_full), mesh, axis)
    out = o / torch.clamp(l.transpose(1, 2)[..., None], min=1e-30)
    return out_proj(params, out.to(x.dtype)), k_cache, v_cache
