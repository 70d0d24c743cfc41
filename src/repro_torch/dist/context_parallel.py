"""Context-parallel decode attention: the KV cache sharded over its sequence.

At long contexts the decode step is KV-cache-bandwidth-bound, so the cache
is sharded along its *sequence* dimension across the ``model`` axis (or a
tuple of axes); each rank attends over its local KV slice with flash-style
partial-softmax statistics (m, l, o) that are combined with one MAX and two
SUM ``all_reduce``s over those axes (the reference's ``pmax`` + ``psum``).
The new token's K/V is written only by the rank whose slice holds
``cache_len``, so the caches keep the sharded layout they arrived with.

Where the rules also cut the cache stack's layers (``"default"`` on a mesh
with ``pod``: each pod holds half the layers), the attention's own layer
spec cuts the batch over the stack's layer and batch axes together, so
each layer's rows move from the owner pod's stack shard to the ranks that
attend them and the new tokens move back (:func:`cp_decode_stack_layer`).

The reference runs this body under ``shard_map``; here each rank runs it on
its own shards.  The body is plain torch, as the reference's is ``einsum``
outside any Pallas kernel: the context-parallel path launches no
``decode_attention``.
"""
from __future__ import annotations

import itertools
import math
from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.dist import sharding as shd
from repro_torch.kernels.ref import NEG_INF, attn_scale
from repro_torch.models.attention import out_proj, project_qkv
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

    # the grouped single-token product (``gqa_attend``'s): q-head h reads
    # kv-head h // g from the shard as it is, never a copy per q-head
    bq, _, h, hd = q.shape
    hk = k_cache.shape[2]
    qg = q.reshape(bq, 1, hk, h // hk, hd)
    scores = einsum_f32("bqkgd,bskd->bkgqs", qg, k_cache) * attn_scale(hd)
    scores = torch.where(k_valid[:, None, None, None, :], scores, NEG_INF)

    m = shd.all_reduce(scores.amax(dim=-1), mesh, axis, "max")             # [b,hk,g,1]
    p = torch.exp(scores - m[..., None])
    l = shd.all_reduce(p.sum(dim=-1), mesh, axis)                           # [b,hk,g,1]
    o = shd.all_reduce(einsum("bkgqs,bskd->bqkgd", p.to(v_cache.dtype), v_cache), mesh, axis)
    out = (o / torch.clamp(l.permute(0, 3, 1, 2)[..., None], min=1e-30)).reshape(bq, 1, h, hd)
    return out_proj(params, out.to(x.dtype)), k_cache, v_cache


# ---------------------------------------------------------------------------
# A cache stack whose layers are cut over the mesh (``pod``)
# ---------------------------------------------------------------------------

_STACK_AXES = ("layers", "batch", "kv_seq", "kv_heads", "qkv")


class StackLayer(NamedTuple):
    """Layer ``i`` of a K or V cache stack [L, B, S, Hk, hd] held as a
    ``DTensor`` whose layer dimension the rules cut (``"default"``'s
    ``layers -> pod``): what a decode loop hands the attention in place of
    ``stack[i]`` (``models.attention.cache_layer``)."""
    stack: object
    i: int


def _stack_plan(shape, spec, mesh, rules, i: int):
    """(this rank's stack slot of layer i, the rows it attends as an offset
    into its source's batch shard, {source rank: group} of the groups this
    rank is in, its own source rank, the sequence axes).

    Layer i lives on layer shard q = i // (L / n).  The attention's own spec
    for a layer [B, S, Hk, hd] cuts the batch over the stack's layer and
    batch axes together (``P(("pod", "data"), "model")``), so rank (p, d, m)
    attends batch block p D + d at sequence shard m; the stack holds those
    rows in batch shard (p D + d) // P of pod q's ranks at sequence shard m
    (its source), where the rows of P blocks lie.  ``spec`` is the stack's."""
    lspec = shd.resolve_pspec(shape[1:], _STACK_AXES[1:], mesh, rules)
    lead, batch, seq = (shd.entry_axes(e) for e in spec[:3])
    rows_ax, seq_l = shd.entry_axes(lspec[0]), shd.entry_axes(lspec[1])
    if not lead or rows_ax != lead + batch or seq_l != seq or not seq:
        raise ValueError(f"context-parallel decode over a stack {spec} takes a layer spec "
                         f"P({lead + batch}, {seq}), not {lspec}")
    sizes = shd.mesh_sizes(mesh)
    n_lead = math.prod(sizes[a] for a in lead)
    per = shape[0] // n_lead
    ns = shape[1] // math.prod(sizes[a] for a in batch)        # rows of a stack shard
    nb = shape[1] // math.prod(sizes[a] for a in rows_ax)      # rows a rank attends
    q = i // per
    names = shd.axis_names(mesh)
    ranks = mesh.mesh
    src_of, offset = {}, {}
    for pos in itertools.product(*(range(n) for n in ranks.shape)):
        coord = dict(zip(names, pos))
        block = 0
        for a in rows_ax:
            block = block * sizes[a] + coord[a]
        j, off = divmod(block * nb, ns)
        src = {**coord, **shd.shard_coordinate(mesh, lead, q),
               **shd.shard_coordinate(mesh, batch, j)}
        r = int(ranks[pos])
        src_of[r] = int(ranks[tuple(src[a] for a in names)])
        offset[r] = off
    groups = shd.source_groups(mesh, ("stack_rows", tuple(shape[:2]), spec, q), src_of)
    me = dist.get_rank()
    return i % per, slice(offset[me], offset[me] + nb), groups, src_of[me], seq


def cp_decode_stack_layer(params, x, k: StackLayer, v: StackLayer, cache_len, *, cfg, mesh,
                          rules):
    """Context-parallel decode attention at layer ``k.i`` of cache stacks
    cut over their layers: this rank's rows move in from the stack shard of
    the layer's owner, ``cp_decode_self_attention`` runs on them, and each
    row's new K/V token moves back into the owner's shard.

    In: the owner's ranks broadcast the layer's batch shard to the ranks
    whose rows it holds (one group per owner rank, ``source_groups``; a rank
    of another pod holds the moved rows only while this layer runs).  Out:
    each such rank contributes its rows' token, its slot in the sequence
    shard and whether that shard holds ``cache_len`` to one SUM over the
    group, and the owner writes them.  Returns out [b, 1, D] of this
    rank's rows; the stacks are written in place."""
    from torch.distributed.tensor import DTensor
    shape = tuple(k.stack.shape)
    spec = shd.resolve_pspec(shape, _STACK_AXES, mesh, rules)
    slot, rows, groups, mine, seq = _stack_plan(shape, spec, mesh, rules, k.i)
    want = shd.NamedSharding(mesh, shd.P(*spec[:3], None, None)).placements
    for c in (k, v):
        if (not isinstance(c.stack, DTensor) or tuple(c.stack.placements) != want
                or c.stack.device_mesh != mesh or c.i != k.i):
            raise ValueError(f"context-parallel decode takes the cache stacks as DTensors on "
                             f"the rules' mesh with placements {want}, at one layer")
    kl, vl = k.stack.to_local(), v.stack.to_local()             # [L / n, ns, s_l, Hk, hd]
    b = rows.stop - rows.start
    if x.shape[0] != b:
        raise ValueError(f"x holds {x.shape[0]} rows, the layer's spec gives this rank {b}")
    me = dist.get_rank()

    # in: the owner's batch shard of this layer, this rank's rows of it
    kr = vr = None
    for s in sorted(groups):
        bk = kl[slot] if s == me else kl.new_empty(kl.shape[1:])
        bv = vl[slot] if s == me else vl.new_empty(vl.shape[1:])
        dist.broadcast(bk, src=s, group=groups[s])
        dist.broadcast(bv, src=s, group=groups[s])
        if s == mine:
            kr, vr = bk[rows], bv[rows]
    out, kr, vr = cp_decode_self_attention(params, x, kr, vr, cache_len, cfg=cfg, mesh=mesh,
                                           axis=seq)

    # out: [token K | token V | held here | slot] of each row, summed over
    # the group (only the row's own rank adds other than zeros)
    s_l, hkd = kl.shape[2], kl.shape[3] * kl.shape[4]
    lens = torch.as_tensor(cache_len, dtype=torch.int32, device=x.device).expand(b)
    local = lens - shd.shard_index(mesh, seq) * s_l
    held = (local >= 0) & (local < s_l)
    idx = local.clamp(0, s_l - 1).long()
    bidx = torch.arange(b, device=x.device)
    back = torch.zeros((kl.shape[1], 2 * hkd + 2), dtype=torch.float32, device=x.device)
    back[rows] = torch.cat([kr[bidx, idx].reshape(b, hkd).float(),
                            vr[bidx, idx].reshape(b, hkd).float(),
                            held[:, None].float(), idx[:, None].float()], dim=1)
    for s in sorted(groups):
        buf = back if s == mine else torch.zeros_like(back)
        dist.all_reduce(buf, group=groups[s])
        if s == me:
            n = buf.shape[0]
            at = torch.arange(n, device=x.device)
            where = buf[:, -1].long()
            keep = (buf[:, -2] > 0)[:, None, None]
            for layer, part in ((kl[slot], buf[:, :hkd]), (vl[slot], buf[:, hkd:2 * hkd])):
                tok = part.reshape(n, *layer.shape[2:]).to(layer.dtype)
                layer[at, where] = torch.where(keep, tok, layer[at, where])
    return out
