"""GQA self-attention over a sequence: full, chunked (online softmax over KV
blocks) and the hand-written kernel, picked by ``cfg.attn_impl``.

``attn_impl`` keeps the reference's value set so a config carries across
unchanged: ``"pallas"`` (the reference's Pallas flash kernel on a TPU) means
the hand-written CUDA kernel here, reached through ``ops.flash_attention``.
``"auto"`` launches that kernel for activations on the card; for
activations on the CPU it keeps the reference's rule: ``"chunked"`` past
``8 * attn_q_chunk`` positions, else ``"full"``.  The decode step against a
KV cache (:func:`decode_self_attention`) follows the same rule with the
``decode_attention`` kernel; a ``decode_cp`` config under activation rules
whose mesh has a ``model`` axis takes the context-parallel path
(``dist/context_parallel.py``) instead.  Decode loops take each layer's
cache through :func:`cache_layer`, which hands that path a layer of a stack
the rules cut over its layers.  Cross attention (the VLM's image
blocks, whisper's decoder) is the reference's plain ``gqa_attend`` in both
forms, as no Pallas kernel computes it there.
"""
from __future__ import annotations

import torch

from repro_torch.common import ParamSpec
from repro_torch.common.scopes import scoped
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ref import NEG_INF, attn_scale
from repro_torch.models.layers import apply_rope, einsum, einsum_f32


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


def attention_spec(cfg: ModelConfig, *, cross: bool = False) -> dict:
    d, h, hk, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    specs = {
        ("wq",): ParamSpec((d, h, hd), ("embed_in", "heads", "qkv"), init="scaled"),
        ("wk",): ParamSpec((d, hk, hd), ("embed_in", "kv_heads", "qkv"), init="scaled"),
        ("wv",): ParamSpec((d, hk, hd), ("embed_in", "kv_heads", "qkv"), init="scaled"),
        ("wo",): ParamSpec((h, hd, d), ("heads", "qkv_in", "embed_out"), init="scaled"),
    }
    if cfg.qkv_bias and not cross:
        f32 = torch.float32
        specs[("bq",)] = ParamSpec((h, hd), ("heads", "qkv"), init="zeros", dtype=f32)
        specs[("bk",)] = ParamSpec((hk, hd), ("kv_heads", "qkv"), init="zeros", dtype=f32)
        specs[("bv",)] = ParamSpec((hk, hd), ("kv_heads", "qkv"), init="zeros", dtype=f32)
    return specs


def project_qkv(params, x, mem=None, *, cfg: ModelConfig, positions=None):
    """Project hidden states to (q, k, v) [B,S,H|Hk,hd].  ``mem`` (cross
    attention) supplies k/v; RoPE applies only to self-attention."""
    src = x if mem is None else mem
    q = einsum("bsd,dhk->bshk", x, params["wq"])
    k = einsum("bsd,dhk->bshk", src, params["wk"])
    v = einsum("bsd,dhk->bshk", src, params["wv"])
    if "bq" in params:
        q = q + params["bq"].to(q.dtype)
        k = k + params["bk"].to(k.dtype)
        v = v + params["bv"].to(v.dtype)
    if positions is not None and mem is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def out_proj(params, attn_out):
    return einsum("bshk,hkd->bsd", attn_out, params["wo"])


# ---------------------------------------------------------------------------
# Core softmax attention (GQA-aware)
# ---------------------------------------------------------------------------


def _repeat_kv(k, num_heads):
    """[B,S,Hk,hd] -> [B,S,H,hd]: q-head h reads kv-head h // (H/Hk)."""
    hk = k.shape[2]
    if hk == num_heads:
        return k
    return k.repeat_interleave(num_heads // hk, dim=2)


@scoped("attn_core")
def gqa_attend(q, k, v, mask):
    """q:[B,Sq,H,hd] k,v:[B,Sk,Hk,hd] mask: broadcastable to [B,1,Sq,Sk] (bool).

    Returns [B,Sq,H,hd]; scores and softmax in f32.  A single-token q
    (decode) takes the grouped product, which never repeats the KV."""
    b, sq, h, hd = q.shape
    hk = k.shape[2]
    scale = attn_scale(hd)
    if sq == 1 and hk != h:
        g = h // hk
        qg = q.reshape(b, 1, hk, g, hd)
        scores = einsum_f32("bqkgd,bskd->bkgqs", qg, k) * scale
        scores = torch.where(mask[:, :, None] if mask.dim() == 4 else mask,
                             scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        out = einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)
        return out.reshape(b, 1, h, hd)
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)
    scores = einsum_f32("bqhd,bshd->bhqs", q, k) * scale
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    # contiguous, as the kernel writes it: the out projection then reads it
    # without a copy of its own
    return einsum("bhqs,bshd->bqhd", probs.to(v.dtype), v).contiguous()


def make_mask(q_pos, k_pos, *, causal: bool, window: int = 0, k_valid=None):
    """Boolean mask [.., Sq, Sk] from absolute positions."""
    m = torch.ones(q_pos.shape[-1:] + k_pos.shape[-1:], dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m = q_pos[..., :, None] >= k_pos[..., None, :]
    if window:
        m = m & (q_pos[..., :, None] - k_pos[..., None, :] < window)
    if k_valid is not None:
        m = m & k_valid[..., None, :]
    return m


# ---------------------------------------------------------------------------
# Full / chunked / kernel self-attention over a sequence
# ---------------------------------------------------------------------------


def self_attention(params, x, *, cfg: ModelConfig, causal: bool = True):
    """Self-attention over a whole sequence.

    Returns (out [B,S,D], (k, v)): k/v are handed back as the reference
    does, for a prefill to fill a decode cache."""
    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device)
    q, k, v = project_qkv(params, x, cfg=cfg, positions=pos[None, :])
    impl = cfg.attn_impl
    if impl == "auto":
        if x.is_cuda:
            impl = "pallas"
        else:
            impl = "chunked" if s > 8 * cfg.attn_q_chunk else "full"
    if impl == "pallas":
        out = _kernel_attention(q, k, v, causal=causal, window=cfg.sliding_window)
    elif impl == "chunked":
        out = _kv_chunked_attention(q, k, v, cfg=cfg, causal=causal)
    else:
        out = _full_attention(q, k, v, causal=causal, window=cfg.sliding_window)
    return out_proj(params, out), (k, v)


@scoped("attn_core")
def _full_attention(q, k, v, *, causal: bool, window: int):
    """``gqa_attend`` under the mask of positions 0..S-1 (made inside the
    scope: the kernel path makes none)."""
    pos = torch.arange(q.shape[1], device=q.device)
    mask = make_mask(pos, pos, causal=causal, window=window)
    return gqa_attend(q, k, v, mask[None, None])


@scoped("attn_core")
def _kernel_attention(q, k, v, *, causal: bool, window: int):
    """The ``flash_attention`` kernel (``ops.flash_attention``); it reads the
    [B,S,H,hd] layout the projections produce, and .contiguous() copies
    only if a projection returned a strided view."""
    from repro_torch.kernels import ops as kops
    return kops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                causal=causal, window=window)


@scoped("attn_core")
def _kv_chunked_attention(q, k, v, *, cfg: ModelConfig, causal: bool):
    """Online-softmax loop over KV blocks of ``attn_q_chunk`` positions; the
    peak score buffer is [B, H, S, C] for one block."""
    b, s, h, hd = q.shape
    c = min(cfg.attn_q_chunk, s)
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)
    q_pos = torch.arange(s, device=q.device)
    scale = attn_scale(hd)
    f32 = torch.float32
    m = torch.full((b, h, s), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((b, h, s), dtype=f32, device=q.device)
    o = torch.zeros((b, s, h, hd), dtype=f32, device=q.device)
    for start in range(0, s, c):
        k_blk, v_blk = k[:, start:start + c], v[:, start:start + c]
        k_pos = start + torch.arange(k_blk.shape[1], device=q.device)
        mask = make_mask(q_pos, k_pos, causal=causal, window=cfg.sliding_window)
        sc = einsum_f32("bqhd,bshd->bhqs", q, k_blk) * scale
        sc = torch.where(mask[None, None], sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha.transpose(1, 2)[..., None] + einsum(
            "bhqs,bshd->bqhd", p.to(v_blk.dtype), v_blk).float()
        m = m_new
    o = o / torch.clamp(l.transpose(1, 2)[..., None], min=1e-30)
    return o.to(q.dtype).contiguous()


def cross_attention(params, x, mem, *, cfg: ModelConfig):
    """Cross-attention to a memory (image patches): every query sees every
    memory position.  The reference's ``mem_valid`` argument is left out:
    no caller passes it, and its mask does not broadcast (ROADMAP §3)."""
    q, k, v = project_qkv(params, x, mem, cfg=cfg)
    mask = torch.ones((1, 1, x.shape[1], mem.shape[1]), dtype=torch.bool, device=x.device)
    out = gqa_attend(q, k, v, mask)
    return out_proj(params, out)


# ---------------------------------------------------------------------------
# Decode-step attention against a KV cache
# ---------------------------------------------------------------------------


def cache_layer(stack, i: int):
    """Layer ``i`` of a [L, ...] cache stack, as a decode loop hands it to
    the attention: a view, or, where the stack is a ``DTensor`` whose layer
    dimension is cut over the mesh (``layers -> pod``), a ``StackLayer``
    that only context-parallel decode reads and writes."""
    placements = getattr(stack, "placements", None)
    if placements is not None and any(p.is_shard(0) for p in placements):
        from repro_torch.dist.context_parallel import StackLayer
        return StackLayer(stack, i)
    return stack[i]


def decode_self_attention(params, x, k_cache, v_cache, cache_len, *, cfg: ModelConfig):
    """x: [B,1,D]; caches: [B,Smax,Hk,hd]. Writes the new K/V at ``cache_len``
    in place (a row with ``cache_len >= Smax`` writes nothing, as the
    reference's ``mode="drop"``).

    ``cache_len`` may be a scalar (uniform batch) or a [B] vector
    (continuous batching: per-slot lengths).  The attention is
    ``decode_attend`` under the model's ``sliding_window``.  With
    ``cfg.decode_cp`` under ``activation_rules`` whose mesh has a ``model``
    axis it is context-parallel (:func:`_context_parallel`); otherwise, as
    in the reference, such a config takes this ordinary path.
    Returns (out [B,1,D], k_cache, v_cache)."""
    if cfg.decode_cp:
        out = _context_parallel(params, x, k_cache, v_cache, cache_len, cfg=cfg)
        if out is not None:
            return out
    if isinstance(k_cache, tuple):
        raise ValueError("a cache stack cut over its layers is read by context-parallel "
                         "decode alone (decode_cp under rules whose mesh has a model axis)")
    b, s_max = x.shape[0], k_cache.shape[1]
    lens = torch.as_tensor(cache_len, dtype=torch.int32, device=x.device).expand(b)
    q, k_new, v_new = project_qkv(params, x, cfg=cfg, positions=lens[:, None])
    # the write is dropped for rows at lens >= Smax: such a row writes back
    # what position Smax - 1 holds, so no index leaves the cache and the
    # host never has to look at lens
    bidx = torch.arange(b, device=x.device)
    keep = (lens < s_max)[:, None, None]
    pos = lens.clamp(max=s_max - 1).long()
    k_cache[bidx, pos] = torch.where(keep, k_new[:, 0].to(k_cache.dtype), k_cache[bidx, pos])
    v_cache[bidx, pos] = torch.where(keep, v_new[:, 0].to(v_cache.dtype), v_cache[bidx, pos])
    out = decode_attend(q, k_cache, v_cache, lens, window=cfg.sliding_window, cfg=cfg)
    return out_proj(params, out), k_cache, v_cache


def _context_parallel(params, x, k_cache, v_cache, cache_len, *, cfg: ModelConfig):
    """The reference's ``decode_cp`` branch: resolve the caches' spec under
    the installed rules and run ``cp_decode_self_attention`` on this rank's
    shards; None when no rules with a ``model`` axis are installed.

    The caches are ``DTensor``s (``NamedSharding.distribute``) whose global
    shape the spec is resolved from, sharded as the reference's ``shard_map``
    takes them: ``P(batch, kv_seq axes, None, None)``; x and ``cache_len``
    hold this rank's batch rows.  Where the rules cut the stack's layers
    the caches are ``StackLayer``s of the stacks (:func:`cache_layer`), and
    ``cp_decode_stack_layer`` moves this rank's rows of the layer in from
    their owner and the new tokens back."""
    from repro_torch.dist import sharding as shd
    ctx = shd.model_rules()
    if ctx is None:
        return None
    from torch.distributed.tensor import DTensor

    from repro_torch.dist import context_parallel as cp
    mesh, rules = ctx
    if isinstance(k_cache, cp.StackLayer):
        out = cp.cp_decode_stack_layer(params, x, k_cache, v_cache, cache_len, cfg=cfg,
                                       mesh=mesh, rules=rules)
        return out, k_cache, v_cache
    spec = shd.resolve_pspec(tuple(k_cache.shape), ("batch", "kv_seq", "kv_heads", "qkv"),
                             mesh, rules)
    seq_axes = spec[1] if spec[1] is not None else "model"
    want = shd.NamedSharding(mesh, shd.P(spec[0], seq_axes, None, None)).placements
    for c in (k_cache, v_cache):
        if not isinstance(c, DTensor) or tuple(c.placements) != want or c.device_mesh != mesh:
            raise ValueError(f"context-parallel decode takes the caches as DTensors on the "
                             f"rules' mesh with placements {want}")
    kc, vc = k_cache.to_local(), v_cache.to_local()
    if x.shape[0] != kc.shape[0]:
        raise ValueError(f"x holds {x.shape[0]} rows, this rank's cache shard {kc.shape[0]}")
    out, _, _ = cp.cp_decode_self_attention(params, x, kc, vc, cache_len, cfg=cfg, mesh=mesh,
                                            axis=seq_axes)
    return out, k_cache, v_cache


@scoped("attn_core")
def decode_attend(q, k, v, lens, *, window: int, cfg: ModelConfig):
    """One new token per row against its keys: q [B,1,H,hd], k/v
    [B,S,Hk,hd], positions ``0..lens[b]`` and, with ``window > 0``, also
    ``lens[b] - pos < window``.  On the card under ``attn_impl`` ``"auto"``
    or ``"pallas"`` the ``decode_attention`` kernel; otherwise, and always
    on the CPU, ``gqa_attend`` under that mask."""
    if q.is_cuda and cfg.attn_impl in ("auto", "pallas"):
        from repro_torch.kernels import ops as kops
        return kops.decode_attention(q.contiguous(), k, v, lens.contiguous(), window=window)
    k_pos = torch.arange(k.shape[1], device=q.device)
    k_valid = k_pos[None, :] <= lens[:, None]
    if window:
        k_valid = k_valid & (lens[:, None] - k_pos[None, :] < window)
    return gqa_attend(q, k, v, k_valid[:, None, None, :])


def decode_cross_attention(params, x, k_mem, v_mem, *, cfg: ModelConfig):
    """Cross-attn during decode with precomputed memory K/V: [B,Sm,Hk,hd]."""
    q = einsum("bsd,dhk->bshk", x, params["wq"])
    if "bq" in params:
        q = q + params["bq"].to(q.dtype)
    mask = torch.ones((1, 1, 1, k_mem.shape[1]), dtype=torch.bool, device=x.device)
    out = gqa_attend(q, k_mem, v_mem, mask)
    return out_proj(params, out)
