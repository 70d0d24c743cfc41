"""Unified decoder-only transformer LM (dense / MoE / VLM families).

Parameters are stacked over layers, as in the reference (whose
``jax.lax.scan`` keeps its compile time O(1) in depth), so that a JAX param
tree maps one to one onto the port's through ``common.params_from_numpy``;
here a Python loop walks the layer index.  Heterogeneous depth patterns keep
the reference's grouped stacks:

  * MoE with ``moe_interval=k``: groups of (k-1 dense + 1 MoE) layers, the
    dense layers in ``layers`` and the MoE ones in ``moe_layers``
  * VLM with ``cross_attn_interval=k``: groups of (1 gated cross-attention
    block + k self-attention layers), the blocks in ``cross_layers``

:func:`_blocks` lists the blocks in the order a token passes them, and every
entry point walks that list.  Each decoder layer opens with the reference's
``shard_activation`` hint, the identity on the plain tensors the port's
ranks hold (``dist/sharding.py``).

Three entry points share the layer bodies:
  forward      (scoring: full sequence -> logits, MoE aux losses)
  prefill      (full sequence -> logits + filled KV cache)
  decode_step  (1 token + cache -> logits + updated cache)

The KV cache is the reference's dict of [L, B, Smax, Hk, hd] tensors:
``{"self"}`` for the dense and MoE layouts, ``{"dense", "moe"}`` for the
interleaved MoE layout, and ``{"self", "cross"}`` for the VLM, whose
``cross`` entry holds each cross block's image K/V, computed once by the
prefill.  The port writes the cache in place (the reference returns a new
one) and returns the same dict, so a step moves no more than the new
positions.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common import ParamSpec, SpecTree
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import shard_activation
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------


def _stack(specs: dict, n: int, prefix: str) -> SpecTree:
    out = {}
    for path, s in specs.items():
        out[(prefix,) + path] = ParamSpec((n,) + s.shape, ("layers",) + s.axes,
                                          dtype=s.dtype, init=s.init, init_scale=s.init_scale)
    return out


def _decoder_layer_specs(cfg: ModelConfig, *, use_moe: bool) -> dict:
    specs: dict = {}
    for p, s in attn.attention_spec(cfg).items():
        specs[("attn",) + p] = s
    for p, s in L.rmsnorm_spec(cfg.d_model).items():
        specs[("attn_norm",) + p] = s
        specs[("ffn_norm",) + p] = s
    if use_moe:
        for p, s in moe_mod.moe_spec(cfg).items():
            specs[("moe",) + p] = s
        if cfg.moe_shared_expert:
            for p, s in L.swiglu_spec(cfg.d_model, cfg.d_ff).items():
                specs[("shared",) + p] = s
    else:
        for p, s in L.swiglu_spec(cfg.d_model, cfg.d_ff).items():
            specs[("ffn",) + p] = s
    return specs


def _cross_layer_specs(cfg: ModelConfig) -> dict:
    specs: dict = {}
    for p, s in attn.attention_spec(cfg, cross=True).items():
        specs[("xattn",) + p] = s
    for p, s in L.rmsnorm_spec(cfg.d_model).items():
        specs[("xattn_norm",) + p] = s
        specs[("xffn_norm",) + p] = s
    for p, s in L.swiglu_spec(cfg.d_model, cfg.d_ff).items():
        specs[("xffn",) + p] = s
    specs[("attn_gate",)] = ParamSpec((), (), init="zeros", dtype=torch.float32)
    specs[("ffn_gate",)] = ParamSpec((), (), init="zeros", dtype=torch.float32)
    return specs


def layer_layout(cfg: ModelConfig) -> dict:
    """How the depth dimension is organized into stacks."""
    if cfg.family == "vlm" and cfg.cross_attn_interval:
        n_groups = cfg.num_layers // cfg.cross_attn_interval
        return {"kind": "vlm", "groups": n_groups, "per_group": cfg.cross_attn_interval,
                "dense": cfg.num_layers, "cross": n_groups}
    if cfg.is_moe and cfg.moe_interval > 1:
        n_groups = cfg.num_layers // cfg.moe_interval
        return {"kind": "moe_interleave", "groups": n_groups,
                "dense_per_group": cfg.moe_interval - 1,
                "dense": n_groups * (cfg.moe_interval - 1), "moe": n_groups}
    if cfg.is_moe:
        return {"kind": "moe", "moe": cfg.num_layers, "dense": 0}
    return {"kind": "dense", "dense": cfg.num_layers}


def param_specs(cfg: ModelConfig) -> SpecTree:
    lay = layer_layout(cfg)
    specs: SpecTree = {}
    specs.update({("embed",) + p: s for p, s in L.embed_spec(cfg.vocab_size, cfg.d_model).items()})
    if lay["kind"] == "moe":
        specs.update(_stack(_decoder_layer_specs(cfg, use_moe=True), lay["moe"], "layers"))
    else:
        if lay.get("dense"):
            specs.update(_stack(_decoder_layer_specs(cfg, use_moe=False), lay["dense"], "layers"))
        if lay["kind"] == "moe_interleave":
            specs.update(_stack(_decoder_layer_specs(cfg, use_moe=True), lay["moe"], "moe_layers"))
        if lay["kind"] == "vlm":
            specs.update(_stack(_cross_layer_specs(cfg), lay["cross"], "cross_layers"))
    specs.update({("final_norm",) + p: s for p, s in L.rmsnorm_spec(cfg.d_model).items()})
    specs.update({("out",) + p: s for p, s in L.unembed_spec(
        cfg.vocab_size, cfg.d_model, tied=cfg.tie_embeddings).items()})
    return specs


def _blocks(cfg: ModelConfig) -> list[tuple[str, str, str, int]]:
    """The blocks in the order a token passes them: (kind, param stack,
    cache entry, index in both).  ``kind`` is "dense" or "moe" for a decoder
    layer and "cross" for a VLM cross block.  A grouped stack splits into
    equal groups, as the reference's reshape does, or raises."""
    lay = layer_layout(cfg)
    kind = lay["kind"]
    if kind in ("dense", "moe"):
        return [(kind, "layers", "self", i) for i in range(lay[kind])]
    groups = lay["groups"]
    per = lay["dense"] // groups if groups else 0
    if not groups or per * groups != lay["dense"]:
        raise ValueError(f"{cfg.name}: {lay['dense']} layers do not split into "
                         f"{groups} {kind} groups")
    out = []
    for g in range(groups):
        dense = [("dense", "layers", "dense" if kind == "moe_interleave" else "self",
                  g * per + j) for j in range(per)]
        if kind == "moe_interleave":
            out += dense + [("moe", "moe_layers", "moe", g)]
        else:
            out += [("cross", "cross_layers", "cross", g)] + dense
    return out


# ---------------------------------------------------------------------------
# Layer bodies
# ---------------------------------------------------------------------------


def _ffn(lp, h, *, cfg: ModelConfig, use_moe: bool):
    """The layer's FFN: (out, aux).  A MoE layer adds the shared expert."""
    if not use_moe:
        return L.swiglu(lp["ffn"], h), {}
    f, aux = moe_mod.moe_ffn(lp["moe"], h, cfg=cfg)
    if cfg.moe_shared_expert:
        f = f + L.swiglu(lp["shared"], h)
    return f, aux


def _decoder_layer_seq(lp, x, *, cfg: ModelConfig, use_moe: bool):
    """Full-sequence decoder layer. Returns (x, (k, v), aux)."""
    x = shard_activation(x, ("batch", "seq_act", "embed_act"))
    h = L.rmsnorm(lp["attn_norm"], x, cfg.norm_eps)
    a, kv = attn.self_attention(lp["attn"], h, cfg=cfg)
    x = x + a
    h = L.rmsnorm(lp["ffn_norm"], x, cfg.norm_eps)
    f, aux = _ffn(lp, h, cfg=cfg, use_moe=use_moe)
    return x + f, kv, aux


def _decoder_layer_decode(lp, x, k_cache, v_cache, cache_len, *, cfg: ModelConfig,
                          use_moe: bool):
    """One token through one layer; the caches are written in place."""
    h = L.rmsnorm(lp["attn_norm"], x, cfg.norm_eps)
    a, _, _ = attn.decode_self_attention(lp["attn"], h, k_cache, v_cache, cache_len,
                                         cfg=cfg)
    x = x + a
    h = L.rmsnorm(lp["ffn_norm"], x, cfg.norm_eps)
    return x + _ffn(lp, h, cfg=cfg, use_moe=use_moe)[0]


def _gated(gate: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """tanh of a cross block's f32 gate, in the activations' dtype."""
    return torch.tanh(gate).to(x.dtype)


def _cross_block_seq(cp, x, mem, *, cfg: ModelConfig):
    h = L.rmsnorm(cp["xattn_norm"], x, cfg.norm_eps)
    a = attn.cross_attention(cp["xattn"], h, mem, cfg=cfg)
    x = x + _gated(cp["attn_gate"], x) * a
    h = L.rmsnorm(cp["xffn_norm"], x, cfg.norm_eps)
    return x + _gated(cp["ffn_gate"], x) * L.swiglu(cp["xffn"], h)


def _cross_block_decode(cp, x, k_mem, v_mem, *, cfg: ModelConfig):
    h = L.rmsnorm(cp["xattn_norm"], x, cfg.norm_eps)
    a = attn.decode_cross_attention(cp["xattn"], h, k_mem, v_mem, cfg=cfg)
    x = x + _gated(cp["attn_gate"], x) * a
    h = L.rmsnorm(cp["xffn_norm"], x, cfg.norm_eps)
    return x + _gated(cp["ffn_gate"], x) * L.swiglu(cp["xffn"], h)


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a param tree stacked over layers (views, no copy).  A
    stack may also be a list of per-layer tensors: the train step
    differentiates each layer's slice as a leaf of its own."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _maybe_remat(fn, cfg: ModelConfig, enable: bool):
    """``fn`` rematerialized in the backward pass when ``enable and
    cfg.remat`` and autograd is recording (the reference's ``jax.checkpoint``
    under ``nothing_saveable``): only the block's inputs are kept, and its
    forward runs again when the gradient reaches it."""
    if enable and cfg.remat and torch.is_grad_enabled():
        return functools.partial(checkpoint, fn, use_reentrant=False)
    return fn


def _set_layer(tree: dict, i: int, values: dict) -> None:
    """Write ``values`` (a tree of one layer's tensors) into layer ``i`` of a
    tree stacked over layers, in place and in the stack's dtypes: the port's
    ``_write_prefill`` and the reference's restacking of scanned states."""
    for k, v in values.items():
        if isinstance(v, dict):
            _set_layer(tree[k], i, v)
        else:
            tree[k][i] = v


def _add_aux(acc, aux):
    return {k: acc.get(k, 0.0) + v for k, v in aux.items()} if aux else acc


def _image_embeds(cfg: ModelConfig, extra):
    if not extra or "image_embeds" not in extra:
        raise ValueError(f"{cfg.name} (vlm) needs extra['image_embeds'] [B, "
                         f"{cfg.num_image_tokens}, {cfg.d_model}]")
    return extra["image_embeds"]


# ---------------------------------------------------------------------------
# Full-sequence pass (scoring / prefill)
# ---------------------------------------------------------------------------


def _run_layers_seq(params, x, *, cfg: ModelConfig, extra=None, cache=None,
                    remat: bool = False):
    """The blocks over a whole sequence -> (x, aux).  With ``cache``, each
    decoder layer's K/V is written at the head of its [B, Smax] cache, and
    each cross block's image K/V into ``cache["cross"]``.  ``remat``
    rematerializes each block (:func:`_maybe_remat`)."""
    blocks = _blocks(cfg)
    mem = _image_embeds(cfg, extra) if blocks[0][0] == "cross" else None
    aux = {"moe_lb": 0.0, "moe_z": 0.0} if cfg.is_moe else {}
    s = x.shape[1]
    layer_fn = _maybe_remat(_decoder_layer_seq, cfg, remat)
    cross_fn = _maybe_remat(_cross_block_seq, cfg, remat)
    for kind, stack, entry, i in blocks:
        lp = _layer(params[stack], i)
        if kind == "cross":
            x = cross_fn(lp, x, mem, cfg=cfg)
            if cache is not None:   # the image K/V, computed once for decode
                cache[entry]["k"][i] = L.einsum("bsd,dhk->bshk", mem, lp["xattn"]["wk"])
                cache[entry]["v"][i] = L.einsum("bsd,dhk->bshk", mem, lp["xattn"]["wv"])
            continue
        x, (k, v), a = layer_fn(lp, x, cfg=cfg, use_moe=kind == "moe")
        aux = _add_aux(aux, a)
        if cache is not None:
            cache[entry]["k"][i, :, :s] = k
            cache[entry]["v"][i, :, :s] = v
    return x, aux


def forward(params, tokens: torch.Tensor, *, cfg: ModelConfig, extra=None,
            remat: bool = False):
    """tokens [B,S] -> (logits [B,S,V] f32, aux dict: the MoE losses summed
    over the MoE layers, empty for the other layouts)."""
    x = L.embed(params["embed"], tokens).to(cfg.activation_dtype)
    x, aux = _run_layers_seq(params, x, cfg=cfg, extra=extra, remat=remat)
    return _logits(params, x, cfg=cfg), aux


# ---------------------------------------------------------------------------
# KV cache structure + prefill / decode
# ---------------------------------------------------------------------------


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> SpecTree:
    lay = layer_layout(cfg)
    kv_axes = ("layers", "batch", "kv_seq", "kv_heads", "qkv")

    def kv(n_layers, seq):
        return ParamSpec((n_layers, batch, seq, cfg.num_kv_heads, cfg.hd), kv_axes,
                         dtype=cfg.activation_dtype, init="zeros")

    if lay["kind"] in ("dense", "moe"):
        entries = {"self": kv(lay.get("dense") or lay.get("moe"), max_seq)}
    elif lay["kind"] == "moe_interleave":
        entries = {"dense": kv(lay["groups"] * lay["dense_per_group"], max_seq),
                   "moe": kv(lay["groups"], max_seq)}
    else:  # vlm
        entries = {"self": kv(lay["dense"], max_seq),
                   "cross": kv(lay["cross"], cfg.num_image_tokens)}
    return {(entry, name): spec for entry, spec in entries.items() for name in ("k", "v")}


def _logits(params, x, *, cfg: ModelConfig):
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.unembed({**params.get("out", {}), **params["embed"]}, x,
                     tied=cfg.tie_embeddings)


def prefill(params, tokens: torch.Tensor, cache: dict, *, cfg: ModelConfig, extra=None,
            last_only: bool = False):
    """tokens [B,S] + cache -> (logits [B,S,V] f32, cache with positions
    0..S-1 written in place; for the VLM also the image K/V).

    ``last_only`` computes the unembedding for the final position only
    (logits [B,1,V])."""
    x = L.embed(params["embed"], tokens).to(cfg.activation_dtype)
    x, _ = _run_layers_seq(params, x, cfg=cfg, extra=extra, cache=cache)
    if last_only:
        x = x[:, -1:]
    return _logits(params, x, cfg=cfg), cache


def decode_step(params, tokens: torch.Tensor, cache: dict, cache_len, *,
                cfg: ModelConfig, extra=None):
    """tokens [B,1] + cache + cache_len (scalar or [B]) -> (logits [B,1,V]
    f32, cache with position cache_len written in place).  ``extra`` is
    unused, as in the reference: the VLM reads its image K/V from the cache."""
    x = L.embed(params["embed"], tokens).to(cfg.activation_dtype)
    # one [B] lengths tensor on the activations' device for every layer
    lens = torch.as_tensor(cache_len, dtype=torch.int32, device=x.device)
    lens = lens.expand(x.shape[0]).contiguous()
    for kind, stack, entry, i in _blocks(cfg):
        lp = _layer(params[stack], i)
        kc, vc = cache[entry]["k"][i], cache[entry]["v"][i]
        if kind == "cross":
            x = _cross_block_decode(lp, x, kc, vc, cfg=cfg)
        else:
            x = _decoder_layer_decode(lp, x, kc, vc, lens, cfg=cfg, use_moe=kind == "moe")
    return _logits(params, x, cfg=cfg), cache
