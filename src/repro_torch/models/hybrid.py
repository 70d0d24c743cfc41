"""Zamba2-style hybrid: Mamba2 backbone + one *shared* attention block applied
every ``cfg.attn_every`` layers (arXiv:2411.15242).

As in the reference:
  * the shared block's "concatenated original embedding" skip is a learned
    projection of the token embedding ``x0`` added to the block's input
    (width d instead of 2d),
  * per-application LoRA deltas on the shared block are omitted (pure
    sharing).

Depth layout for L layers, every=k: G = L // k groups of (k Mamba layers +
1 shared-attention application), then L - G*k trailing Mamba layers.  The
cache holds each Mamba layer's state (``mamba``, ``tail``: conv history and
SSD state, no sequence axis) and one K/V [G, B, Smax, Hk, hd] for the
shared block's G applications (``attn``); ``prefill`` and ``decode_step``
write it in place and return the same dict.
"""
from __future__ import annotations

import torch

from repro_torch.common import ParamSpec, SpecTree
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import shard_activation
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models.transformer import _layer, _maybe_remat, _set_layer, _stack


def _layout(cfg: ModelConfig):
    g = cfg.num_layers // cfg.attn_every
    return {"groups": g, "per_group": cfg.attn_every,
            "tail": cfg.num_layers - g * cfg.attn_every}


def _blocks(cfg: ModelConfig) -> list[tuple[str, int]]:
    """(param stack and cache entry, index) in the order a token passes them;
    ``("shared", g)`` is the shared block's application g."""
    lay = _layout(cfg)
    per = lay["per_group"]
    out = []
    for g in range(lay["groups"]):
        out += [("mamba", g * per + j) for j in range(per)] + [("shared", g)]
    return out + [("tail", i) for i in range(lay["tail"])]


def _mamba_block_specs(cfg: ModelConfig) -> dict:
    specs = {("norm",) + p: s for p, s in L.rmsnorm_spec(cfg.d_model).items()}
    specs.update({("mixer",) + p: s for p, s in ssm.mamba2_spec(cfg).items()})
    return specs


def _shared_attn_specs(cfg: ModelConfig) -> dict:
    specs: dict = {}
    specs.update({("attn",) + p: s for p, s in attn.attention_spec(cfg).items()})
    specs.update({("attn_norm",) + p: s for p, s in L.rmsnorm_spec(cfg.d_model).items()})
    specs.update({("ffn_norm",) + p: s for p, s in L.rmsnorm_spec(cfg.d_model).items()})
    specs.update({("ffn",) + p: s for p, s in L.swiglu_spec(cfg.d_model, cfg.d_ff).items()})
    specs[("skip_proj",)] = ParamSpec((cfg.d_model, cfg.d_model), ("embed_in", "embed_out"),
                                      init="scaled")
    return specs


def param_specs(cfg: ModelConfig) -> SpecTree:
    lay = _layout(cfg)
    specs: SpecTree = {}
    specs.update({("embed",) + p: s for p, s in L.embed_spec(cfg.vocab_size, cfg.d_model).items()})
    specs.update(_stack(_mamba_block_specs(cfg), lay["groups"] * lay["per_group"],
                        "mamba_layers"))
    if lay["tail"]:
        specs.update(_stack(_mamba_block_specs(cfg), lay["tail"], "tail_layers"))
    specs.update({("shared",) + p: s for p, s in _shared_attn_specs(cfg).items()})
    specs.update({("final_norm",) + p: s for p, s in L.rmsnorm_spec(cfg.d_model).items()})
    specs.update({("out",) + p: s for p, s in L.unembed_spec(
        cfg.vocab_size, cfg.d_model, tied=cfg.tie_embeddings).items()})
    return specs


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _skip_in(sp, x, x0):
    """The shared block's input: x plus the projected token embedding."""
    return x + L.einsum("bsd,de->bse", x0, sp["skip_proj"])


def _shared_attn_seq(sp, x, x0, *, cfg):
    """Shared transformer block over a sequence -> (x, (k, v))."""
    h = L.rmsnorm(sp["attn_norm"], _skip_in(sp, x, x0), cfg.norm_eps)
    a, kv = attn.self_attention(sp["attn"], h, cfg=cfg)
    x = x + a
    h = L.rmsnorm(sp["ffn_norm"], x, cfg.norm_eps)
    return x + L.swiglu(sp["ffn"], h), kv


def _shared_attn_decode(sp, x, x0, k_cache, v_cache, cache_len, *, cfg):
    h = L.rmsnorm(sp["attn_norm"], _skip_in(sp, x, x0), cfg.norm_eps)
    a, _, _ = attn.decode_self_attention(sp["attn"], h, k_cache, v_cache, cache_len, cfg=cfg)
    x = x + a
    h = L.rmsnorm(sp["ffn_norm"], x, cfg.norm_eps)
    return x + L.swiglu(sp["ffn"], h)


# ---------------------------------------------------------------------------
# Forward / prefill / decode
# ---------------------------------------------------------------------------


def _mamba_block(lp, x, *, cfg: ModelConfig):
    return x + ssm.mamba2_forward(lp["mixer"], L.rmsnorm(lp["norm"], x, cfg.norm_eps), cfg=cfg)


def _run_seq(params, x, *, cfg: ModelConfig, cache=None, remat: bool = False):
    """The blocks over a whole sequence; with ``cache``, each Mamba layer's
    final state and each shared application's K/V (at the head of its
    [B, Smax] rows) are written into the cache.  ``remat`` rematerializes
    the Mamba blocks, as the reference does (the shared block is not)."""
    x0, s = x, x.shape[1]
    mamba = _maybe_remat(_mamba_block, cfg, remat)
    for stack, i in _blocks(cfg):
        x = shard_activation(x, ("batch", None, None))  # keep batch on dp axes
        if stack == "shared":
            x, (k, v) = _shared_attn_seq(params["shared"], x, x0, cfg=cfg)
            if cache is not None:
                cache["attn"]["k"][i, :, :s] = k
                cache["attn"]["v"][i, :, :s] = v
            continue
        lp = _layer(params[f"{stack}_layers"], i)
        if cache is None:
            x = mamba(lp, x, cfg=cfg)
        else:
            h = L.rmsnorm(lp["norm"], x, cfg.norm_eps)
            y, st = ssm.mamba2_forward(lp["mixer"], h, cfg=cfg, return_state=True)
            _set_layer(cache[stack], i, st)
            x = x + y
    return x


def _logits(params, x, cfg):
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.unembed({**params.get("out", {}), **params["embed"]}, x, tied=cfg.tie_embeddings)


def forward(params, tokens, *, cfg: ModelConfig, extra=None, remat: bool = False):
    x = L.embed(params["embed"], tokens).to(cfg.activation_dtype)
    return _logits(params, _run_seq(params, x, cfg=cfg, remat=remat), cfg), {}


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> SpecTree:
    lay = _layout(cfg)
    specs: SpecTree = {}
    for path, s in ssm.mamba2_state_specs(cfg, batch).items():
        for entry, n in (("mamba", lay["groups"] * lay["per_group"]), ("tail", lay["tail"])):
            if n:
                specs[(entry,) + path] = ParamSpec((n,) + s.shape, ("layers",) + s.axes,
                                                   dtype=s.dtype, init="zeros")
    kv_axes = ("layers", "batch", "kv_seq", "kv_heads", "qkv")
    shp = (lay["groups"], batch, max_seq, cfg.num_kv_heads, cfg.hd)
    for name in ("k", "v"):
        specs[("attn", name)] = ParamSpec(shp, kv_axes, dtype=cfg.activation_dtype,
                                          init="zeros")
    return specs


def prefill(params, tokens, cache, *, cfg: ModelConfig, extra=None, last_only=False):
    """tokens [B,S] + cache -> (logits, cache holding each Mamba layer's state
    after token S-1 and the shared block's K/V at positions 0..S-1, written
    in place)."""
    x = L.embed(params["embed"], tokens).to(cfg.activation_dtype)
    x = _run_seq(params, x, cfg=cfg, cache=cache)
    if last_only:
        x = x[:, -1:]
    return _logits(params, x, cfg), cache


def decode_step(params, tokens, cache, cache_len, *, cfg: ModelConfig, extra=None):
    """tokens [B,1] + cache + cache_len (scalar or [B]) -> (logits [B,1,V],
    cache stepped in place: the Mamba states, and each shared application's
    K/V at position cache_len)."""
    x = L.embed(params["embed"], tokens).to(cfg.activation_dtype)
    x0 = x
    # one [B] lengths tensor on the activations' device for every application
    lens = torch.as_tensor(cache_len, dtype=torch.int32, device=x.device)
    lens = lens.expand(x.shape[0]).contiguous()
    for stack, i in _blocks(cfg):
        if stack == "shared":
            x = _shared_attn_decode(params["shared"], x, x0, cache["attn"]["k"][i],
                                    cache["attn"]["v"][i], lens, cfg=cfg)
            continue
        lp = _layer(params[f"{stack}_layers"], i)
        h = L.rmsnorm(lp["norm"], x, cfg.norm_eps)
        st, y = ssm.mamba2_decode(lp["mixer"], _layer(cache[stack], i), h, cfg=cfg)
        _set_layer(cache[stack], i, st)
        x = x + y
    return _logits(params, x, cfg), cache
