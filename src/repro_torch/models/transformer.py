"""Decoder-only transformer LM, dense layout.

Parameters are stacked over layers, as in the reference (whose
``jax.lax.scan`` keeps its compile time O(1) in depth), so that a JAX param
tree maps one to one onto the port's through ``common.params_from_numpy``;
here a Python loop walks the layer index.  The reference's
``shard_activation`` is the identity without a mesh and is dropped until the
sharding rules are ported (ROADMAP item 12).

Three entry points share the layer body:
  forward      (scoring: full sequence -> logits)
  prefill      (full sequence -> logits + filled KV cache)
  decode_step  (1 token + cache -> logits + updated cache)

The KV cache is a dict ``{"self": {"k", "v"}}`` of [L, B, Smax, Hk, hd]
tensors, as the reference's; the port writes it in place (the reference
returns a new one) and returns the same dict, so a step moves no more than
the new positions.  The MoE and VLM layouts raise (ROADMAP item 10).
"""
from __future__ import annotations

import torch

from repro_torch.common import ParamSpec, SpecTree
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------


def _stack(specs: dict, n: int, prefix: str) -> SpecTree:
    out = {}
    for path, s in specs.items():
        out[(prefix,) + path] = ParamSpec((n,) + s.shape, ("layers",) + s.axes,
                                          dtype=s.dtype, init=s.init, init_scale=s.init_scale)
    return out


def _decoder_layer_specs(cfg: ModelConfig) -> dict:
    specs: dict = {}
    for p, s in attn.attention_spec(cfg).items():
        specs[("attn",) + p] = s
    for p, s in L.rmsnorm_spec(cfg.d_model).items():
        specs[("attn_norm",) + p] = s
        specs[("ffn_norm",) + p] = s
    for p, s in L.swiglu_spec(cfg.d_model, cfg.d_ff).items():
        specs[("ffn",) + p] = s
    return specs


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.is_moe:
        kind = "MoE" if cfg.is_moe else cfg.family
        raise NotImplementedError(
            f"the {kind} layout of {cfg.name} is not ported yet (ROADMAP item 10)")


def param_specs(cfg: ModelConfig) -> SpecTree:
    _require_dense(cfg)
    specs: SpecTree = {}
    specs.update({("embed",) + p: s for p, s in L.embed_spec(cfg.vocab_size, cfg.d_model).items()})
    specs.update(_stack(_decoder_layer_specs(cfg), cfg.num_layers, "layers"))
    specs.update({("final_norm",) + p: s for p, s in L.rmsnorm_spec(cfg.d_model).items()})
    specs.update({("out",) + p: s for p, s in L.unembed_spec(
        cfg.vocab_size, cfg.d_model, tied=cfg.tie_embeddings).items()})
    return specs


# ---------------------------------------------------------------------------
# Layer body and the full-sequence pass
# ---------------------------------------------------------------------------


def _decoder_layer_seq(lp, x, *, cfg: ModelConfig):
    """Full-sequence decoder layer. Returns (x, (k, v))."""
    h = L.rmsnorm(lp["attn_norm"], x, cfg.norm_eps)
    a, kv = attn.self_attention(lp["attn"], h, cfg=cfg)
    x = x + a
    h = L.rmsnorm(lp["ffn_norm"], x, cfg.norm_eps)
    return x + L.swiglu(lp["ffn"], h), kv


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a param tree stacked over layers (views, no copy)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _decoder_layer_decode(lp, x, k_cache, v_cache, cache_len, *, cfg: ModelConfig):
    """One token through one layer; the caches are written in place."""
    h = L.rmsnorm(lp["attn_norm"], x, cfg.norm_eps)
    a, _, _ = attn.decode_self_attention(lp["attn"], h, k_cache, v_cache, cache_len,
                                         cfg=cfg)
    x = x + a
    h = L.rmsnorm(lp["ffn_norm"], x, cfg.norm_eps)
    return x + L.swiglu(lp["ffn"], h)


def _run_layers_seq(params, x, *, cfg: ModelConfig, cache=None):
    """The layers over a whole sequence; with ``cache``, each layer's K/V
    is written at the head of its [B, Smax] cache."""
    _require_dense(cfg)
    s = x.shape[1]
    for i in range(cfg.num_layers):
        x, (k, v) = _decoder_layer_seq(_layer(params["layers"], i), x, cfg=cfg)
        if cache is not None:
            cache["self"]["k"][i, :, :s] = k
            cache["self"]["v"][i, :, :s] = v
    return x


def forward(params, tokens: torch.Tensor, *, cfg: ModelConfig):
    """tokens [B,S] -> (logits [B,S,V] f32, aux dict)."""
    x = L.embed(params["embed"], tokens).to(cfg.activation_dtype)
    x = _run_layers_seq(params, x, cfg=cfg)
    return _logits(params, x, cfg=cfg), {}


# ---------------------------------------------------------------------------
# KV cache structure + prefill / decode
# ---------------------------------------------------------------------------


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> SpecTree:
    _require_dense(cfg)
    kv = ParamSpec((cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.hd),
                   ("layers", "batch", "kv_seq", "kv_heads", "qkv"),
                   dtype=cfg.activation_dtype, init="zeros")
    return {("self", "k"): kv, ("self", "v"): kv}


def _logits(params, x, *, cfg: ModelConfig):
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.unembed({**params.get("out", {}), **params["embed"]}, x,
                     tied=cfg.tie_embeddings)


def prefill(params, tokens: torch.Tensor, cache: dict, *, cfg: ModelConfig,
            last_only: bool = False):
    """tokens [B,S] + cache -> (logits [B,S,V] f32, cache with positions
    0..S-1 written in place).

    ``last_only`` computes the unembedding for the final position only
    (logits [B,1,V])."""
    x = L.embed(params["embed"], tokens).to(cfg.activation_dtype)
    x = _run_layers_seq(params, x, cfg=cfg, cache=cache)
    if last_only:
        x = x[:, -1:]
    return _logits(params, x, cfg=cfg), cache


def decode_step(params, tokens: torch.Tensor, cache: dict, cache_len, *,
                cfg: ModelConfig):
    """tokens [B,1] + cache + cache_len (scalar or [B]) -> (logits [B,1,V]
    f32, cache with position cache_len written in place)."""
    _require_dense(cfg)
    x = L.embed(params["embed"], tokens).to(cfg.activation_dtype)
    # one [B] lengths tensor on the activations' device for every layer
    lens = torch.as_tensor(cache_len, dtype=torch.int32, device=x.device)
    lens = lens.expand(x.shape[0]).contiguous()
    ks, vs = cache["self"]["k"], cache["self"]["v"]
    for i in range(cfg.num_layers):
        x = _decoder_layer_decode(_layer(params["layers"], i), x, ks[i], vs[i], lens,
                                  cfg=cfg)
    return _logits(params, x, cfg=cfg), cache
