"""Decoder-only transformer LM, dense layout.

Parameters are stacked over layers, as in the reference (whose
``jax.lax.scan`` keeps its compile time O(1) in depth), so that a JAX param
tree maps one to one onto the port's through ``common.params_from_numpy``;
here a Python loop walks the layer index.  The reference's
``shard_activation`` is the identity without a mesh and is dropped until the
sharding rules are ported (ROADMAP item 12).

``forward`` (full sequence -> logits) is the scoring entry.  The MoE and VLM
layouts raise (ROADMAP item 10); ``cache_specs``, ``prefill`` and
``decode_step`` arrive with the generate path (slice 2b).
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


def _run_layers_seq(params, x, *, cfg: ModelConfig):
    _require_dense(cfg)
    for i in range(cfg.num_layers):
        x, _ = _decoder_layer_seq(_layer(params["layers"], i), x, cfg=cfg)
    return x


def forward(params, tokens: torch.Tensor, *, cfg: ModelConfig):
    """tokens [B,S] -> (logits [B,S,V] f32, aux dict)."""
    x = L.embed(params["embed"], tokens).to(cfg.activation_dtype)
    x = _run_layers_seq(params, x, cfg=cfg)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed({**params.get("out", {}), **params["embed"]}, x,
                       tied=cfg.tie_embeddings)
    return logits, {}
