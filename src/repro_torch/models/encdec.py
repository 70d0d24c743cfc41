"""Whisper-style encoder-decoder (arXiv:2212.04356).

The conv/mel frontend is a stub, as in the reference: a request brings
precomputed frame embeddings ``extra["audio_frames"]`` [B, T_frames, d].
Encoder = bidirectional pre-LN transformer with sinusoidal positions (f32);
decoder = causal pre-LN transformer with learned positions, cross-attending
to the encoder output.  Embeddings are tied to the LM head (whisper
convention).

The cache is ``{"self", "cross"}`` of [L, B, S, Hk, hd]: the decoder's own
K/V over ``max_seq`` positions, and each decoder layer's K/V of the encoder
output (``num_audio_frames`` positions, no biases), computed once by the
prefill.  ``prefill`` and ``decode_step`` write it in place and return the
same dict.
"""
from __future__ import annotations

import torch

from repro_torch.common import ParamSpec, SpecTree
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import shard_activation
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.transformer import _layer, _maybe_remat, _stack


def _enc_layer_specs(cfg: ModelConfig) -> dict:
    specs: dict = {}
    specs.update({("attn",) + p: s for p, s in attn.attention_spec(cfg).items()})
    specs.update({("attn_norm",) + p: s for p, s in L.layernorm_spec(cfg.d_model).items()})
    specs.update({("ffn_norm",) + p: s for p, s in L.layernorm_spec(cfg.d_model).items()})
    specs.update({("ffn",) + p: s for p, s in L.gelu_ffn_spec(cfg.d_model, cfg.d_ff).items()})
    return specs


def _dec_layer_specs(cfg: ModelConfig) -> dict:
    specs = _enc_layer_specs(cfg)
    specs.update({("xattn",) + p: s for p, s in attn.attention_spec(cfg, cross=True).items()})
    specs.update({("xattn_norm",) + p: s for p, s in L.layernorm_spec(cfg.d_model).items()})
    return specs


def param_specs(cfg: ModelConfig) -> SpecTree:
    specs: SpecTree = {}
    specs.update({("embed",) + p: s for p, s in L.embed_spec(cfg.vocab_size, cfg.d_model).items()})
    specs[("pos_embed",)] = ParamSpec((cfg.max_position, cfg.d_model), ("seq", "embed"),
                                      init="normal")
    specs.update(_stack(_enc_layer_specs(cfg), cfg.encoder_layers, "enc_layers"))
    specs.update(_stack(_dec_layer_specs(cfg), cfg.num_layers, "dec_layers"))
    specs.update({("enc_norm",) + p: s for p, s in L.layernorm_spec(cfg.d_model).items()})
    specs.update({("final_norm",) + p: s for p, s in L.layernorm_spec(cfg.d_model).items()})
    return specs  # tied embeddings: no separate head


def _sinusoidal(t: int, d: int, device=None) -> torch.Tensor:
    f32 = torch.float32
    pos = torch.arange(t, dtype=f32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=f32, device=device)[None, :]
    ang = pos / torch.pow(10_000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _frames(cfg: ModelConfig, extra) -> torch.Tensor:
    if not extra or "audio_frames" not in extra:
        raise ValueError(f"{cfg.name} (audio) needs extra['audio_frames'] [B, "
                         f"{cfg.num_audio_frames}, {cfg.d_model}]")
    return extra["audio_frames"]


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def _enc_layer(lp, x, *, cfg: ModelConfig):
    x = shard_activation(x, ("batch", None, None))
    h = L.layernorm(lp["attn_norm"], x, cfg.norm_eps)
    a, _ = attn.self_attention(lp["attn"], h, cfg=cfg, causal=False)
    x = x + a
    h = L.layernorm(lp["ffn_norm"], x, cfg.norm_eps)
    return x + L.gelu_ffn(lp["ffn"], h)


def encode(params, frames, *, cfg: ModelConfig, remat: bool = False):
    """frames: [B, T, d] (stub frontend output) -> [B, T, d], in the frames'
    dtype, as the reference's."""
    x = frames + _sinusoidal(frames.shape[1], cfg.d_model, frames.device).to(frames.dtype)
    layer = _maybe_remat(_enc_layer, cfg, remat)
    for i in range(cfg.encoder_layers):
        x = layer(_layer(params["enc_layers"], i), x, cfg=cfg)
    return L.layernorm(params["enc_norm"], x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def _dec_layer_seq(lp, x, enc_out, *, cfg: ModelConfig):
    x = shard_activation(x, ("batch", "seq_act", None))
    h = L.layernorm(lp["attn_norm"], x, cfg.norm_eps)
    a, kv = attn.self_attention(lp["attn"], h, cfg=cfg, causal=True)
    x = x + a
    h = L.layernorm(lp["xattn_norm"], x, cfg.norm_eps)
    x = x + attn.cross_attention(lp["xattn"], h, enc_out, cfg=cfg)
    h = L.layernorm(lp["ffn_norm"], x, cfg.norm_eps)
    return x + L.gelu_ffn(lp["ffn"], h), kv


def _decode_logits(params, x, cfg):
    x = L.layernorm(params["final_norm"], x, cfg.norm_eps)
    return L.unembed(params["embed"], x, tied=True)


def _run_decoder_seq(params, tokens, enc_out, *, cfg: ModelConfig, cache=None,
                     remat: bool = False):
    """The decoder over a whole sequence; with ``cache``, each layer's K/V is
    written at the head of its [B, Smax] rows and its cross K/V whole."""
    s = tokens.shape[1]
    x = L.embed(params["embed"], tokens).to(cfg.activation_dtype)
    x = x + params["pos_embed"][:s].to(x.dtype)
    layer = _maybe_remat(_dec_layer_seq, cfg, remat)
    for i in range(cfg.num_layers):
        lp = _layer(params["dec_layers"], i)
        x, (k, v) = layer(lp, x, enc_out, cfg=cfg)
        if cache is not None:
            cache["self"]["k"][i, :, :s] = k
            cache["self"]["v"][i, :, :s] = v
            cache["cross"]["k"][i] = L.einsum("bsd,dhk->bshk", enc_out, lp["xattn"]["wk"])
            cache["cross"]["v"][i] = L.einsum("bsd,dhk->bshk", enc_out, lp["xattn"]["wv"])
    return x


def forward(params, tokens, *, cfg: ModelConfig, extra=None, remat: bool = False):
    """Teacher-forced decoder pass. tokens [B,S]; extra['audio_frames'] [B,T,d]."""
    enc_out = encode(params, _frames(cfg, extra), cfg=cfg, remat=remat)
    x = _run_decoder_seq(params, tokens, enc_out, cfg=cfg, remat=remat)
    return _decode_logits(params, x, cfg), {}


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> SpecTree:
    hk, hd, n = cfg.num_kv_heads, cfg.hd, cfg.num_layers
    dt = cfg.activation_dtype
    kv_axes = ("layers", "batch", "kv_seq", "kv_heads", "qkv")
    x_axes = ("layers", "batch", "frames", "kv_heads", "qkv")
    return {
        ("self", "k"): ParamSpec((n, batch, max_seq, hk, hd), kv_axes, dtype=dt, init="zeros"),
        ("self", "v"): ParamSpec((n, batch, max_seq, hk, hd), kv_axes, dtype=dt, init="zeros"),
        ("cross", "k"): ParamSpec((n, batch, cfg.num_audio_frames, hk, hd), x_axes, dtype=dt,
                                  init="zeros"),
        ("cross", "v"): ParamSpec((n, batch, cfg.num_audio_frames, hk, hd), x_axes, dtype=dt,
                                  init="zeros"),
    }


def prefill(params, tokens, cache, *, cfg: ModelConfig, extra=None, last_only=False):
    """tokens [B,S] + cache -> (logits, cache with positions 0..S-1 and the
    cross K/V written in place)."""
    enc_out = encode(params, _frames(cfg, extra), cfg=cfg)
    x = _run_decoder_seq(params, tokens, enc_out, cfg=cfg, cache=cache)
    if last_only:
        x = x[:, -1:]
    return _decode_logits(params, x, cfg), cache


def decode_step(params, tokens, cache, cache_len, *, cfg: ModelConfig, extra=None):
    """tokens [B,1] + cache + cache_len (scalar or [B]) -> (logits [B,1,V],
    cache with position cache_len written in place).  ``extra`` is unused:
    the cross K/V come from the cache.  Row b reads position ``cache_len[b]``
    of the learned table."""
    x = L.embed(params["embed"], tokens).to(cfg.activation_dtype)
    lens = torch.as_tensor(cache_len, dtype=torch.int32, device=x.device)
    lens = lens.expand(x.shape[0]).contiguous()
    x = x + params["pos_embed"][lens.long()][:, None].to(x.dtype)
    for i in range(cfg.num_layers):
        lp = _layer(params["dec_layers"], i)
        h = L.layernorm(lp["attn_norm"], x, cfg.norm_eps)
        a, _, _ = attn.decode_self_attention(
            lp["attn"], h, attn.cache_layer(cache["self"]["k"], i),
            attn.cache_layer(cache["self"]["v"], i), lens, cfg=cfg)
        x = x + a
        h = L.layernorm(lp["xattn_norm"], x, cfg.norm_eps)
        x = x + attn.decode_cross_attention(lp["xattn"], h, cache["cross"]["k"][i],
                                            cache["cross"]["v"][i], cfg=cfg)
        h = L.layernorm(lp["ffn_norm"], x, cfg.norm_eps)
        x = x + L.gelu_ffn(lp["ffn"], h)
    return _decode_logits(params, x, cfg), cache
