"""Shared neural-net building blocks (plain functions over param dicts).

The reference's jnp promotes ``f32 x bf16 -> f32`` inside an einsum; torch
raises on mixed dtypes, so :func:`einsum` casts its operands to their
promoted dtype first (parameters are stored in bf16 whatever ``cfg.dtype``
is, and bf16 -> f32 is exact).  :func:`einsum_f32` is the reference's
``preferred_element_type=f32``: bf16 products are exact in f32, summed in
f32.  LayerNorm and the GELU FFN serve the encoder-decoder family
(whisper); their statistics and activations are f32, as the reference's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common import ParamSpec
from repro_torch.kernels.ref import rmsnorm_ref


def einsum(eq: str, *xs: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` in the operands' promoted dtype (jnp's rule)."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return torch.einsum(eq, *(x.to(dt) for x in xs))


def einsum_f32(eq: str, *xs: torch.Tensor) -> torch.Tensor:
    """``einsum(..., preferred_element_type=f32)``: the product in f32."""
    return torch.einsum(eq, *(x.float() for x in xs))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_spec(d: int) -> dict:
    return {("scale",): ParamSpec((d,), ("embed",), init="ones", dtype=torch.float32)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return rmsnorm_ref(x, params["scale"], eps=eps)


def layernorm_spec(d: int) -> dict:
    return {
        ("scale",): ParamSpec((d,), ("embed",), init="ones", dtype=torch.float32),
        ("bias",): ParamSpec((d,), ("embed",), init="zeros", dtype=torch.float32),
    }


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * params["scale"] + params["bias"]).to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (half-split form)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: broadcastable to [..., seq]."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                          # [hd/2]
    angles = positions[..., :, None].float() * freqs                 # [..., seq, hd/2]
    cos = torch.cos(angles)[..., :, None, :]                         # [..., seq, 1, hd/2]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# FFN (SwiGLU for the llama family, GELU for whisper)
# ---------------------------------------------------------------------------


def swiglu_spec(d: int, d_ff: int) -> dict:
    return {
        ("w_gate",): ParamSpec((d, d_ff), ("embed_in", "mlp_out"), init="scaled"),
        ("w_up",): ParamSpec((d, d_ff), ("embed_in", "mlp_out"), init="scaled"),
        ("w_down",): ParamSpec((d_ff, d), ("mlp", "embed_out"), init="scaled"),
    }


def swiglu(params, x: torch.Tensor) -> torch.Tensor:
    g = einsum("bsd,df->bsf", x, params["w_gate"])
    u = einsum("bsd,df->bsf", x, params["w_up"])
    h = F.silu(g.float()).to(x.dtype) * u
    return einsum("bsf,fd->bsd", h, params["w_down"])


def gelu_ffn_spec(d: int, d_ff: int) -> dict:
    return {
        ("w_in",): ParamSpec((d, d_ff), ("embed_in", "mlp_out"), init="scaled"),
        ("b_in",): ParamSpec((d_ff,), ("mlp",), init="zeros", dtype=torch.float32),
        ("w_out",): ParamSpec((d_ff, d), ("mlp", "embed_out"), init="scaled"),
        ("b_out",): ParamSpec((d,), ("embed",), init="zeros", dtype=torch.float32),
    }


def gelu_ffn(params, x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default is the tanh approximation."""
    h = einsum("bsd,df->bsf", x, params["w_in"]) + params["b_in"].to(x.dtype)
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return einsum("bsf,fd->bsd", h, params["w_out"]) + params["b_out"].to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_spec(vocab: int, d: int) -> dict:
    return {("embedding",): ParamSpec((vocab, d), ("vocab", "embed"), init="normal")}


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embedding"][tokens]


def unembed(params, x: torch.Tensor, *, tied: bool) -> torch.Tensor:
    if tied:
        return einsum_f32("bsd,vd->bsv", x, params["embedding"])
    return einsum_f32("bsd,dv->bsv", x, params["head"])


def unembed_spec(vocab: int, d: int, *, tied: bool) -> dict:
    if tied:
        return {}
    return {("head",): ParamSpec((d, vocab), ("embed_in", "vocab"), init="scaled")}
