"""The cost arithmetic of the `transformer` family: the operations and bytes
that the inputs need, from the configuration and the token counts alone,
whatever the program executes.

A multiply-add is 2 FLOPs.  Attention counts the unmasked (query, key)
pairs of each head, 4 hd FLOPs a pair (QK^T and PV).  An expert layer
counts the router and the top-k experts of each token (no capacity slots,
no padding).  The LM head counts only the positions whose logits a request
needs: the last prompt token of a scored row, each generated token.
The attention kernels' bounds count each input byte read once and each
output byte written once (the frozen arithmetic of the program's
``kernels/flash_attention.cost`` and ``kernels/decode_attention.cost``).
"""
from __future__ import annotations

from bench.reference.transformer import Arch

ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def pairs(sq: int, sk: int, *, causal: bool = True, window: int = 0, offset: int = 0) -> int:
    """Unmasked (q, k) pairs of one head: query i sits at position
    ``offset + i`` over keys 0..sk-1; causal keeps k <= q, a window keeps
    q - k < window."""
    total = 0
    for i in range(sq):
        p = offset + i
        hi = min(p, sk - 1) if causal else sk - 1
        lo = max(p - window + 1, 0) if window else 0
        total += max(hi - lo + 1, 0)
    return total


def causal_pairs(t: int, window: int = 0) -> int:
    """``pairs(t, t)`` in closed form (causal, query i sees min(i + 1, window) keys)."""
    if not window or window >= t:
        return t * (t + 1) // 2
    return window * (window + 1) // 2 + (t - window) * window


def layer_matmul_flops_per_token(a: Arch) -> int:
    """The products of one decoder layer for one token (no attention scores)."""
    proj = 2 * a.d * (a.heads + 2 * a.kv_heads) * a.hd + 2 * a.heads * a.hd * a.d
    if a.is_moe:
        ffn = 2 * a.d * a.experts + a.top_k * 6 * a.d * a.d_ff
    else:
        ffn = 6 * a.d * a.d_ff
    return proj + ffn


def head_flops(a: Arch) -> int:
    return 2 * a.d * a.vocab


def prompt_flops(a: Arch, t: int) -> int:
    """One sequence of ``t`` real tokens through every layer, causal
    attention over its true length, the head at its last token."""
    attn = 4 * a.heads * a.hd * causal_pairs(t, a.window)
    return a.layers * (t * layer_matmul_flops_per_token(a) + attn) + head_flops(a)


def decode_token_flops(a: Arch, context: int) -> int:
    """One generated token whose query sits at position ``context`` (it
    attends positions 0..context), through every layer and the head."""
    keys = min(context + 1, a.window) if a.window else context + 1
    return a.layers * (layer_matmul_flops_per_token(a) + 4 * a.heads * a.hd * keys) \
        + head_flops(a)


def flash_attention_bound(a: Arch, t: int) -> tuple[int, int]:
    """(FLOPs, bytes) of causal self-attention over one sequence of ``t``
    real tokens in one layer: q, k, v read once, the output written once."""
    it = ITEMSIZE[a.dtype]
    flops = 4 * a.heads * a.hd * causal_pairs(t, a.window)
    nbytes = it * 2 * (t * a.heads * a.hd + t * a.kv_heads * a.hd)
    return flops, nbytes


def decode_attention_bound(a: Arch, context: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one row's decode attention in one layer, its query
    at position ``context``: the K and V rows it attends read once, q read
    and the output written once, its length read."""
    it = ITEMSIZE[a.dtype]
    rows = min(context + 1, a.window) if a.window else context + 1
    flops = 4 * rows * a.heads * a.hd
    nbytes = rows * a.kv_heads * a.hd * 2 * it + 2 * a.heads * a.hd * it + 4
    return flops, nbytes
