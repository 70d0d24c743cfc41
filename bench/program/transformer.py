"""The `transformer` family as ``repro_torch`` takes it: its configuration
and the benchmark's weights (``reference/transformer.shapes``) as views in
the program's stacked layout.  The other settings of the program stay at
their defaults (``attn_impl="auto"`` runs the kernels on the card)."""
from __future__ import annotations

import torch

from bench.reference.transformer import Arch


def config(a: Arch):
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(
        name=a.name, family="moe" if a.is_moe else "dense",
        num_layers=a.layers, d_model=a.d, num_heads=a.heads,
        num_kv_heads=a.kv_heads, d_ff=a.d_ff, vocab_size=a.vocab,
        rope_theta=a.rope_theta, norm_eps=a.norm_eps, sliding_window=a.window,
        num_experts=a.experts, experts_per_token=a.top_k,
        capacity_factor=a.capacity_factor or 1.25, dtype=a.dtype)


def params(w: dict[str, torch.Tensor], a: Arch) -> dict:
    L, d, h, hk, hd = a.layers, a.d, a.heads, a.kv_heads, a.hd
    layers = {
        "attn": {"wq": w["wq"].view(L, d, h, hd), "wk": w["wk"].view(L, d, hk, hd),
                 "wv": w["wv"].view(L, d, hk, hd), "wo": w["wo"].view(L, h, hd, d)},
        "attn_norm": {"scale": w["attn_norm"]},
        "ffn_norm": {"scale": w["ffn_norm"]},
    }
    ffn = {"w_gate": w["w_gate"], "w_up": w["w_up"], "w_down": w["w_down"]}
    if a.is_moe:
        layers["moe"] = {"router": w["router"], **ffn}
    else:
        layers["ffn"] = ffn
    return {"embed": {"embedding": w["embedding"]}, "layers": layers,
            "final_norm": {"scale": w["final_norm"]}, "out": {"head": w["head"]}}
