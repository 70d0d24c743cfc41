"""Mixture-of-Experts FFN: top-k routing with per-row capacity grouping.

The reference's design, in torch:
  * tokens are grouped *per batch row*: each (token, choice) gets its
    position within its expert from a cumsum along the row,
  * dispatch and combine go through a dense [B, E, C, d] buffer, so the
    expert FFN is three batched products over E (plain products: the
    reference computes them outside any Pallas kernel),
  * choices past an expert's capacity fall into an overflow slot ``C``
    that is sliced away (standard capacity-factor semantics).

Top-k breaks ties to the lowest expert index, as ``jax.lax.top_k`` does
(``kernels.ref._topk_low_index``, a stable descending sort).  The casts are
the reference's: the router in f32, SiLU in f32 then back, the gates in the
activations' dtype.

Returns an aux dict with the load-balance and router-z losses (ST-MoE
style).  The reference's mesh branch (``moe_sharded.moe_ffn_sharded``,
taken under an active mesh) waits for the sharding rules (ROADMAP item 12).
:func:`route` is the router alone, which the tests hold to the
reference's routing.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.common import ParamSpec
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ref import _topk_low_index
from repro_torch.models.layers import einsum, einsum_f32


def moe_spec(cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        ("router",): ParamSpec((d, e), ("embed_in", "experts_in"), init="scaled",
                               dtype=torch.float32),
        ("w_gate",): ParamSpec((e, d, f), ("experts", "embed_in", "mlp_out"), init="scaled"),
        ("w_up",): ParamSpec((e, d, f), ("experts", "embed_in", "mlp_out"), init="scaled"),
        ("w_down",): ParamSpec((e, f, d), ("experts", "mlp", "embed_out"), init="scaled"),
    }


def capacity(cfg: ModelConfig, seq_len: int) -> int:
    c = math.ceil(seq_len * cfg.experts_per_token / cfg.num_experts * cfg.capacity_factor)
    return max(int(c), 4)


def route(params, x: torch.Tensor, *, cfg: ModelConfig):
    """The router: x [B, S, d] -> (logits [B,S,E] f32, probs [B,S,E],
    gates [B,S,k] f32, expert ids [B,S,k], slot [B,S,k], dropped [B,S,k])."""
    k = cfg.experts_per_token
    logits = einsum_f32("bsd,de->bse", x, params["router"])
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = _topk_low_index(probs, k)              # [B,S,k]
    if k > 1:  # renormalize selected gates (mixtral convention)
        gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    return (logits, probs, gate_vals, expert_idx) + assign_slots(expert_idx, cfg=cfg)


def assign_slots(expert_idx: torch.Tensor, *, cfg: ModelConfig):
    """Each choice's position within its expert along its batch row (choices
    in token order, a token's choices in rank order), or the overflow slot
    ``capacity`` where that is full: expert ids [B,S,k] -> (slot [B,S,k],
    dropped [B,S,k])."""
    b, s, k = expert_idx.shape
    cap = capacity(cfg, s)
    flat = F.one_hot(expert_idx, cfg.num_experts).reshape(b, s * k, cfg.num_experts)
    pos = ((flat.cumsum(dim=1) - 1) * flat).sum(dim=-1).reshape(b, s, k)
    dropped = pos >= cap
    return torch.where(dropped, cap, pos), dropped


def moe_ffn(params, x: torch.Tensor, *, cfg: ModelConfig):
    """x: [B, S, d] -> ([B, S, d], aux_losses dict).

    The reference's single-device ``_moe_ffn``: it dispatches through
    ``moe_sharded.py`` under an active mesh, and the port has no mesh yet
    (ROADMAP item 12)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = capacity(cfg, s)
    logits, probs, gate_vals, expert_idx, slot, dropped = route(params, x, cfg=cfg)

    # dispatch: buf[b, e, c, :] = x[b, s, :]; the dropped choices pile up
    # in the overflow slot, which is sliced away
    bidx = torch.arange(b, device=x.device)[:, None, None].expand(b, s, k)
    buf = torch.zeros((b, e, cap + 1, d), dtype=x.dtype, device=x.device)
    buf.index_put_((bidx, expert_idx, slot), x[:, :, None, :].expand(b, s, k, d),
                   accumulate=True)
    buf = buf[:, :, :cap]

    # the expert FFN: three batched products over E
    g = einsum("becd,edf->becf", buf, params["w_gate"])
    u = einsum("becd,edf->becf", buf, params["w_up"])
    h = F.silu(g.float()).to(x.dtype) * u
    out_buf = einsum("becf,efd->becd", h, params["w_down"])
    out_buf = torch.cat([out_buf, out_buf.new_zeros((b, e, 1, d))], dim=2)

    # combine: y[b, s] = sum_k gate * out_buf[b, e_k, slot_k]
    gathered = out_buf[bidx, expert_idx, slot]                    # [B,S,k,d]
    gates = torch.where(dropped, 0.0, gate_vals).to(x.dtype)
    y = einsum("bskd,bsk->bsd", gathered, gates)

    # aux losses
    frac_tokens = F.one_hot(expert_idx, e).float().mean(dim=(1, 2))   # [B,E]
    mean_probs = probs.mean(dim=1)                                     # [B,E]
    lb_loss = e * (frac_tokens * mean_probs).sum(dim=-1).mean()
    z_loss = torch.logsumexp(logits, dim=-1).square().mean()
    aux = {"moe_lb": lb_loss * cfg.router_aux_coef, "moe_z": z_loss * 1e-3}
    return y, aux
