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
style).  Under activation rules whose mesh has a ``model`` axis the layer
goes through ``moe_sharded.moe_ffn_sharded``, as the reference's does.
:func:`route` is the router alone, which the tests hold to the
reference's routing; :func:`dispatch_combine` and :func:`aux_losses` are
the parts the sharded layer shares.
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

    The reference's single-device ``_moe_ffn``, or under activation rules
    whose mesh has a ``model`` axis its shard-local ``moe_ffn_sharded``."""
    from repro_torch.dist import sharding as shd
    ctx = shd.model_rules()
    if ctx is not None:
        from repro_torch.models.moe_sharded import moe_ffn_sharded
        return moe_ffn_sharded(params, x, cfg=cfg, mesh=ctx[0])
    logits, probs, gate_vals, expert_idx, slot, dropped = route(params, x, cfg=cfg)
    y = dispatch_combine(x, expert_idx, slot, gate_vals, dropped, params["w_gate"],
                         params["w_up"], params["w_down"], cap=capacity(cfg, x.shape[1]))
    lb_loss, z_loss = aux_losses(logits, probs, expert_idx, cfg=cfg)
    return y, {"moe_lb": lb_loss * cfg.router_aux_coef, "moe_z": z_loss * 1e-3}


def dispatch_combine(x, expert_idx, slot, gate_vals, dropped, w_gate, w_up, w_down, *,
                     cap: int):
    """The expert FFN over a dense [B, E, C, d] buffer of the experts in
    ``w_*`` (``expert_idx`` indexes them; a dropped choice sits in slot
    ``cap``): y[b, s] = sum_k gate * FFN_{e_k}(x[b, s])."""
    b, s, d = x.shape
    k, e = expert_idx.shape[-1], w_gate.shape[0]
    # dispatch: buf[b, e, c, :] = x[b, s, :]; the dropped choices pile up
    # in the overflow slot, which is sliced away
    bidx = torch.arange(b, device=x.device)[:, None, None].expand(b, s, k)
    buf = torch.zeros((b, e, cap + 1, d), dtype=x.dtype, device=x.device)
    buf.index_put_((bidx, expert_idx, slot), x[:, :, None, :].expand(b, s, k, d),
                   accumulate=True)
    buf = buf[:, :, :cap]

    # the expert FFN: three batched products over E
    g = einsum("becd,edf->becf", buf, w_gate)
    u = einsum("becd,edf->becf", buf, w_up)
    h = F.silu(g.float()).to(x.dtype) * u
    out_buf = einsum("becf,efd->becd", h, w_down)
    out_buf = torch.cat([out_buf, out_buf.new_zeros((b, e, 1, d))], dim=2)

    # combine: y[b, s] = sum_k gate * out_buf[b, e_k, slot_k]
    gathered = out_buf[bidx, expert_idx, slot]                    # [B,S,k,d]
    gates = torch.where(dropped, 0.0, gate_vals).to(x.dtype)
    return einsum("bskd,bsk->bsd", gathered, gates)


def aux_losses(logits, probs, expert_idx, *, cfg: ModelConfig):
    """(load-balance loss, router-z loss) over these rows, unscaled."""
    e = cfg.num_experts
    frac_tokens = F.one_hot(expert_idx, e).float().mean(dim=(1, 2))   # [B,E]
    mean_probs = probs.mean(dim=1)                                     # [B,E]
    lb_loss = e * (frac_tokens * mean_probs).sum(dim=-1).mean()
    z_loss = torch.logsumexp(logits, dim=-1).square().mean()
    return lb_loss, z_loss
