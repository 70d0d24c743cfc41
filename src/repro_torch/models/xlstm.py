"""xLSTM blocks: mLSTM (matrix memory, chunked-parallel through the SSD
primitive) and sLSTM (scalar memory with exp gates and a stabilizer,
sequential).

Structure follows arXiv:2405.04517: pre-norm residual mixer blocks; every
``cfg.slstm_every``-th block is an sLSTM, the rest are mLSTM.  As in the
reference, the mLSTM input gate uses the sigmoid (log-domain -softplus)
parameterization rather than the unbounded exp gate, which removes the
running max-stabilizer state while keeping the matrix memory and its
normalizer; sLSTM keeps the exp gates and the ``m`` stabilizer.

One departure from the reference (ROADMAP §3): an mLSTM prefill shorter than
``ssm_conv - 1`` tokens keeps its conv history left-padded with zeros, as
Mamba2's does.  The reference drops it (``new_hist = None``), and its decode
step then starts the conv window from zeros.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common import ParamSpec
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import einsum
from repro_torch.models.ssm import ssd_chunked, ssd_decode_step

EXPAND = 2  # mLSTM internal up-projection factor
SLSTM_M0 = -30.0   # the sLSTM stabilizer's initial value


def _mlstm_dims(cfg: ModelConfig):
    d_in = EXPAND * cfg.d_model
    H = cfg.num_heads
    P = d_in // H       # value head dim
    N = P               # key/query head dim
    return d_in, H, P, N


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return -F.softplus(-x)


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------


def mlstm_spec(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    d_in, H, P, N = _mlstm_dims(cfg)
    cw = cfg.ssm_conv
    f32 = torch.float32
    return {
        ("in_proj",): ParamSpec((d, 2 * d_in), ("embed_in", "mlp"), init="scaled"),
        ("conv_w",): ParamSpec((cw, d_in), ("conv", "mlp"), init="scaled"),
        ("conv_b",): ParamSpec((d_in,), ("mlp",), init="zeros", dtype=f32),
        ("wq",): ParamSpec((d_in, H, N), ("mlp_in", "heads", "qkv"), init="scaled"),
        ("wk",): ParamSpec((d_in, H, N), ("mlp_in", "heads", "qkv"), init="scaled"),
        ("wv",): ParamSpec((d_in, H, P), ("mlp_in", "heads", "qkv"), init="scaled"),
        ("w_gates",): ParamSpec((d_in, 2 * H), ("mlp_in", "heads"), init="scaled", dtype=f32),
        ("b_gates",): ParamSpec((2 * H,), ("heads",), init="zeros", dtype=f32),
        ("norm_scale",): ParamSpec((d_in,), ("mlp",), init="ones", dtype=f32),
        ("out_proj",): ParamSpec((d_in, d), ("mlp", "embed_out"), init="scaled"),
    }


def _mlstm_qkv_gates(params, x, *, cfg: ModelConfig, conv_hist=None):
    """Common projection path. x: [b, L, d]. Returns (q,k,v,log_f,log_i,z,new_hist)."""
    b, L, d = x.shape
    d_in, H, P, N = _mlstm_dims(cfg)
    proj = einsum("bld,de->ble", x, params["in_proj"])
    x_in, z = torch.chunk(proj, 2, dim=-1)

    cw = cfg.ssm_conv
    if conv_hist is None:
        hist_full = F.pad(x_in, (0, 0, cw - 1, 0))
    else:
        hist_full = torch.cat([conv_hist.to(x_in.dtype), x_in], dim=1)
    # the last cw - 1 conv inputs, zeros first for a short prefill (the fix)
    new_hist = hist_full[:, hist_full.shape[1] - (cw - 1):]
    conv = sum(hist_full[:, i:i + L] * params["conv_w"][i].to(x.dtype) for i in range(cw))
    conv = F.silu((conv + params["conv_b"].to(x.dtype)).float()).to(x.dtype)

    # the scale 1/sqrt(N) is rounded in the activations' dtype, as the reference's
    scale = float(1.0 / torch.sqrt(torch.tensor(float(N))).to(x.dtype))
    q = einsum("ble,ehn->blhn", conv, params["wq"]) * scale
    k = einsum("ble,ehn->blhn", conv, params["wk"])
    v = einsum("ble,ehp->blhp", x_in, params["wv"])
    gates = torch.einsum("ble,eh->blh", x_in.float(), params["w_gates"]) + params["b_gates"]
    f_pre, i_pre = torch.chunk(gates, 2, dim=-1)   # [b,L,H]
    return q, k, v, _log_sigmoid(f_pre), _log_sigmoid(i_pre), z, new_hist


def _mlstm_out(params, y, z, x, *, cfg: ModelConfig):
    """RMSNorm of the heads' outputs (f32 statistics), the z gate, out_proj."""
    b, L = y.shape[:2]
    yf = y.reshape(b, L, -1).float()
    var = yf.square().mean(dim=-1, keepdim=True)
    y = (yf * torch.rsqrt(var + cfg.norm_eps) * params["norm_scale"]).to(x.dtype)
    y = y * F.silu(z.float()).to(x.dtype)
    return einsum("ble,ed->bld", y, params["out_proj"])


def mlstm_forward(params, x, *, cfg: ModelConfig, state=None, return_state: bool = False):
    """Full-sequence mLSTM mixer. state: optional dict(C, n, conv)."""
    conv_hist = state["conv"] if state is not None else None
    q, k, v, log_f, log_i, z, new_hist = _mlstm_qkv_gates(params, x, cfg=cfg,
                                                          conv_hist=conv_hist)

    # fold the input gate into k so that the normalizer recurrence sees it too
    k_i = (k.float() * torch.exp(log_i)[..., None]).to(v.dtype)
    h0 = state["C"] if state is not None else None
    n0 = state["n"][..., None, :] if state is not None else None   # [b,H,1,N]
    y, C_f = ssd_chunked(v, log_f, k_i, q, chunk=cfg.ssm_chunk, h0=h0)
    ones = torch.ones(v.shape[:3] + (1,), dtype=v.dtype, device=v.device)
    nqt, n_f = ssd_chunked(ones, log_f, k_i, q, chunk=cfg.ssm_chunk, h0=n0)
    y = (y.float() / torch.clamp(nqt.float().abs(), min=1.0)).to(x.dtype)
    out = _mlstm_out(params, y, z, x, cfg=cfg)
    if return_state:
        return out, {"C": C_f, "n": n_f[:, :, 0, :], "conv": new_hist}
    return out


def mlstm_state_specs(cfg: ModelConfig, batch: int) -> dict:
    d_in, H, P, N = _mlstm_dims(cfg)
    f32 = torch.float32
    return {
        ("C",): ParamSpec((batch, H, P, N), ("batch", "heads", None, None), dtype=f32,
                          init="zeros"),
        ("n",): ParamSpec((batch, H, N), ("batch", "heads", None), dtype=f32, init="zeros"),
        ("conv",): ParamSpec((batch, cfg.ssm_conv - 1, d_in), ("batch", None, "mlp"),
                             dtype=cfg.activation_dtype, init="zeros"),
    }


def mlstm_decode(params, state, x, *, cfg: ModelConfig):
    """Single-token mLSTM step. x: [b, 1, d]."""
    b = x.shape[0]
    d_in, H, P, N = _mlstm_dims(cfg)
    q, k, v, log_f, log_i, z, new_hist = _mlstm_qkv_gates(params, x, cfg=cfg,
                                                          conv_hist=state["conv"])
    k_i = (k.float() * torch.exp(log_i)[..., None])[:, 0]
    q0 = q[:, 0].float()
    C, y = ssd_decode_step(state["C"], v[:, 0], log_f[:, 0], k_i, q0)
    ones = torch.ones((b, H, 1), dtype=torch.float32, device=x.device)
    n, nqt = ssd_decode_step(state["n"][..., None, :], ones, log_f[:, 0], k_i, q0)
    y = y.float() / torch.clamp(nqt.float().abs(), min=1.0)
    return {"C": C, "n": n[:, :, 0, :], "conv": new_hist}, \
        _mlstm_out(params, y[:, None], z, x, cfg=cfg)


# ---------------------------------------------------------------------------
# sLSTM block (sequential; exp gates + stabilizer, block-diagonal recurrence)
# ---------------------------------------------------------------------------


def slstm_spec(cfg: ModelConfig) -> dict:
    d, H = cfg.d_model, cfg.num_heads
    dh = d // H
    return {
        ("w_in",): ParamSpec((d, 4 * d), ("embed_in", "mlp"), init="scaled"),
        ("r",): ParamSpec((H, dh, 4 * dh), ("heads", None, None), init="scaled"),
        ("b",): ParamSpec((4 * d,), ("mlp",), init="zeros", dtype=torch.float32),
        ("out_proj",): ParamSpec((d, d), ("embed_in", "embed_out"), init="scaled"),
    }


def _slstm_in(params, x):
    """The input half of the gates' pre-activations, f32: x [..., d] -> [..., 4d]."""
    return x.float() @ params["w_in"].float()


def _slstm_step(params, carry, pre_in, *, cfg: ModelConfig):
    """One sLSTM step. carry: (h, c, n, m) each [b, d] f32; pre_in: the
    step's input pre-activations [b, 4d] (:func:`_slstm_in`)."""
    h, c, n, m = carry
    b, d = h.shape
    H = cfg.num_heads
    rec = torch.einsum("bhx,hxe->bhe", h.reshape(b, H, d // H), params["r"].float())
    pre = pre_in + rec.reshape(b, 4 * d) + params["b"]
    i_pre, f_pre, z_pre, o_pre = torch.chunk(pre, 4, dim=-1)
    log_f = _log_sigmoid(f_pre)                   # sigmoid forget (stable branch)
    m_new = torch.maximum(log_f + m, i_pre)       # stabilizer
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(log_f + m - m_new)
    c_new = f_g * c + i_g * torch.tanh(z_pre)
    n_new = f_g * n + i_g
    h_new = torch.sigmoid(o_pre) * c_new / torch.clamp(n_new, min=1.0)
    return h_new, c_new, n_new, m_new


def slstm_forward(params, x, *, cfg: ModelConfig, state=None, return_state: bool = False):
    b, L, d = x.shape
    if state is None:
        z = torch.zeros((b, d), dtype=torch.float32, device=x.device)
        carry = (z, z, z, z + SLSTM_M0)
    else:
        carry = (state["h"], state["c"], state["n"], state["m"])
    pre = _slstm_in(params, x)   # [b, L, 4d], all steps at once
    hs = []
    for t in range(L):
        carry = _slstm_step(params, carry, pre[:, t], cfg=cfg)
        hs.append(carry[0])
    y = torch.stack(hs, dim=1).to(x.dtype)
    out = einsum("bld,de->ble", y, params["out_proj"])
    if return_state:
        h, c, n, m = carry
        return out, {"h": h, "c": c, "n": n, "m": m}
    return out


def slstm_state_specs(cfg: ModelConfig, batch: int) -> dict:
    return {(k,): ParamSpec((batch, cfg.d_model), ("batch", "embed"), dtype=torch.float32,
                            init="zeros")
            for k in ("h", "c", "n", "m")}


def slstm_decode(params, state, x, *, cfg: ModelConfig):
    carry = (state["h"], state["c"], state["n"], state["m"])
    h, c, n, m = _slstm_step(params, carry, _slstm_in(params, x[:, 0]), cfg=cfg)
    out = einsum("bld,de->ble", h[:, None, :].to(x.dtype), params["out_proj"])
    return {"h": h, "c": c, "n": n, "m": m}, out
