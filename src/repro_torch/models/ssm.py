"""Mamba2-style state-space layer (SSD) with a chunked parallel scan.

The core primitive ``ssd_chunked`` implements the scalar-decay SSD recurrence

    h_t = a_t * h_{t-1} + B_t (x_t)^T        (state [H, P, N], a_t scalar/head)
    y_t = C_t^T h_t

as (intra-chunk quadratic attention-like pass) + (inter-chunk state pass).
The reference's ``jax.lax.scan`` over chunks is a Python loop here, with the
running state as an f32 carry, so the [H, Q, Q] decay matrices exist for one
chunk at a time.  A length off the chunk is padded with identity steps
(a = 1, zero input), which pass the state through unchanged: a prefill at a
prompt's true length ends in the state after its last token.  The same
primitive powers the xLSTM mLSTM block (``models/xlstm.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common import ParamSpec
from repro_torch.common.scopes import scoped
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import einsum


# ---------------------------------------------------------------------------
# Core SSD primitive
# ---------------------------------------------------------------------------


def _pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    """Zeros after the sequence axis (1) of ``t``."""
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))


def _heads(t: torch.Tensor, heads: int, axis: int) -> torch.Tensor:
    """Group axis -> heads: head h reads group h // (H/G)."""
    g = t.shape[axis]
    return t if g == heads else t.repeat_interleave(heads // g, dim=axis)


@scoped("ssd_core")
def ssd_chunked(x, log_a, B, C, *, chunk: int, h0=None, normalize: bool = False):
    """Chunked scalar-decay SSD.

    x:     [b, L, H, P]   (inputs, already gated/scaled by dt etc.)
    log_a: [b, L, H]      (log decay per head, <= 0)
    B, C:  [b, L, G, N]   (input/output projections, G groups broadcast to H)
    h0:    optional initial state [b, H, P, N]

    Returns (y [b, L, H, P], h_final [b, H, P, N] f32).
    If ``normalize``, y is divided by the matching scalar recurrence of a
    normalizer n_t = a_t n_{t-1} + B_t (mLSTM denominator).
    """
    b, L, H, P = x.shape
    N = B.shape[3]
    Q = min(chunk, L)
    if L % Q:  # pad with identity steps (a=1, zero input): the state passes through
        pad = Q - L % Q
        y, h = ssd_chunked(_pad_seq(x, pad), _pad_seq(log_a, pad), _pad_seq(B, pad),
                           _pad_seq(C, pad), chunk=Q, h0=h0, normalize=normalize)
        return y[:, :L], h
    f32 = torch.float32
    h = torch.zeros((b, H, P, N), dtype=f32, device=x.device) if h0 is None else h0
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    ys = []
    for start in range(0, L, Q):
        xq = x[:, start:start + Q].float()                        # [b,Q,H,P]
        cum = torch.cumsum(log_a[:, start:start + Q].float(), dim=1)   # [b,Q,H]
        Bh = _heads(B[:, start:start + Q], H, 2).float()           # [b,Q,H,N]
        Ch = _heads(C[:, start:start + Q], H, 2).float()

        # intra-chunk: scores[t,s] = C_t . B_s * exp(cum_t - cum_s), s <= t; the
        # decay overflows above the diagonal, which `where` discards (a 0/1
        # product would make inf * 0 = NaN there)
        scores = torch.einsum("bqhn,bshn->bhqs", Ch, Bh)
        cum_h = cum.transpose(1, 2)                                # [b,H,Q]
        decay = torch.exp(cum_h[:, :, :, None] - cum_h[:, :, None, :])   # [b,H,Q,Q]
        w = torch.where(mask, scores * decay, 0.0)
        y_intra = torch.einsum("bhqs,bshp->bqhp", w, xq)

        # inter-chunk contribution from the carried state
        y_inter = torch.einsum("bqhn,bhpn->bqhp", Ch * torch.exp(cum)[..., None], h)

        # the chunk's state
        out_decay = torch.exp(cum[:, -1:, :] - cum)               # decay from s to the end
        S = torch.einsum("bqhn,bqhp->bhpn", Bh * out_decay[..., None], xq)
        h = torch.exp(cum[:, -1, :])[:, :, None, None] * h + S
        ys.append((y_intra + y_inter).to(x.dtype))
    y = torch.cat(ys, dim=1)

    if normalize:
        n, _ = ssd_chunked(torch.ones_like(x[..., :1]), log_a, B, C, chunk=chunk)
        y = (y.float() / torch.clamp(n.float().abs(), min=1.0)).to(x.dtype)
    return y, h.float()


def ssd_decode_step(h, x, log_a, B, C):
    """Single-token SSD update. h:[b,H,P,N] x:[b,H,P] log_a:[b,H] B,C:[b,G,N]."""
    H = x.shape[1]
    Bh = _heads(B, H, 1).float()   # [b,H,N]
    Ch = _heads(C, H, 1).float()
    a = torch.exp(log_a.float())[:, :, None, None]
    h = a * h + torch.einsum("bhn,bhp->bhpn", Bh, x.float())
    y = torch.einsum("bhn,bhpn->bhp", Ch, h)
    return h, y.to(x.dtype)


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------


def mamba2_spec(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    H = d_in // 64  # head size P=64, mamba2 default
    N, G, cw = cfg.ssm_state, cfg.ssm_groups, cfg.ssm_conv
    conv_dim = d_in + 2 * G * N
    f32 = torch.float32
    return {
        ("in_proj",): ParamSpec((d, 2 * d_in + 2 * G * N + H), ("embed_in", "ssm_in"),
                                init="scaled"),
        ("conv_w",): ParamSpec((cw, conv_dim), ("conv", "ssm_in"), init="scaled"),
        ("conv_b",): ParamSpec((conv_dim,), ("ssm_in",), init="zeros", dtype=f32),
        ("A_log",): ParamSpec((H,), ("heads",), init="zeros", dtype=f32),
        ("dt_bias",): ParamSpec((H,), ("heads",), init="zeros", dtype=f32),
        ("D",): ParamSpec((H,), ("heads",), init="ones", dtype=f32),
        ("norm_scale",): ParamSpec((d_in,), ("ssm_inner",), init="ones", dtype=f32),
        ("out_proj",): ParamSpec((d_in, d), ("ssm_inner", "embed_out"), init="scaled"),
    }


def _mamba2_dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    H = d_in // 64
    return d_in, H, 64, cfg.ssm_state, cfg.ssm_groups


def _split_in_proj(cfg, proj):
    d_in, H, P, N, G = _mamba2_dims(cfg)
    return torch.split(proj, [d_in, d_in + 2 * G * N, H], dim=-1)   # z, xbc, dt


def _gated_norm(scale, y, z, eps):
    """Mamba2's RMSNorm(y * silu(z))."""
    y = y * F.silu(z.float()).to(y.dtype)
    yf = y.float()
    var = yf.square().mean(dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * scale).to(y.dtype)


def mamba2_forward(params, x, *, cfg: ModelConfig, state=None, return_state: bool = False):
    """Full-sequence Mamba2 mixer. x: [b, L, d] -> [b, L, d] (+ optional state).
    The depthwise conv runs in the activations' dtype, as the reference's."""
    b, L, d = x.shape
    d_in, H, P, N, G = _mamba2_dims(cfg)
    proj = einsum("bld,de->ble", x, params["in_proj"])
    z, xbc, dt = _split_in_proj(cfg, proj)

    # depthwise causal conv over (x, B, C)
    cw = cfg.ssm_conv
    if state is None:
        pad = F.pad(xbc, (0, 0, cw - 1, 0))
    else:
        pad = torch.cat([state["conv"].to(xbc.dtype), xbc], dim=1)
    conv = sum(pad[:, i:i + L] * params["conv_w"][i].to(x.dtype) for i in range(cw))
    conv = F.silu((conv + params["conv_b"].to(x.dtype)).float()).to(x.dtype)
    xs, B, C = torch.split(conv, [d_in, G * N, G * N], dim=-1)
    xs = xs.reshape(b, L, H, P)
    B = B.reshape(b, L, G, N)
    C = C.reshape(b, L, G, N)

    dt = F.softplus(dt.float() + params["dt_bias"])   # [b,L,H]
    log_a = -dt * torch.exp(params["A_log"])
    x_in = (xs.float() * dt[..., None]).to(x.dtype)

    y, h_final = ssd_chunked(x_in, log_a, B, C, chunk=cfg.ssm_chunk,
                             h0=state["h"] if state is not None else None)
    y = y + xs * params["D"][None, None, :, None].to(x.dtype)
    y = _gated_norm(params["norm_scale"], y.reshape(b, L, d_in), z, cfg.norm_eps)
    out = einsum("ble,ed->bld", y, params["out_proj"])
    if return_state:
        # the last cw - 1 conv inputs, zeros first for a short sequence
        return out, {"conv": pad[:, L:], "h": h_final}
    return out


def mamba2_state_specs(cfg: ModelConfig, batch: int) -> dict:
    d_in, H, P, N, G = _mamba2_dims(cfg)
    conv_dim = d_in + 2 * G * N
    return {
        ("conv",): ParamSpec((batch, cfg.ssm_conv - 1, conv_dim), ("batch", None, "ssm_in"),
                             dtype=cfg.activation_dtype, init="zeros"),
        ("h",): ParamSpec((batch, H, P, N), ("batch", "heads", None, None),
                          dtype=torch.float32, init="zeros"),
    }


def mamba2_decode(params, state, x, *, cfg: ModelConfig):
    """Single-token step. x: [b, 1, d]; state: {'conv': [b,cw-1,Cd], 'h': [b,H,P,N]}.
    The conv runs in f32 here, as the reference's decode step."""
    b, _, d = x.shape
    d_in, H, P, N, G = _mamba2_dims(cfg)
    proj = einsum("bld,de->ble", x, params["in_proj"])[:, 0]
    z, xbc, dt = _split_in_proj(cfg, proj)

    hist = torch.cat([state["conv"].to(xbc.dtype), xbc[:, None, :]], dim=1)   # [b,cw,Cd]
    conv = torch.einsum("bwc,wc->bc", hist.float(), params["conv_w"].float())
    conv = F.silu(conv + params["conv_b"]).to(x.dtype)

    xs, B, C = torch.split(conv, [d_in, G * N, G * N], dim=-1)
    xs = xs.reshape(b, H, P)
    B = B.reshape(b, G, N)
    C = C.reshape(b, G, N)
    dtv = F.softplus(dt.float() + params["dt_bias"])
    log_a = -dtv * torch.exp(params["A_log"])
    h, y = ssd_decode_step(state["h"], (xs.float() * dtv[..., None]).to(x.dtype), log_a, B, C)
    y = y + xs * params["D"][None, :, None].to(x.dtype)
    y = _gated_norm(params["norm_scale"], y.reshape(b, 1, d_in), z[:, None, :], cfg.norm_eps)
    out = einsum("ble,ed->bld", y, params["out_proj"])
    return {"conv": hist[:, 1:], "h": h}, out
