"""Plain PyTorch reference of the decoder-only transformer the cells run
(Llama-style dense layers; Mixtral-style top-k expert layers).

It follows the published architecture, not the program: RMSNorm with a
learned scale, rotary embeddings in the half-split form (the HF Llama and
Mixtral ``rotate_half``), grouped-query causal attention with an optional
sliding window, a SwiGLU FFN or a softmax router over experts whose top-k
gates are renormalised, a final RMSNorm and an untied LM head.  One
departure is stated by the configuration file: an expert layer with a
``capacity_factor`` keeps, per sequence, the first ``capacity`` choices
of each expert in token order (a token's choices in rank order) and drops
the rest, as GShard-style capacity does.

Every sequence runs alone at its true length (no padding, no cache,
no batching), layer by layer over all sequences, so each layer's weights
are widened once.  ``precision="f32"`` computes in float32 with TF32 off;
``precision="fp8"`` is the control: the operands of every matrix product
(weights per output column, activations per token, q/k/v per token and
head) rounded to float8 e4m3 with their own scales, the products summed in
float32, the next precision below the bfloat16 the configurations state.

The module is the family of every configuration file whose ``reference``
key names it: :func:`load` reads such a file into an :class:`Arch`,
:func:`shapes` gives the weights' layout (made by ``lib/weights.py``), and
:class:`Reference` computes the logits.  The family's cost arithmetic is
``costs/transformer.py`` and its mapping onto the program
``program/transformer.py``, found by this module's name.

It imports nothing of the program and takes only the benchmark's weights
and token ids.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0   # float8 e4m3's largest finite value
_PER_LAYER = ("wq", "wk", "wv", "wo", "attn_norm", "ffn_norm", "w_gate", "w_up", "w_down",
              "router")


@dataclasses.dataclass(frozen=True)
class Arch:
    """What the reference, the cost arithmetic and the weights need of a
    configuration."""
    name: str
    layers: int
    d: int
    heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    norm_eps: float
    rope_theta: float
    window: int = 0          # 0: full attention
    experts: int = 0         # 0: dense FFN
    top_k: int = 0
    capacity_factor: float = 0.0
    dtype: str = "bfloat16"

    @property
    def hd(self) -> int:
        return self.d // self.heads

    @property
    def is_moe(self) -> bool:
        return self.experts > 0


def load(raw: dict) -> Arch:
    """A configuration file's keys (the published ``config.json``'s names,
    the values as run; ``program`` the settings it has no key for)."""
    prog = raw.get("program", {})
    return Arch(
        name=raw["name"],
        layers=int(raw["num_hidden_layers"]),
        d=int(raw["hidden_size"]),
        heads=int(raw["num_attention_heads"]),
        kv_heads=int(raw["num_key_value_heads"]),
        d_ff=int(raw["intermediate_size"]),
        vocab=int(raw["vocab_size"]),
        norm_eps=float(raw["rms_norm_eps"]),
        rope_theta=float(raw["rope_theta"]),
        window=int(raw.get("sliding_window") or 0),
        experts=int(raw.get("num_local_experts") or 0),
        top_k=int(raw.get("num_experts_per_tok") or 0),
        capacity_factor=float(prog.get("capacity_factor", 0.0)),
        dtype=raw["torch_dtype"],
    )


def shapes(a: Arch) -> dict[str, tuple[tuple[int, ...], str, float]]:
    """The weights' layout: name -> (shape, kind, std) in draw order; kind
    "w" is the served dtype, "f32" a float32 tensor, "norm" a float32 norm
    scale (1 + N(0, std)).  Matrices are fan-in scaled, the embedding
    N(0, 0.02).  Layers are stacked on the first axis."""
    L, d, f, hd = a.layers, a.d, a.d_ff, a.hd
    out = {
        "embedding": ((a.vocab, d), "w", 0.02),
        "wq": ((L, d, a.heads * hd), "w", 1 / math.sqrt(d)),
        "wk": ((L, d, a.kv_heads * hd), "w", 1 / math.sqrt(d)),
        "wv": ((L, d, a.kv_heads * hd), "w", 1 / math.sqrt(d)),
        "wo": ((L, a.heads * hd, d), "w", 1 / math.sqrt(a.heads * hd)),
        "attn_norm": ((L, d), "norm", 0.05),
        "ffn_norm": ((L, d), "norm", 0.05),
    }
    if a.is_moe:
        e = a.experts
        out.update({
            "router": ((L, d, e), "f32", 1 / math.sqrt(d)),
            "w_gate": ((L, e, d, f), "w", 1 / math.sqrt(d)),
            "w_up": ((L, e, d, f), "w", 1 / math.sqrt(d)),
            "w_down": ((L, e, f, d), "w", 1 / math.sqrt(f)),
        })
    else:
        out.update({
            "w_gate": ((L, d, f), "w", 1 / math.sqrt(d)),
            "w_up": ((L, d, f), "w", 1 / math.sqrt(d)),
            "w_down": ((L, f, d), "w", 1 / math.sqrt(f)),
        })
    out["final_norm"] = ((d,), "norm", 0.05)
    out["head"] = ((d, a.vocab), "w", 1 / math.sqrt(d))
    return out


@contextlib.contextmanager
def strict_fp32():
    """float32 products in float32: TF32 off for the duration."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (its largest magnitude maps to 448), back in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [T, heads, hd] at positions 0..T-1, half-split rotation."""
    t, _, hd = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def capacity(arch: Arch, seq_len: int) -> int:
    """Choices each expert keeps in a sequence the program pads to ``seq_len``."""
    c = math.ceil(seq_len * arch.top_k / arch.experts * arch.capacity_factor)
    return max(int(c), 4)


class Reference:
    def __init__(self, weights: dict[str, torch.Tensor], arch: Arch, *,
                 precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision!r}: f32 or fp8")
        self.w, self.a, self.precision = weights, arch, precision

    # -- products -------------------------------------------------------
    def _act(self, x: torch.Tensor) -> torch.Tensor:
        return fp8(x, -1) if self.precision == "fp8" else x

    def _weight(self, w: torch.Tensor) -> torch.Tensor:
        """A [.., in, out] weight in float32 (fp8: one scale per output column)."""
        w = w.float()
        return fp8(w, -2) if self.precision == "fp8" else w

    def _mm(self, x, w):
        return self._act(x) @ w

    # -- one layer over one sequence ------------------------------------
    def _attention(self, x, lw):
        a = self.a
        t = x.shape[0]
        q = self._mm(x, lw["wq"]).view(t, a.heads, a.hd)
        k = self._mm(x, lw["wk"]).view(t, a.kv_heads, a.hd)
        v = self._mm(x, lw["wv"]).view(t, a.kv_heads, a.hd)
        q, k = rope(q, a.rope_theta), rope(k, a.rope_theta)
        q, k, v = self._act(q), self._act(k), self._act(v)
        g = a.heads // a.kv_heads
        k = k.repeat_interleave(g, dim=1)     # q-head h reads kv-head h // g
        v = v.repeat_interleave(g, dim=1)
        s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(a.hd)
        pos = torch.arange(t, device=x.device)
        mask = pos[:, None] >= pos[None, :]
        if a.window:
            mask &= pos[:, None] - pos[None, :] < a.window
        s = s.masked_fill(~mask, float("-inf"))
        o = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v)
        return self._mm(o.reshape(t, a.heads * a.hd), lw["wo"])

    def _swiglu(self, x, wg, wu, wd):
        return self._mm(F.silu(self._mm(x, wg)) * self._mm(x, wu), wd)

    def _moe(self, x, lw, cap_len):
        a = self.a
        logits = x @ lw["router"]                                      # router in f32
        probs = torch.softmax(logits, dim=-1)
        top, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates, ids = top[:, : a.top_k], ids[:, : a.top_k]              # ties: lowest expert
        gates = gates / gates.sum(dim=-1, keepdim=True)
        keep = torch.ones_like(gates, dtype=torch.bool)
        if a.capacity_factor and cap_len is not None:
            flat = F.one_hot(ids.reshape(-1), a.experts)                 # token-major order
            pos = ((flat.cumsum(dim=0) - 1) * flat).sum(dim=-1).view_as(ids)
            keep = pos < capacity(a, cap_len)
        y = torch.zeros_like(x)
        for e in range(a.experts):
            tok, rank = torch.nonzero((ids == e) & keep, as_tuple=True)
            if tok.numel():
                out = self._swiglu(x[tok], lw["w_gate"][e], lw["w_up"][e], lw["w_down"][e])
                y.index_add_(0, tok, out * gates[tok, rank, None])
        return y

    def _layer(self, h, lw, cap_len):
        a = self.a
        h = h + self._attention(rmsnorm(h, lw["attn_norm"], a.norm_eps), lw)
        x = rmsnorm(h, lw["ffn_norm"], a.norm_eps)
        if a.is_moe:
            return h + self._moe(x, lw, cap_len)
        return h + self._swiglu(x, lw["w_gate"], lw["w_up"], lw["w_down"])

    # -- entry ----------------------------------------------------------
    @torch.no_grad()
    def logits(self, seqs: list[torch.Tensor], positions: list[torch.Tensor], *,
               cap_lens: list[int | None] | None = None) -> list[torch.Tensor]:
        """seqs: token ids [T_i] each; positions: which rows of each sequence's
        [T_i, V] logits to return.  ``cap_lens``: the length the program pads
        each sequence to, which sets an expert's capacity.  -> [len(pos_i), V]
        float32 each."""
        a, w = self.a, self.w
        cap_lens = cap_lens or [None] * len(seqs)
        with strict_fp32():
            hs = [w["embedding"][s.to(w["embedding"].device)].float() for s in seqs]
            for layer in range(a.layers):
                lw = {}
                for n in _PER_LAYER:
                    if n not in w:
                        continue
                    t = w[n][layer]
                    lw[n] = t.float() if n in ("attn_norm", "ffn_norm", "router") \
                        else self._weight(t)
                hs = [self._layer(h, lw, c) for h, c in zip(hs, cap_lens)]
                del lw
            head = self._weight(w["head"])
            out = []
            for h, p in zip(hs, positions):
                x = rmsnorm(h[p.to(h.device)], w["final_norm"].float(), a.norm_eps)
                out.append(self._mm(x, head))
            return out
