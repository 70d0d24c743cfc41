"""E5-style text embedding encoder: bidirectional transformer + mean pooling
+ L2 normalization.  Used by the semantic-operator layer as the embedding
proxy (sem_join sim-filter, sem_group_by, sem_search, sem_sim_join).

The layers are stacked as in the reference, so its param tree crosses
through ``common.params_from_numpy``; a Python loop walks the layer index
where the reference scans.  Attention is the model's
``self_attention(..., causal=False)`` under ``cfg.attn_impl``: with the
default ``"auto"`` it launches the hand-written ``flash_attention`` kernel
for activations on the card (E5-small: f32, head dim 32, non-causal).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common import SpecTree, init_params, tree_to
from repro_torch.configs.base import ModelConfig
from repro_torch.data.tokenizer import TOKENIZER
from repro_torch.device import current_device
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.transformer import _layer, _stack

E5_SMALL = ModelConfig(
    name="e5-small-sim", family="dense",
    num_layers=12, d_model=384, num_heads=12, num_kv_heads=12,
    d_ff=1536, vocab_size=TOKENIZER.vocab_size, rope_theta=10_000.0,
    dtype="float32",
)


def _enc_layer_specs(cfg: ModelConfig) -> dict:
    specs = {("attn",) + p: s for p, s in attn.attention_spec(cfg).items()}
    specs.update({("attn_norm",) + p: s for p, s in L.rmsnorm_spec(cfg.d_model).items()})
    specs.update({("ffn_norm",) + p: s for p, s in L.rmsnorm_spec(cfg.d_model).items()})
    specs.update({("ffn",) + p: s for p, s in L.swiglu_spec(cfg.d_model, cfg.d_ff).items()})
    return specs


def param_specs(cfg: ModelConfig = E5_SMALL) -> SpecTree:
    specs: SpecTree = {}
    specs.update({("embed",) + p: s for p, s in L.embed_spec(cfg.vocab_size, cfg.d_model).items()})
    specs.update(_stack(_enc_layer_specs(cfg), cfg.num_layers, "layers"))
    specs.update({("final_norm",) + p: s for p, s in L.rmsnorm_spec(cfg.d_model).items()})
    return specs


def encode_tokens(params, tokens: torch.Tensor, valid_mask: torch.Tensor, *,
                  cfg: ModelConfig) -> torch.Tensor:
    """tokens [B,T], valid_mask [B,T] -> unit vectors [B, d] (f32)."""
    x = L.embed(params["embed"], tokens).to(cfg.activation_dtype)
    for i in range(cfg.num_layers):
        lp = _layer(params["layers"], i)
        h = L.rmsnorm(lp["attn_norm"], x, cfg.norm_eps)
        a, _ = attn.self_attention(lp["attn"], h, cfg=cfg, causal=False)
        x = x + a
        h = L.rmsnorm(lp["ffn_norm"], x, cfg.norm_eps)
        x = x + L.swiglu(lp["ffn"], h)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    m = valid_mask[..., None].float()
    pooled = (x.float() * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
    return pooled / torch.linalg.vector_norm(pooled, dim=-1, keepdim=True).clamp_min(1e-6)


class Embedder:
    """Batched text -> unit-vector embeddings via the torch encoder.

    ``params`` (a nested dict of tensors, e.g. from
    ``common.params_from_numpy``) are moved to ``repro_torch.current_device()``;
    without them, random weights are drawn there from ``seed``."""

    def __init__(self, cfg: ModelConfig = E5_SMALL, params=None, *, seed: int = 0,
                 max_len: int = 256):
        self.cfg = cfg
        self.max_len = max_len
        self.device = current_device()
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(param_specs(cfg), gen)
        self.params = tree_to(params, self.device)

    @property
    def dim(self) -> int:
        return self.cfg.d_model

    @torch.inference_mode()
    def embed(self, texts: list[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.cfg.d_model), np.float32)
        seqs = [TOKENIZER.encode(t)[: self.max_len] for t in texts]
        out = []
        bs = 64
        for i in range(0, len(seqs), bs):
            batch = seqs[i:i + bs]
            width = max(16, max(len(s) for s in batch))
            toks = TOKENIZER.pad_batch(batch, width)
            mask = (toks != TOKENIZER.pad_id).astype(np.float32)
            vecs = encode_tokens(self.params,
                                 torch.from_numpy(np.asarray(toks, np.int64)).to(self.device),
                                 torch.from_numpy(mask).to(self.device), cfg=self.cfg)
            out.append(vecs.cpu().numpy())
        return np.concatenate(out, axis=0)
