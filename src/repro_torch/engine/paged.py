"""Paged KV cache (vLLM's PagedAttention), dense and MoE layouts.

The allocator is the reference's: a host-side free list of fixed-size
pages and per-slot page tables, so variable-length requests never
fragment the cache.  Pages live in [L, pages, page_size, kv_heads,
head_dim] tensors; a decode step writes each row's new K/V into its page
in place, gathers each row's pages into a [B, maxp * page_size, Hk, hd]
cache and runs the same attention as the contiguous decode: on the card
the ``decode_attention`` kernel, on the CPU the reference's ``gqa_attend``
under the reference's mask (positions ``0..lens``, no sliding window:
for mixtral's 4096 window paged and contiguous decode part past position
4096, as in the reference).  A MoE layer's FFN is ``moe_ffn`` plus the
shared expert where the config has one.  Like the reference, it serves the
layouts with one ``"self"`` cache (``dense``, ``moe``) and refuses the
interleaved MoE and VLM layouts and the families that are no decoder-only
transformer (``audio``, ``ssm``, ``hybrid``), by name: ``layer_layout``
calls any family it does not group ``"dense"``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import current_device
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import transformer


class PageAllocator:
    """Host-side free-list page allocator + per-slot page tables.

    Every mutation replaces ``table`` with a fresh array, as the
    reference's does (there, an asynchronous step may still read the old
    one): a table handed to a step is never changed under it."""

    def __init__(self, num_pages: int, page_size: int, max_slots: int, max_pages_per_slot: int):
        self.page_size = page_size
        self.free = list(range(num_pages - 1, -1, -1))
        self.table = np.zeros((max_slots, max_pages_per_slot), np.int32)
        self.pages_used: list[list[int]] = [[] for _ in range(max_slots)]

    def ensure(self, slot: int, n_tokens: int) -> None:
        need = (n_tokens + self.page_size - 1) // self.page_size
        used = self.pages_used[slot]
        if len(used) >= need:
            return
        if len(self.free) < need - len(used):  # check upfront: the update
            raise MemoryError("out of KV pages")  # below must be atomic
        table = self.table.copy()
        while len(used) < need:
            p = self.free.pop()
            table[slot, len(used)] = p
            used.append(p)
        self.table = table

    def release(self, slot: int) -> None:
        self.free.extend(reversed(self.pages_used[slot]))
        self.pages_used[slot] = []
        table = self.table.copy()
        table[slot] = 0
        self.table = table


def init_pages(cfg: ModelConfig, num_pages: int, page_size: int):
    """Zeroed pages on ``repro_torch.current_device()``, one stack per
    decoder layer of the layout's ``layers``."""
    lay = transformer.layer_layout(cfg)
    shape = (lay.get("dense") or lay.get("moe"), num_pages, page_size, cfg.num_kv_heads,
             cfg.hd)
    return {name: torch.zeros(shape, dtype=cfg.activation_dtype, device=current_device())
            for name in ("k", "v")}


def _gather_pages(pages_l, table):
    """pages_l: [P, ps, hk, hd]; table: [B, maxp] -> [B, maxp*ps, hk, hd]."""
    g = pages_l[table]  # [B, maxp, ps, hk, hd]
    b, mp, ps = g.shape[0], g.shape[1], g.shape[2]
    return g.reshape(b, mp * ps, g.shape[3], g.shape[4])


def _on(x, device, dtype) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.to(device=device, dtype=dtype)


@torch.inference_mode()
def paged_decode_step(cfg: ModelConfig, params, tokens, pages, table, lens):
    """One decode step with paged KV. tokens [B,1]; table [B,maxp]; lens [B]
    (tensors or numpy arrays).  The pages are written in place.

    Returns (logits [B,1,V] f32, pages)."""
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"paged decode serves the dense and moe layouts of the "
                         f"transformer, not the {cfg.family} family ({cfg.name})")
    lay = transformer.layer_layout(cfg)
    if lay["kind"] not in ("dense", "moe"):
        raise ValueError(f"paged decode serves the dense and moe layouts, not "
                         f"{lay['kind']} ({cfg.name})")
    use_moe = lay["kind"] == "moe"
    dev = pages["k"].device
    tokens, table = _on(tokens, dev, torch.int64), _on(table, dev, torch.int64)
    lens = _on(lens, dev, torch.int32)
    b, ps = tokens.shape[0], pages["k"].shape[2]
    x = L.embed(params["embed"], tokens).to(cfg.activation_dtype)
    bidx = torch.arange(b, device=dev)
    # the physical page holding position `lens`; an index past the table is
    # clamped to its last entry, as a JAX gather clamps it
    page_of = table[bidx, (lens.long() // ps).clamp(0, table.shape[1] - 1)]
    off = lens.long() % ps
    for i in range(lay[lay["kind"]]):
        lp = transformer._layer(params["layers"], i)
        kp, vp = pages["k"][i], pages["v"][i]
        h = L.rmsnorm(lp["attn_norm"], x, cfg.norm_eps)
        q, k_new, v_new = attn.project_qkv(lp["attn"], h, cfg=cfg, positions=lens[:, None])
        kp[page_of, off] = k_new[:, 0].to(kp.dtype)
        vp[page_of, off] = v_new[:, 0].to(vp.dtype)
        k, v = _gather_pages(kp, table), _gather_pages(vp, table)
        # the reference's paged mask has no sliding window
        o = attn.decode_attend(q, k, v, lens, window=0, cfg=cfg)
        x = x + attn.out_proj(lp["attn"], o)
        h = L.rmsnorm(lp["ffn_norm"], x, cfg.norm_eps)
        x = x + transformer._ffn(lp, h, cfg=cfg, use_moe=use_moe)[0]
    return transformer._logits(params, x, cfg=cfg), pages
