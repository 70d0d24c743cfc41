"""xLSTM language model: grouped stacks of mLSTM blocks with an sLSTM block
every ``cfg.slstm_every`` layers (xLSTM[m:s] notation of arXiv:2405.04517).

The reference scans groups of (``slstm_every - 1`` mLSTM blocks + 1 sLSTM
block); group g owns mLSTM layers ``g * m_per_group ...`` of ``m_layers``
and sLSTM layer g of ``s_layers``.  :func:`_blocks` lists that order, and
the cache keeps the reference's layer order, so states cross between the
packages.  The cache holds recurrent states only (no sequence axis):
``{"m": {C, n, conv}, "s": {h, c, n, m}}``, each stacked over its layers;
``prefill`` and ``decode_step`` write them in place and return the same
dict.  A prefill starts from zero states and ends in the state after its
last token, so a caller prefills a prompt at its true length
(``engine/runner.py``).
"""
from __future__ import annotations

from repro_torch.common import ParamSpec, SpecTree
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import xlstm as X
from repro_torch.models.transformer import _layer, _maybe_remat, _set_layer, _stack


def _layout(cfg: ModelConfig):
    if cfg.slstm_every:
        g = cfg.num_layers // cfg.slstm_every
        return {"groups": g, "m_per_group": cfg.slstm_every - 1,
                "n_m": g * (cfg.slstm_every - 1), "n_s": g}
    return {"groups": 0, "m_per_group": 0, "n_m": cfg.num_layers, "n_s": 0}


def _blocks(cfg: ModelConfig) -> list[tuple[str, int]]:
    """(kind "m" or "s", index in its stack) in the order a token passes them."""
    lay = _layout(cfg)
    if not lay["n_s"]:
        return [("m", i) for i in range(lay["n_m"])]
    per = lay["m_per_group"]
    return [b for g in range(lay["groups"])
            for b in [("m", g * per + j) for j in range(per)] + [("s", g)]]


def _m_block_specs(cfg):
    specs = {("norm",) + p: s for p, s in L.rmsnorm_spec(cfg.d_model).items()}
    specs.update({("mixer",) + p: s for p, s in X.mlstm_spec(cfg).items()})
    return specs


def _s_block_specs(cfg):
    specs = {("norm",) + p: s for p, s in L.rmsnorm_spec(cfg.d_model).items()}
    specs.update({("mixer",) + p: s for p, s in X.slstm_spec(cfg).items()})
    return specs


def param_specs(cfg: ModelConfig) -> SpecTree:
    lay = _layout(cfg)
    specs: SpecTree = {}
    specs.update({("embed",) + p: s for p, s in L.embed_spec(cfg.vocab_size, cfg.d_model).items()})
    specs.update(_stack(_m_block_specs(cfg), lay["n_m"], "m_layers"))
    if lay["n_s"]:
        specs.update(_stack(_s_block_specs(cfg), lay["n_s"], "s_layers"))
    specs.update({("final_norm",) + p: s for p, s in L.rmsnorm_spec(cfg.d_model).items()})
    specs.update({("out",) + p: s for p, s in L.unembed_spec(
        cfg.vocab_size, cfg.d_model, tied=cfg.tie_embeddings).items()})
    return specs


_SEQ = {"m": X.mlstm_forward, "s": X.slstm_forward}
_STEP = {"m": X.mlstm_decode, "s": X.slstm_decode}


def _block(lp, x, *, kind: str, cfg: ModelConfig):
    return x + _SEQ[kind](lp["mixer"], L.rmsnorm(lp["norm"], x, cfg.norm_eps), cfg=cfg)


def _run_seq(params, x, *, cfg: ModelConfig, cache=None, remat: bool = False):
    """The blocks over a whole sequence; with ``cache``, each block's final
    state is written into its layer of the cache."""
    block = _maybe_remat(_block, cfg, remat)
    for kind, i in _blocks(cfg):
        lp = _layer(params[f"{kind}_layers"], i)
        if cache is None:
            x = block(lp, x, kind=kind, cfg=cfg)
        else:
            h = L.rmsnorm(lp["norm"], x, cfg.norm_eps)
            y, st = _SEQ[kind](lp["mixer"], h, cfg=cfg, return_state=True)
            _set_layer(cache[kind], i, st)
            x = x + y
    return x


def _logits(params, x, cfg):
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.unembed({**params.get("out", {}), **params["embed"]}, x, tied=cfg.tie_embeddings)


def forward(params, tokens, *, cfg: ModelConfig, extra=None, remat: bool = False):
    x = L.embed(params["embed"], tokens).to(cfg.activation_dtype)
    return _logits(params, _run_seq(params, x, cfg=cfg, remat=remat), cfg), {}


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> SpecTree:
    lay = _layout(cfg)
    specs: SpecTree = {}
    for kind, n, state in (("m", lay["n_m"], X.mlstm_state_specs(cfg, batch)),
                           ("s", lay["n_s"], X.slstm_state_specs(cfg, batch))):
        if n:
            for p, s in state.items():
                specs[(kind,) + p] = ParamSpec((n,) + s.shape, ("layers",) + s.axes,
                                               dtype=s.dtype, init="zeros")
    return specs


def prefill(params, tokens, cache, *, cfg: ModelConfig, extra=None, last_only=False):
    """tokens [B,S] + cache -> (logits, cache holding each block's state
    after token S-1, written in place)."""
    x = L.embed(params["embed"], tokens).to(cfg.activation_dtype)
    x = _run_seq(params, x, cfg=cfg, cache=cache)
    if last_only:
        x = x[:, -1:]
    return _logits(params, x, cfg), cache


def decode_step(params, tokens, cache, cache_len, *, cfg: ModelConfig, extra=None):
    """tokens [B,1] + cache -> (logits [B,1,V], cache stepped in place);
    ``cache_len`` is unused: the states carry the position."""
    x = L.embed(params["embed"], tokens).to(cfg.activation_dtype)
    for kind, i in _blocks(cfg):
        lp = _layer(params[f"{kind}_layers"], i)
        h = L.rmsnorm(lp["norm"], x, cfg.norm_eps)
        st, y = _STEP[kind](lp["mixer"], _layer(cache[kind], i), h, cfg=cfg)
        _set_layer(cache[kind], i, st)
        x = x + y
    return _logits(params, x, cfg), cache
