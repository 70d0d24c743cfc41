"""Pipeline parallelism (GPipe-style, dense decoder stacks) over ranks.

The layer stack is cut into S contiguous stages, S the size of the first
mesh axis when it divides ``num_layers`` (else 1, as the reference's
``_n_stages``); the rank at coordinate s on that axis runs stage s.
Microbatches flow on the (n_micro + S - 1)-tick schedule: at tick t stage
s runs microbatch t - s.  Stage 0 embeds, the last stage runs the final
norm and the unembedding, and the logits are broadcast to every stage, so
each rank returns the whole [B, S, V] (every rank computes the same loss
from them; the gradient that enters the pipeline is the last stage's).
Ranks that differ only on the other mesh axes run the same pipeline, each
on the whole batch.

One rank is one process, so each tick first runs every stage's microbatch
(concurrently, one process each), then hands each stage's output to the
next stage over a two-rank group (a ``broadcast``: gloo carries no
``send``/``recv`` for CUDA tensors).  The schedule is one autograd node
(:class:`_Pipeline`): its backward runs the ticks in reverse, each stage
differentiating its own microbatch graphs and handing the input's gradient
back to the previous stage, so every rank issues the same collectives in
the same order.  Each rank's gradient reaches its stage's layer rows (a
zero gradient for the other stages' rows when ``params["layers"]`` holds
the whole stack) and, summed over the stages, the embedding, final norm
and head: a tied embedding gets both its lookup's contribution (stage 0)
and the unembedding's (the last stage).

Numerics are ``registry.forward``'s: the schedule only reorders independent
per-microbatch work, and the loss combines per-microbatch CE sums with a
shared valid-token denominator.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.common import flatten, unflatten
from repro_torch.configs.base import ModelConfig
from repro_torch.data.tokenizer import TOKENIZER
from repro_torch.dist import sharding as shd
from repro_torch.models import layers as Lyr
from repro_torch.models import transformer as T


def _n_stages(cfg: ModelConfig, mesh) -> int:
    s = shd.mesh_sizes(mesh)[shd.axis_names(mesh)[0]]
    return s if cfg.num_layers % s == 0 else 1


class _Stages:
    """This rank's place in the pipeline: its stage, the ranks of its
    pipeline (one per stage), and the groups between them."""

    def __init__(self, cfg: ModelConfig, mesh):
        self.n = _n_stages(cfg, mesh)
        self.per = cfg.num_layers // self.n
        first = shd.axis_names(mesh)[0]
        self.stage = shd.coordinate(mesh)[first] if self.n > 1 else 0
        if self.n > 1:
            self.group = shd.axis_group(mesh, first)
            self.ranks = dist.get_process_group_ranks(self.group)
            self.pairs = shd.neighbour_groups(mesh, first)

    def handoff(self, s: int, t: torch.Tensor | None, like) -> torch.Tensor | None:
        """Stage s's tensor ``t`` to stage s + 1 (``like`` = (shape, dtype,
        device) of the buffer there); the others return None."""
        if self.stage not in (s, s + 1):
            return None
        buf = t.detach().contiguous() if self.stage == s else torch.empty(
            like[0], dtype=like[1], device=like[2])
        dist.broadcast(buf, src=self.ranks[s], group=self.pairs[s])
        return buf if self.stage == s + 1 else None

    def handback(self, s: int, g: torch.Tensor | None, like) -> torch.Tensor | None:
        """Stage s's gradient ``g`` back to stage s - 1."""
        if self.stage not in (s - 1, s):
            return None
        buf = g.contiguous() if self.stage == s else torch.empty(
            like[0], dtype=like[1], device=like[2])
        dist.broadcast(buf, src=self.ranks[s], group=self.pairs[s - 1])
        return buf if self.stage == s - 1 else None


def _stage_rows(t: torch.Tensor, st: _Stages, num_layers: int) -> torch.Tensor:
    """This stage's rows of a stacked layer leaf: a view of the whole stack,
    or the leaf itself when it holds only this stage's rows."""
    if t.shape[0] == num_layers:
        return t[st.stage * st.per:(st.stage + 1) * st.per]
    if t.shape[0] == st.per:
        return t
    raise ValueError(f"layer leaf of {t.shape[0]} rows: neither {num_layers} nor {st.per}")


def _apply_stage(layers, h, *, cfg: ModelConfig, per: int):
    for j in range(per):
        h, _, _ = T._decoder_layer_seq(T._layer(layers, j), h, cfg=cfg, use_moe=False)
    return h


class _Pipeline(torch.autograd.Function):
    """tokens + every param leaf -> logits [B, S, V] f32 on every rank."""

    @staticmethod
    def forward(ctx, run, tokens, *leaves):
        cfg, st, n_micro, paths = run["cfg"], run["stages"], run["n_micro"], run["paths"]
        views = []
        for path, t in zip(paths, leaves):
            v = _stage_rows(t, st, cfg.num_layers) if path[0] == "layers" else t
            views.append(v.detach().requires_grad_())
        p = unflatten(dict(zip(paths, views)))
        b = tokens.shape[0]
        toks = tokens.reshape((n_micro, b // n_micro) + tokens.shape[1:])
        like = ((b // n_micro,) + tokens.shape[1:] + (cfg.d_model,), cfg.activation_dtype,
                tokens.device)
        ins, outs, recv = {}, {}, {}
        with torch.enable_grad():
            for t in range(n_micro + st.n - 1):
                m = t - st.stage
                if 0 <= m < n_micro:
                    if st.stage == 0:
                        h = Lyr.embed(p["embed"], toks[m]).to(cfg.activation_dtype)
                    else:
                        h = ins[m] = recv.pop(m).requires_grad_()
                    outs[m] = _apply_stage(p["layers"], h, cfg=cfg, per=st.per)
                for s in range(st.n - 1):       # hand-offs after every stage's work
                    if 0 <= t - s < n_micro:
                        got = st.handoff(s, outs.get(t - s), like)
                        if got is not None:
                            recv[t - s] = got.detach()
            logits = None
            if st.stage == st.n - 1:
                x = torch.cat([outs[m] for m in range(n_micro)], dim=0)
                x = Lyr.rmsnorm(p["final_norm"], x, cfg.norm_eps)
                logits = Lyr.unembed({**p.get("out", {}), **p["embed"]}, x,
                                     tied=cfg.tie_embeddings)
        out = logits.detach() if logits is not None else torch.empty(
            (b,) + tokens.shape[1:] + (cfg.vocab_size,), dtype=torch.float32,
            device=tokens.device)
        if st.n > 1:
            dist.broadcast(out, src=st.ranks[-1], group=st.group)
        ctx.run, ctx.shapes = run, [t.shape for t in leaves]
        ctx.views, ctx.ins, ctx.outs, ctx.logits, ctx.like = views, ins, outs, logits, like
        return out

    @staticmethod
    def backward(ctx, g_logits):
        run, st, n_micro, paths = ctx.run, ctx.run["stages"], ctx.run["n_micro"], ctx.run["paths"]
        views, ins, outs = ctx.views, ctx.ins, ctx.outs
        # f32 sums over the microbatches, cast to each leaf's dtype at the end
        grads = [torch.zeros(v.shape, dtype=torch.float32, device=v.device) for v in views]

        def add(targets, gs):
            for i, g in zip(targets, gs):
                if g is not None:
                    grads[i] += g

        stage_idx = [i for i, p in enumerate(paths) if p[0] == "layers"]
        if st.stage == 0:
            stage_idx += [i for i, p in enumerate(paths) if p[0] == "embed"]
        g_out = {}
        with torch.enable_grad():
            if ctx.logits is not None:      # the last stage: the head
                head_idx = [i for i, p in enumerate(paths) if p[0] != "layers"]
                gs = torch.autograd.grad(ctx.logits, [outs[m] for m in range(n_micro)]
                                         + [views[i] for i in head_idx], g_logits,
                                         allow_unused=True)
                g_out = dict(enumerate(gs[:n_micro]))
                add(head_idx, gs[n_micro:])
            g_in = {}
            for t in reversed(range(n_micro + st.n - 1)):
                m = t - st.stage
                if 0 <= m < n_micro:
                    first = [ins[m]] if st.stage > 0 else []
                    gs = torch.autograd.grad(outs[m], first + [views[i] for i in stage_idx],
                                             g_out.pop(m), allow_unused=True)
                    if first:
                        g_in[m] = gs[0]
                    add(stage_idx, gs[len(first):])
                for s in range(1, st.n):        # gradients back, after every stage's work
                    if 0 <= t - s < n_micro:
                        got = st.handback(s, g_in.pop(t - s, None), ctx.like)
                        if got is not None:
                            g_out[t - s] = got
        out = []
        for path, shape, v, g in zip(paths, ctx.shapes, views, grads):
            if path[0] == "layers":
                if shape[0] != g.shape[0]:       # the whole stack: this stage's rows
                    full = g.new_zeros(shape)
                    _stage_rows(full, st, run["cfg"].num_layers).copy_(g)
                    g = full
            elif st.n > 1:                      # embedding, final norm, head
                dist.all_reduce(g, group=st.group)
            out.append(g.to(v.dtype))
        return (None, None, *out)


def pp_forward(cfg: ModelConfig, mesh, params, tokens, *, n_micro: int = 4):
    """tokens [B,S] -> logits [B,S,V] via the staged microbatch schedule.
    ``params["layers"]`` holds the whole stack or this stage's rows."""
    if T.layer_layout(cfg)["kind"] != "dense":
        raise NotImplementedError("pipeline parallelism covers dense stacks")
    b = tokens.shape[0]
    assert b % n_micro == 0, (b, n_micro)
    flat = flatten(params)
    run = {"cfg": cfg, "stages": _Stages(cfg, mesh), "n_micro": n_micro,
           "paths": list(flat)}
    return _Pipeline.apply(run, tokens, *flat.values())


def make_pp_loss(cfg: ModelConfig, mesh, *, n_micro: int = 4):
    """Causal-LM CE over the pipelined forward (same math as trainstep.loss_fn
    for dense models: PAD labels ignored, one global token denominator)."""

    def loss(params, tokens, labels):
        logits = pp_forward(cfg, mesh, params, tokens, n_micro=n_micro)
        labels = labels.long()
        valid = (labels != TOKENIZER.pad_id) & (labels >= 0)
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        tgt = torch.gather(logp, -1, torch.clamp(labels, min=0)[..., None])[..., 0]
        return -torch.where(valid, tgt, 0.0).sum() / torch.clamp(valid.sum(), min=1)

    return loss
