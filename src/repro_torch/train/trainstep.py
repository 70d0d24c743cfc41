"""Training step: CE loss + MoE aux, microbatch gradient accumulation in f32,
optional int8 error-feedback compression, AdamW update.

The torch form of ``repro.train.trainstep``.  Gradients come from
``torch.autograd.grad`` per microbatch, added into f32 buffers (the
reference's ``jax.lax.scan`` accumulates ``g.astype(f32)``), never into the
params' bf16 ``.grad`` fields.  A param stacked over layers is
differentiated as one leaf per layer (views of the stack, so the forward's
per-layer indexing has no backward that scatters into a zero-filled copy of
the whole stack), and each layer's gradient is added into its row of the
stack's buffer.  On the card the attention's gradient is the
``flash_attention`` backward kernel (``kernels/flash_attention.py``).
"""
from __future__ import annotations

import torch

from repro_torch.common import flatten, unflatten
from repro_torch.configs.base import ModelConfig
from repro_torch.data.tokenizer import TOKENIZER
from repro_torch.models import registry
from repro_torch.train import grad_compress, optimizer as opt


def loss_fn(cfg: ModelConfig, params, tokens, labels, extra=None):
    """Causal-LM cross-entropy, ignoring PAD labels; adds MoE aux losses."""
    logits, aux = registry.forward(cfg, params, tokens, extra=extra, remat=cfg.remat)
    labels = labels.long()
    valid = (labels != TOKENIZER.pad_id) & (labels >= 0)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    tgt = torch.gather(logp, -1, torch.clamp(labels, min=0)[..., None])[..., 0]
    denom = torch.clamp(valid.sum(), min=1)
    ce = -torch.where(valid, tgt, 0.0).sum() / denom
    total = ce
    for v in (aux or {}).values():
        total = total + v
    return total, {"ce": ce, **(aux or {})}


def _grad_leaves(cfg: ModelConfig, params) -> tuple[dict, list, list]:
    """(a param tree for the forward, the leaves to differentiate, where each
    leaf's gradient goes: (path, layer index or None)).  Every leaf is a
    detached view of the param, so nothing is copied."""
    stacked = {p for p, s in registry.param_specs(cfg).items() if s.axes[:1] == ("layers",)}
    tree, leaves, where = {}, [], []
    for path, t in flatten(params).items():
        if path in stacked:
            views = [t[i].detach().requires_grad_() for i in range(t.shape[0])]
            tree[path] = views
            leaves += views
            where += [(path, i) for i in range(len(views))]
        else:
            tree[path] = t.detach().requires_grad_()
            leaves.append(tree[path])
            where.append((path, None))
    return unflatten(tree), leaves, where


def grads_and_loss(cfg: ModelConfig, params, tokens, labels, extra=None, *,
                   microbatches: int = 1):
    """(loss, metrics, grads): the mean loss over ``microbatches`` equal
    slices of the batch, the last slice's metrics (as the reference's scan
    keeps ``m[-1]``), and the mean gradient as an f32 tree shaped like
    ``params``."""
    b = tokens.shape[0]
    assert b % microbatches == 0, (b, microbatches)
    mb = b // microbatches
    tree, leaves, where = _grad_leaves(cfg, params)
    gacc = {p: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
            for p, t in flatten(params).items()}
    lsum = None
    for j in range(microbatches):
        sl = slice(j * mb, (j + 1) * mb)
        e = {k: v[sl] for k, v in extra.items()} if extra else None
        loss, metrics = loss_fn(cfg, tree, tokens[sl], labels[sl], e)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        for (path, i), g in zip(where, grads):
            if g is not None:
                (gacc[path] if i is None else gacc[path][i]).add_(g)
        del grads
        loss = loss.detach()
        lsum = loss if lsum is None else lsum + loss
        metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                   for k, v in metrics.items()}
    if microbatches > 1:
        for g in gacc.values():
            g.div_(microbatches)
        lsum = lsum / microbatches
    return lsum, metrics, unflatten(gacc)


def make_train_step(cfg: ModelConfig, opt_cfg: opt.OptimizerConfig, *,
                    microbatches: int = 1, compress: bool = False):
    """Returns train_step(params, opt_state, batch[, err_buf]) -> (...), which
    updates ``params`` and ``opt_state`` in place (``opt.apply_updates``)
    and returns them."""

    def train_step(params, opt_state, batch, err_buf=None):
        extra = {k: v for k, v in batch.items() if k not in ("tokens", "labels")} or None
        loss, metrics, grads = grads_and_loss(cfg, params, batch["tokens"], batch["labels"],
                                              extra, microbatches=microbatches)
        if compress:
            grads, err_buf = grad_compress.compress_tree(grads, err_buf)
        params, opt_state, om = opt.apply_updates(opt_cfg, params, opt_state, grads)
        metrics = {"loss": loss, **metrics, **om}
        if compress:
            return params, opt_state, err_buf, metrics
        return params, opt_state, metrics

    return train_step
