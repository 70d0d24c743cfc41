"""The sharded train step: each rank stores its shard of the params, of the
optimizer state and of the gradient, and the step gathers, reduces and
updates over the mesh.

The port's counterpart of the reference's ``jax.jit(make_train_step(...),
in_shardings=spec_shardings(...), out_shardings=...)`` under
``activation_rules(mesh, "default")``, at one microbatch:

  * params and AdamW state are stored as each rank's shard under
    ``spec_shardings(param_specs)`` and ``spec_shardings(state_specs)``;
  * each layer's weights are gathered from the shards when the model
    indexes the layer (ZeRO-3), the embedding, final norm and head at the
    start of the step;
  * a stack whose ``layers`` dimension the rules cut (over ``pod`` on a
    multi-pod mesh) is a placement, as under ``jax.jit``: layer i of L lives
    on layer shard q = i // (L / n) (n shards), at local index i - q L / n,
    and is gathered from shard q's ranks alone (``NamedSharding.gather``
    with the source's ``pod`` fixed); the step is still the single-device
    step's, not a pipeline;
  * the global batch is split over the ``batch`` rule's axes; ranks that
    share a batch slice (those that differ only on the other axes) compute
    it redundantly;
  * the loss is each rank's CE sum over the global valid-token count (one
    SUM over the batch axes), so the gradients summed over the batch axes
    are the single-device step's;
  * as soon as autograd has a gathered leaf's whole gradient, a hook sums
    it in f32 over the batch axes (one ``all_reduce`` on every rank), keeps
    this rank's slice in an f32 shard (a layer's only on its owner's ranks)
    and frees the whole: the whole gradients alive at once are those of the
    leaves whose backward is under way (about a layer's), not the model's;
  * the clipping norm is the whole gradient's, summed from each rank's
    shard; AdamW (``optimizer.apply_updates``) runs on each rank's shard.

The single-device step (``train/trainstep.py``) is unchanged.
"""
from __future__ import annotations

import math

import torch

from repro_torch.common import flatten, unflatten
from repro_torch.configs.base import ModelConfig
from repro_torch.data.tokenizer import TOKENIZER
from repro_torch.dist import sharding as shd
from repro_torch.models import registry
from repro_torch.train import optimizer as opt


class _AtUse:
    """A stacked leaf whose layer i is gathered from the ranks' shards when
    the model indexes it; each gathered layer is a leaf of the backward
    whose gradient ``keep`` takes as soon as autograd has summed it.
    ``lead`` holds the mesh axes that cut the stack's layer dimension (none:
    every rank holds every layer's shard)."""

    def __init__(self, path, local: torch.Tensor, row: shd.NamedSharding, lead, keep):
        self.path, self.local, self.row, self.keep = path, local, row, keep
        self.lead = shd.entry_axes(lead)
        self.per = local.shape[0]      # layers a layer shard holds

    def __getitem__(self, i: int) -> torch.Tensor:
        at = shd.shard_coordinate(self.row.mesh, self.lead, _owner(i, self.per))
        # the owner's ranks send their slot i % per; the others' gives the shape
        full = self.row.gather(self.local[i % self.per], at=at).detach().requires_grad_()
        full.register_post_accumulate_grad_hook(self.keep(self.path, i, self.row, self.lead,
                                                          self.per))
        return full


def _owner(i: int, per: int) -> int:
    """The layer shard that holds layer i of a stack cut into shards of
    ``per`` layers."""
    return i // per


def _grad_shard(g: torch.Tensor, mesh, dp, slices) -> torch.Tensor:
    """This rank's slice of a whole gradient summed over the batch axes."""
    return shd.all_reduce(g.float(), mesh, dp)[slices]


def _sharded_norm(grads: dict, shardings: dict, mesh) -> torch.Tensor:
    """The whole gradient's global norm from each rank's shards: a shard
    held by r ranks counts 1/r in each, and the squares are summed over the
    mesh."""
    sizes = shd.mesh_sizes(mesh)
    total = math.prod(sizes.values())
    sq = []
    for path in sorted(grads):
        held = math.prod(sizes[a] for e in shardings[path].spec for a in shd.entry_axes(e))
        sq.append(torch.linalg.vector_norm(grads[path], dtype=torch.float32) ** 2
                  * (held / total))
    return torch.sqrt(shd.all_reduce(torch.stack(sq).sum(), mesh, shd.axis_names(mesh)))


def make_sharded_train_step(cfg: ModelConfig, opt_cfg: opt.OptimizerConfig, mesh):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics) under the ``"default"`` rules: ``params`` and ``opt_state`` are
    this rank's shards (updated in place), ``batch`` the global
    {"tokens", "labels"} [B, S] on every rank, with the model's other
    inputs (``image_embeds``, ``audio_frames``) when it takes them; metrics as the single-device
    step's at one microbatch.  A stack the rules cut over its layers holds
    each rank's layer shard (``params[stack]`` leaves [L / n, ...])."""
    pspecs = registry.param_specs(cfg)
    psh = flatten(shd.spec_shardings(pspecs, mesh))
    stacked = {p for p, s in pspecs.items() if s.axes[:1] == ("layers",)}

    def train_step(params, opt_state, batch):
        tokens, labels = batch["tokens"], batch["labels"].long()
        bsh = shd.NamedSharding(mesh, shd.resolve_pspec(tokens.shape, ("batch", None), mesh,
                                                        "default"))
        rows = bsh.local_slices(tokens.shape)[0]
        dp = bsh.spec[0]
        local = flatten(params)
        gl = {p: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
              for p, t in local.items()}

        def keep(path, i, sh, lead=(), per=1):
            if i is None:
                out = gl[path]
            elif shd.shard_index(mesh, lead) == _owner(i, per):
                out = gl[path][i % per]
            else:
                out = None        # another layer shard's: summed here, kept there

            def hook(full):
                g = _grad_shard(full.grad, mesh, dp, sh.local_slices(full.shape))
                if out is not None:
                    out.add_(g)
                full.grad = None
            return hook

        tree = {}
        for p, t in local.items():
            if p in stacked:
                spec = psh[p].spec
                tree[p] = _AtUse(p, t, shd.NamedSharding(mesh, shd.P(*spec[1:])), spec[0], keep)
            else:
                tree[p] = psh[p].gather(t).detach().requires_grad_()
                tree[p].register_post_accumulate_grad_hook(keep(p, None, psh[p]))
        with shd.activation_rules(mesh, "default"):     # the remat replays meet it too
            extra = {k: v[rows] for k, v in batch.items()
                     if k not in ("tokens", "labels")} or None
            logits, aux = registry.forward(cfg, unflatten(tree), tokens[rows], extra=extra,
                                           remat=cfg.remat)
            lab = labels[rows]
            valid = (lab != TOKENIZER.pad_id) & (lab >= 0)
            logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
            tgt = torch.gather(logp, -1, torch.clamp(lab, min=0)[..., None])[..., 0]
            denom = torch.clamp(shd.all_reduce(valid.sum().float(), mesh, dp), min=1)
            ce_local = -torch.where(valid, tgt, 0.0).sum() / denom
            # every rank runs the same graph, so the hooks' reductions meet in order
            torch.autograd.backward(ce_local + sum((aux or {}).values()))
        del tree, logits, logp
        ce = shd.all_reduce(ce_local.detach(), mesh, dp)
        metrics = {"ce": ce, **{k: v.detach() for k, v in (aux or {}).items()}}
        gnorm = _sharded_norm(gl, psh, mesh)
        params, opt_state, om = opt.apply_updates(opt_cfg, params, opt_state, unflatten(gl),
                                                  gnorm=gnorm)
        return params, opt_state, {"loss": ce + sum(metrics[k] for k in (aux or {})),
                                   **metrics, **om}

    return train_step
