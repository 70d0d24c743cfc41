"""Shard-local MoE: dispatch over this rank's experts, then explicit
reductions over the mesh.

The reference's ``shard_map`` layer, run by each rank on its own shards:

  * batch rows over the dp axes (``pod``, ``data``): x holds this rank's
    rows, and dispatch/combine are per row, so they stay local;
  * experts over ``model`` when divisible (expert parallelism: each rank
    dispatches only to its experts ``[shard*e_loc, (shard+1)*e_loc)``, and
    the choices of the other ranks' experts drop here);
  * otherwise d_ff over ``model`` (tensor parallelism inside the experts);
  * one SUM over ``model`` merges the expert (EP) or row-parallel (TP)
    partials, and ``moe_lb``/``moe_z`` are averaged over the dp axes.

Routing, slots and drops are the single-device layer's (``moe.route``,
lowest-index ties), computed from all experts, so the result equals
``moe_ffn`` on the same rows.  ``params`` hold either the whole expert
stacks (each rank takes its shard as a view: the reference's gather at
entry, ZeRO-3 semantics) or this rank's shard of them.

For training, the reductions carry Megatron's conjugate pair: the entry to
the sharded part is the identity forward and a SUM over ``model`` backward
(each rank's gradient of x and of the gates is a partial over its experts
or columns), the exit a SUM forward and the identity backward.  The router
and the aux losses stay outside, replicated over ``model``; the aux
losses' gradient on each rank is its share (1/n_dp) of the mean's.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import sharding as shd
from repro_torch.models.moe import aux_losses, capacity, dispatch_combine, route


class _EnterModel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over ``model``."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return shd.all_reduce(g.contiguous().clone(), ctx.mesh, "model"), None


class _SumModel(torch.autograd.Function):
    """SUM over ``model`` forward; the identity backward."""

    @staticmethod
    def forward(ctx, y, mesh):
        return shd.all_reduce(y.contiguous().clone(), mesh, "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _MeanOver(torch.autograd.Function):
    """The mean over ``axes`` forward; each rank's backward is its share of
    the mean's gradient (the gradients are summed over those ranks later)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        sizes = shd.mesh_sizes(mesh)
        ctx.n = math.prod(sizes[a] for a in axes)
        return shd.all_reduce(x.detach().clone(), mesh, axes, "mean")

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


def _cut(w: torch.Tensor, dim: int, full: int, shard: int, n: int) -> torch.Tensor:
    """This rank's shard of ``w`` along ``dim``: a view of a whole stack, or
    ``w`` itself when it is the shard already."""
    if w.shape[dim] == full:
        return w.narrow(dim, shard * (full // n), full // n)
    if w.shape[dim] == full // n:
        return w
    raise ValueError(f"expert weight {tuple(w.shape)}: dim {dim} is neither {full} "
                     f"nor its 1/{n} shard")


def moe_ffn_sharded(params, x, *, cfg: ModelConfig, mesh):
    """x: this rank's rows [b, S, d] -> ([b, S, d], aux_losses dict), the
    output summed over ``model`` and the aux losses averaged over the dp
    axes (identical on every rank)."""
    e, f = cfg.num_experts, cfg.d_ff
    n = shd.mesh_sizes(mesh)["model"]
    shard = shd.coordinate(mesh)["model"]
    ep = e % n == 0                      # expert parallelism viable?
    if ep:
        w_gate, w_up, w_down = (_cut(params[k], 0, e, shard, n)
                                for k in ("w_gate", "w_up", "w_down"))
    elif f % n:
        raise ValueError(f"{e} experts and d_ff {f} both refuse a model axis of {n}")
    else:
        w_gate = _cut(params["w_gate"], 2, f, shard, n)
        w_up = _cut(params["w_up"], 2, f, shard, n)
        w_down = _cut(params["w_down"], 1, f, shard, n)
    e_loc = w_gate.shape[0]
    cap = capacity(cfg, x.shape[1])

    logits, probs, gate_vals, expert_idx, slot, dropped = route(params, x, cfg=cfg)
    local_e = expert_idx - shard * e_loc if ep else expert_idx   # this rank's range
    dropped = dropped | (local_e < 0) | (local_e >= e_loc)
    slot = torch.where(dropped, cap, slot)
    y = dispatch_combine(_EnterModel.apply(x, mesh), local_e.clamp(0, e_loc - 1), slot,
                         _EnterModel.apply(gate_vals, mesh), dropped, w_gate, w_up, w_down,
                         cap=cap)
    y = _SumModel.apply(y, mesh)

    lb, z = aux_losses(logits, probs, expert_idx, cfg=cfg)
    dp_axes = tuple(a for a in ("pod", "data") if a in shd.axis_names(mesh))
    if dp_axes:   # aux losses averaged over data shards -> replicated
        lb = _MeanOver.apply(lb, mesh, dp_axes)
        z = _MeanOver.apply(z, mesh, dp_axes)
    return y, {"moe_lb": lb * cfg.router_aux_coef, "moe_z": z * 1e-3}
