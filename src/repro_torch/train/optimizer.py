"""AdamW with f32 master weights, global-norm clipping and cosine schedule.

The torch form of ``repro.train.optimizer``: the same state tree
(``{"step", "m", "v", "master"}``, nested dicts of tensors shaped like the
params), so a checkpoint of one package loads in the other, and the same
arithmetic.  The schedule and the bias corrections are f32 tensors, as the
reference's jnp values are; each leaf's update is f32.

Unlike the reference's pure functions, :func:`apply_updates` writes the new
params and state into the tensors it is given and returns them: at the
published widths a second copy of the master weights and moments would not
fit beside the first.  A large leaf is updated in slices along its first
axis, so the step's temporaries stay a few hundred MB whatever the leaf.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import DTYPES

_SLICE = 1 << 26   # elements of a leaf updated at a time


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # memory knobs for very large models
    state_dtype: str = "float32"     # dtype of m/v moments
    use_master: bool = True          # keep f32 master copy of params


def _map(fn, *trees):
    """``jax.tree.map`` over nested dicts of tensors."""
    return {k: _map(fn, *(t[k] for t in trees)) if isinstance(v, dict) else
            fn(*(t[k] for t in trees)) for k, v in trees[0].items()}


def _leaves(tree) -> list:
    """The leaves of a nested dict in the reference's order (sorted keys, as
    ``jax.tree.leaves`` walks a dict)."""
    out = []
    for k in sorted(tree):
        out += _leaves(tree[k]) if isinstance(tree[k], dict) else [tree[k]]
    return out


def lr_at(cfg: OptimizerConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor), an f32 tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.learning_rate * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.learning_rate * cos)


def init_state(params, cfg: OptimizerConfig | None = None) -> dict:
    sd = DTYPES[cfg.state_dtype] if cfg else torch.float32
    mk = lambda t: _map(lambda x: torch.zeros_like(x, dtype=sd), t)  # noqa: E731
    step = torch.zeros((), dtype=torch.int32, device=_leaves(params)[0].device)
    state = {"step": step, "m": mk(params), "v": mk(params)}
    if cfg is None or cfg.use_master:
        state["master"] = _map(lambda x: x.to(torch.float32, copy=True), params)
    return state


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares: each leaf's 2-norm in f32
    (``torch.linalg.vector_norm``, no f32 copy of a bf16 leaf), squared and
    summed in f32."""
    leaves = _leaves(tree)
    sq = [torch.linalg.vector_norm(l, dtype=torch.float32) ** 2 for l in leaves]
    return torch.sqrt(torch.stack(sq).sum())


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree, max_norm):
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return _map(lambda g: g * scale, tree), norm


def _slices(t: torch.Tensor) -> list[torch.Tensor]:
    """Views of ``t`` along its first axis of at most ``_SLICE`` elements each
    (``t`` itself when it is small or has one row)."""
    if t.dim() == 0 or t.numel() <= _SLICE or t.shape[0] == 1:
        return [t]
    rows = max(1, _SLICE // (t.numel() // t.shape[0]))
    return list(torch.split(t, rows))


def apply_updates(cfg: OptimizerConfig, params, state, grads):
    """One AdamW step, written into ``params`` and ``state`` in place.
    Returns (params, state, metrics) as the reference does; metrics are
    ``grad_norm`` and ``lr``, 0-dim f32 tensors on the params' device."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)
    sd = DTYPES[cfg.state_dtype]
    has_master = "master" in state

    def upd(m, v, g, w, p):
        g = g.to(torch.float32) * scale
        mf = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g
        vf = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * torch.square(g)
        mh = mf / b1c
        vh = vf / b2c
        wf = w.to(torch.float32)
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * wf
        wf = wf - lr * delta
        m.copy_(mf.to(sd))
        v.copy_(vf.to(sd))
        if has_master:
            w.copy_(wf)
        p.copy_(wf.to(p.dtype))

    flat_p = _leaves(params)
    flat_w = _leaves(state["master"]) if has_master else flat_p
    for m, v, g, w, p in zip(_leaves(state["m"]), _leaves(state["v"]), _leaves(grads), flat_w,
                             flat_p):
        for part in zip(*(_slices(t) for t in (m, v, g, w, p))):
            upd(*part)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


def state_specs(param_specs_tree: dict, cfg: OptimizerConfig | None = None) -> dict:
    """SpecTree for optimizer state given model ParamSpecs."""
    from repro_torch.common import ParamSpec
    cfg = cfg or OptimizerConfig()
    sd = DTYPES[cfg.state_dtype]
    out = {("step",): ParamSpec((), (), dtype=torch.int32, init="zeros")}
    names = ("m", "v") + (("master",) if cfg.use_master else ())
    for path, s in param_specs_tree.items():
        for name in names:
            dt = torch.float32 if name == "master" else sd
            out[(name,) + path] = ParamSpec(s.shape, s.axes, dtype=dt, init="zeros")
    return out
