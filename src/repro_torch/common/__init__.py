"""Common infrastructure: parameter specs and pytree path utilities.

Every model exposes ``param_specs(cfg) -> dict[path, ParamSpec]``, a
shape-level description of its parameters (shape, dtype, logical axis
names, initializer).  From one spec table the port derives materialized
parameters (:func:`init_params`, from a seeded ``torch.Generator``) and
checks weights that arrive from the JAX package (:func:`params_from_numpy`).

``init_params`` follows the reference's init rules (``normal`` 0.02,
fan-in ``scaled``, ``ones``, ``zeros``) but cannot replay ``jax.random``:
the same seed gives other numbers.  Weights cross between the packages as
a flat ``{path: np.ndarray}`` tree, which :func:`params_from_numpy` turns
into tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import numpy as np
import torch

Path = tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Shape-level description of a single parameter tensor.

    ``axes`` names each dimension with a *logical* axis ("embed", "mlp",
    "heads", "vocab", "layers", ...), kept for the sharding rules of a later
    slice.  Parameters are stored in bf16 unless the spec says otherwise,
    whatever the activation dtype: the model casts each weight at use.
    """

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"  # normal | zeros | ones | scaled (fan-in)
    init_scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")

    def materialize(self, generator: torch.Generator) -> torch.Tensor:
        """The initial value, drawn on the generator's device."""
        dev = generator.device
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=self.dtype, device=dev)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=self.dtype, device=dev)
        if self.init == "normal":
            scale = self.init_scale * 0.02
        elif self.init == "scaled":  # fan-in scaled
            fan_in = self.shape[0] if len(self.shape) == 1 else int(np.prod(self.shape[:-1]))
            scale = self.init_scale / math.sqrt(max(fan_in, 1))
        else:
            raise ValueError(f"unknown init {self.init}")
        x = torch.randn(self.shape, generator=generator, device=dev, dtype=torch.float32)
        return x.mul_(scale).to(self.dtype)


SpecTree = dict[Path, ParamSpec]


def unflatten(flat: Mapping[Path, Any]) -> dict:
    """{(a,b,c): v} -> {a: {b: {c: v}}}."""
    out: dict = {}
    for path, value in flat.items():
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = value
    return out


def flatten(tree: Mapping, prefix: Path = ()) -> dict[Path, Any]:
    out: dict[Path, Any] = {}
    for k, v in tree.items():
        p = prefix + (k,)
        if isinstance(v, Mapping):
            out.update(flatten(v, p))
        else:
            out[p] = v
    return out


def init_params(specs: SpecTree, generator: torch.Generator) -> dict:
    """Materialize a spec table into a nested param dict on the generator's
    device, one draw per path in sorted order (deterministic per seed)."""
    return unflatten({p: specs[p].materialize(generator) for p in sorted(specs)})


def param_count(specs: SpecTree) -> int:
    return sum(int(np.prod(s.shape)) for s in specs.values())


def param_bytes(specs: SpecTree) -> int:
    return sum(int(np.prod(s.shape)) * s.dtype.itemsize for s in specs.values())


def _leaf_tensor(arr: np.ndarray) -> torch.Tensor:
    """A numpy leaf as a tensor of its own dtype, on a copy of its memory
    (a leaf from ``np.asarray`` of a JAX array is read-only).  A bf16 leaf
    is an ``ml_dtypes.bfloat16`` array, which ``torch.from_numpy`` refuses:
    its bits cross unchanged through int16."""
    arr = np.array(arr, order="C")
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_numpy(specs: SpecTree, flat: Mapping[Path, np.ndarray]) -> dict:
    """A flat ``{path: np.ndarray}`` tree (``repro.common.flatten`` of the JAX
    params, each leaf through ``np.asarray``) as the port's nested param
    dict on ``repro_torch.current_device()``.

    Every path, shape and dtype must match ``specs``; a missing or extra
    leaf raises."""
    from repro_torch.device import current_device
    device = current_device()
    missing = sorted(set(specs) - set(flat))
    extra = sorted(set(flat) - set(specs))
    if missing or extra:
        raise KeyError(f"params do not match the specs: missing {missing}, extra {extra}")
    out = {}
    for path, spec in specs.items():
        t = _leaf_tensor(np.asarray(flat[path]))
        if tuple(t.shape) != tuple(spec.shape):
            raise ValueError(f"{'/'.join(path)}: shape {tuple(t.shape)}, spec {spec.shape}")
        if t.dtype != spec.dtype:
            raise ValueError(f"{'/'.join(path)}: dtype {t.dtype}, spec {spec.dtype}")
        out[path] = t.to(device)
    return unflatten(out)
