"""Logical-axis -> mesh-axis sharding rules, and each rank's shard of them.

Models name every tensor dimension with a *logical* axis ("embed_in",
"kv_heads", "batch", ...; see ``repro_torch.common.ParamSpec``).  A rule
table maps each logical axis to an ordered tuple of *candidate* mesh axes,
and :func:`resolve_pspec` turns (shape, logical axes, mesh, rules) into a
concrete :class:`P` under the reference's two invariants:

  * divisibility fallback: a mesh axis is only taken while the accumulated
    shard count divides the dimension size (a 6-head tensor on a 4-wide
    ``model`` axis stays replicated rather than erroring);
  * each mesh axis is used at most once per spec, first dimension wins
    (``batch`` grabbing ``data`` leaves ``kv_seq`` only ``model``).

Resolution needs no devices: :func:`abstract_mesh` and a torch
``DeviceMesh`` both answer the axis names and sizes.

The reference is single-controller (one process, ``jax.jit`` over every
device); the port is multi-controller: one process per rank holds its
*local shard* of every sharded tensor, the slice that the resolved spec
gives its coordinates on the mesh.  A tuple entry is major to minor, as in
JAX: ``P(None, ("data", "model"))`` splits along ``data`` first.
:class:`NamedSharding` places a whole tensor as this rank's shard, gathers
the shards back into the whole, and gives the matching ``DTensor``
placements.  Each ``pmax``/``psum``/``pmean`` of the reference becomes an
``all_reduce`` over the process group of its mesh axes (:func:`axis_group`,
one group per mesh and axis tuple, built once).  The library calls only
``all_reduce`` (SUM, MAX) and ``broadcast``, the collectives that gloo
carries for CUDA tensors as well as NCCL does; it never picks a backend,
and a collective that the backend refuses raises.

``activation_rules`` installs a (mesh, rules) context consumed by
``shard_activation`` and by the context-parallel and sharded-MoE branches
inside model code; the models never mention mesh axes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import threading
import weakref
from typing import Mapping

import torch
import torch.distributed as dist

_ctx = threading.local()


# ---------------------------------------------------------------------------
# Rule tables (the reference's, verbatim)
# ---------------------------------------------------------------------------

# Logical axis -> ordered candidate mesh axes.  Missing / empty -> replicated.
_TRAIN_RULES = {
    # parameter axes: FSDP-style over "data", tensor-parallel over "model"
    "embed_in": ("data",),
    "embed_out": ("data",),
    "embed": ("data",),
    "vocab": ("model",),
    "mlp": ("model",),
    "mlp_out": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "experts": ("model",),
    "experts_in": ("data",),
    "layers": ("pod",),
    # activation axes
    "batch": ("pod", "data"),
    "seq_act": ("model",),
    "embed_act": ("model",),
    "kv_seq": ("data", "model"),
    "frames": (),
    "seq": (),
    "qkv": (),
    "qkv_in": (),
}

# Serving with weights replicated over "data" (throughput replicas); only the
# head-ish axes are tensor-parallel and the KV cache is context-parallel over
# "model" (kv_seq listed before kv_heads so the sequence dim wins the axis).
_SERVE_REPLICATED_RULES = {
    "vocab": ("model",),
    "mlp": ("model",),
    "mlp_out": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "experts": ("model",),
    "batch": ("pod", "data"),
    "kv_seq": ("model",),
    "seq_act": (),
    "embed_act": (),
}

RULE_TABLES: dict[str, dict[str, tuple[str, ...]]] = {
    "default": _TRAIN_RULES,
    "serve_replicated": _SERVE_REPLICATED_RULES,
}


def _rules_table(rules) -> dict:
    return RULE_TABLES[rules] if isinstance(rules, str) else rules


class P(tuple):
    """A partition spec: one entry per tensor dimension, each ``None``
    (replicated), a mesh axis name, or a tuple of them (major to minor).
    The port's own ``jax.sharding.PartitionSpec``; equal to the tuple of its
    entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry, major to minor."""
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes without devices, for rule resolution."""

    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def abstract_mesh(axis_sizes, axis_names) -> AbstractMesh:
    return AbstractMesh(tuple(axis_sizes), tuple(axis_names))


def axis_names(mesh) -> tuple[str, ...]:
    """The axis names of an :class:`AbstractMesh` or a ``DeviceMesh``."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def mesh_sizes(mesh) -> dict[str, int]:
    """{axis name: size}, major to minor."""
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return dict(shape)
    return dict(zip(axis_names(mesh), shape))


def coordinate(mesh) -> dict[str, int]:
    """This rank's coordinate on a ``DeviceMesh``, by axis name."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not on the mesh")
    return dict(zip(axis_names(mesh), coord))


def shard_index(mesh, axes) -> int:
    """This rank's index among the shards that ``axes`` (major to minor) cut."""
    sizes, coord = mesh_sizes(mesh), coordinate(mesh)
    idx = 0
    for a in entry_axes(axes):
        idx = idx * sizes[a] + coord[a]
    return idx


_GROUPS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def axis_group(mesh, axes):
    """The process group of this rank's ranks along ``axes`` (a name or a
    tuple): one group over the product of the axes.  Built once per mesh
    and axis tuple; building it is collective, so every rank of the world
    must reach the first call for a given (mesh, axes)."""
    axes = entry_axes(axes)
    names = axis_names(mesh)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    if sorted(axes) == sorted(names) and mesh.size() == dist.get_world_size():
        return dist.group.WORLD
    cache = _GROUPS.setdefault(mesh, {})
    if axes not in cache:
        ranks = mesh.mesh
        other = [names.index(a) for a in names if a not in axes]
        order = other + [names.index(a) for a in axes]
        width = math.prod(ranks.shape[names.index(a)] for a in axes)
        rows = ranks.permute(order).reshape(-1, width)
        cache[axes] = dist.new_subgroups_by_enumeration(rows.tolist())[0]
    return cache[axes]


def neighbour_groups(mesh, axis: str) -> list:
    """The two-rank groups (s, s + 1) along ``axis`` of this rank's row of
    the mesh, built once per mesh (every rank builds every row's groups, as
    ``new_group`` is collective)."""
    cache = _GROUPS.setdefault(mesh, {})
    key = ("neighbours", axis)
    if key not in cache:
        names = axis_names(mesh)
        d = names.index(axis)
        rows = mesh.mesh.movedim(d, -1).reshape(-1, mesh.mesh.shape[d]).tolist()
        for row in rows:
            groups = [dist.new_group([row[s], row[s + 1]]) for s in range(len(row) - 1)]
            if dist.get_rank() in row:
                cache[key] = groups
    return cache[key]


def all_reduce(x: torch.Tensor, mesh, axes, op: str = "sum") -> torch.Tensor:
    """``psum``/``pmax`` of the reference over ``axes``: an in-place
    ``all_reduce`` of ``x``, which is returned.  ``"mean"`` is a SUM then a
    division (gloo has no AVG)."""
    if not entry_axes(axes):
        return x
    red = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
    group = axis_group(mesh, axes)
    dist.all_reduce(x, op=red, group=group)
    if op == "mean":
        x.div_(dist.get_world_size(group))
    return x


# ---------------------------------------------------------------------------
# Resolution
# ---------------------------------------------------------------------------


def resolve_pspec(shape, axes, mesh, rules) -> P:
    """(shape, logical axes, mesh, rule table|name) -> P.

    Greedy per-dimension: walk each dimension's candidate mesh axes in rule
    order, taking an axis only if it exists on the mesh, is still unused in
    this spec, and the accumulated shard count keeps dividing the dimension.
    """
    table = _rules_table(rules)
    sizes = mesh_sizes(mesh)
    used: set[str] = set()
    entries = []
    for dim, ax in zip(shape, axes):
        taken: list[str] = []
        prod = 1
        for cand in table.get(ax, ()) if ax is not None else ():
            if cand not in sizes or cand in used:
                continue
            if dim % (prod * sizes[cand]) != 0:
                continue
            taken.append(cand)
            prod *= sizes[cand]
        used.update(taken)
        entries.append(None if not taken else taken[0] if len(taken) == 1 else tuple(taken))
    return P(*entries)


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A spec on a ``DeviceMesh``: which shard of a tensor each rank holds."""

    mesh: object
    spec: P

    def _counts(self) -> list[int]:
        sizes = mesh_sizes(self.mesh)
        return [math.prod(sizes[a] for a in entry_axes(e)) for e in self.spec]

    def shard_shape(self, shape) -> tuple[int, ...]:
        counts = self._counts() + [1] * (len(shape) - len(self.spec))
        for n, c in zip(shape, counts):
            if n % c:
                raise ValueError(f"{tuple(shape)} does not split by {self.spec}")
        return tuple(n // c for n, c in zip(shape, counts))

    def _slices(self, shape, coord: dict[str, int]) -> tuple[slice, ...]:
        sizes = mesh_sizes(self.mesh)
        local = self.shard_shape(shape)
        out = []
        for d, n in enumerate(local):
            idx = 0
            for a in entry_axes(self.spec[d]) if d < len(self.spec) else ():
                idx = idx * sizes[a] + coord[a]
            out.append(slice(idx * n, (idx + 1) * n))
        return tuple(out)

    def local_slices(self, shape) -> tuple[slice, ...]:
        """This rank's slice of a tensor of ``shape``."""
        return self._slices(shape, coordinate(self.mesh))

    def place(self, t, device=None) -> torch.Tensor:
        """This rank's shard of the whole tensor ``t`` (a tensor or a numpy
        array), copied onto ``device`` (default ``current_device()``)."""
        from repro_torch.device import current_device
        t = torch.as_tensor(t)
        return t[self.local_slices(t.shape)].to(device or current_device(), copy=True)

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor on every rank of the mesh, from each rank's shard
        ``local``: each distinct shard is broadcast by its first owner, so the
        bits are the owner's.  A replicated spec returns ``local`` itself."""
        sharded = {a for e in self.spec for a in entry_axes(e)}
        if not sharded:
            return local          # replicated: every rank holds the whole
        counts = self._counts()
        shape = tuple(n * c for n, c in zip(local.shape, counts))
        out = local.new_empty(shape)
        names = axis_names(self.mesh)
        group = axis_group(self.mesh, names)
        ranks = self.mesh.mesh
        for pos in itertools.product(*(range(n) for n in ranks.shape)):
            coord = dict(zip(names, pos))
            if any(coord[a] for a in names if a not in sharded):
                continue          # a replica: the first owner sends this shard
            src = int(ranks[tuple(pos)])
            buf = local.contiguous() if src == dist.get_rank() else local.new_empty(local.shape)
            dist.broadcast(buf, src=src, group=group)
            out[self._slices(shape, coord)] = buf
        return out

    @property
    def placements(self) -> tuple:
        """The ``DTensor`` placements, one per mesh dimension (mesh-major): a
        mesh axis named in entry ``d`` gives ``Shard(d)``.  A tuple entry must
        list its axes in mesh order, as ``DTensor`` splits a dimension that
        several mesh axes shard in that order."""
        from torch.distributed.tensor import Replicate, Shard
        names = axis_names(self.mesh)
        out = [Replicate()] * len(names)
        for d, e in enumerate(self.spec):
            axes = entry_axes(e)
            if list(axes) != sorted(axes, key=names.index):
                raise ValueError(f"{self.spec}: entry {e} is not in mesh order {names}")
            for a in axes:
                out[names.index(a)] = Shard(d)
        return tuple(out)

    def distribute(self, t, device=None):
        """A ``DTensor`` of the whole tensor ``t`` holding this rank's shard
        (no communication)."""
        t = torch.as_tensor(t)
        return self.dtensor(self.place(t, device), t.shape)

    def dtensor(self, local: torch.Tensor, shape):
        """A ``DTensor`` of global ``shape`` over this rank's shard ``local``
        (no communication; ``local`` is its storage)."""
        from torch.distributed.tensor import DTensor
        if tuple(local.shape) != self.shard_shape(shape):
            raise ValueError(f"shard {tuple(local.shape)} of {tuple(shape)} under {self.spec}")
        stride = tuple(math.prod(shape[d + 1:]) for d in range(len(shape)))
        return DTensor.from_local(local, self.mesh, self.placements, run_check=False,
                                  shape=torch.Size(shape), stride=stride)


def place_tree(tree, shardings, device=None) -> dict:
    """Each leaf of ``tree`` placed as this rank's shard under the matching
    leaf of ``shardings`` (a tree of the same paths)."""
    from repro_torch.common import flatten, unflatten
    flat, sh = flatten(tree), flatten(shardings)
    if set(flat) != set(sh):
        raise KeyError(f"tree and shardings differ: {sorted(set(flat) ^ set(sh))}")
    return unflatten({p: sh[p].place(v, device) for p, v in flat.items()})


def gather_tree(tree, shardings) -> dict:
    """The whole tensors back from each rank's shards (``NamedSharding.gather``)."""
    from repro_torch.common import flatten, unflatten
    sh = flatten(shardings)
    return unflatten({p: sh[p].gather(v) for p, v in flatten(tree).items()})


def spec_shardings(specs, mesh, rules="default"):
    """SpecTree {path: ParamSpec} -> nested tree of :class:`NamedSharding`."""
    from repro_torch.common import unflatten
    table = _rules_table(rules)
    return unflatten({
        path: NamedSharding(mesh, resolve_pspec(s.shape, s.axes, mesh, table))
        for path, s in specs.items()})


# ---------------------------------------------------------------------------
# Activation-sharding context
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def activation_rules(mesh, rules="default"):
    """Install (mesh, rules) for ``shard_activation`` and the model's mesh
    branches (context-parallel decode, sharded MoE)."""
    prev = getattr(_ctx, "cfg", None)
    _ctx.cfg = (mesh, _rules_table(rules))
    try:
        yield
    finally:
        _ctx.cfg = prev


def active_rules():
    """The installed (mesh, rule table), or None."""
    return getattr(_ctx, "cfg", None)


def model_rules():
    """The installed (mesh, rule table) when the mesh has a ``model`` axis,
    else None: the condition of the reference's mesh branches (context-
    parallel decode, the sharded MoE)."""
    ctx = active_rules()
    return ctx if ctx is not None and "model" in axis_names(ctx[0]) else None


def shard_activation(x, axes):
    """Sharding hint on an activation.  The identity on a plain tensor (each
    rank already holds its rows) and without rules; a ``DTensor`` is
    redistributed to the resolved placements."""
    ctx = active_rules()
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    spec = resolve_pspec(x.shape, axes, mesh, rules)
    return x.redistribute(mesh, NamedSharding(mesh, spec).placements)


@contextlib.contextmanager
def set_mesh(mesh):
    """Ambient-mesh context (the reference's ``jax.set_mesh``): while it is
    open, :func:`current_mesh` returns ``mesh``."""
    prev = getattr(_ctx, "mesh", None)
    _ctx.mesh = mesh
    try:
        yield mesh
    finally:
        _ctx.mesh = prev


def current_mesh():
    return getattr(_ctx, "mesh", None)
