"""Cost counter over the aten ops a step executes: the port's counterpart of
the reference's walk over optimized HLO text (same module name, same
``Costs``).

The reference compiles a step and walks its HLO call graph.  Eager PyTorch
has no compiled program to walk: the step runs under :class:`CostMode`, a
``TorchDispatchMode`` that sees every aten op as it executes, on ``meta``
tensors for a dry run (shapes and dtypes, no storage and no computation)
or on the card.

  * FLOPs: every matrix product and convolution at 2 * result *
    contraction, the reference's ``_dot_flops`` (the formulas of
    ``torch.utils.flop_counter``'s registry, a counting table).  A Python
    loop over layers, microbatches, chunks or tokens runs op by op, so
    every iteration is counted: there is no loop trip count to recover.
  * HBM bytes: one kernel per executed op, which is how eager PyTorch runs
    on the card: each op reads its tensor operands once and writes its
    results once.  Views and aliases (the op schema's alias info, or
    results that share their operands' storage) and factories that write
    nothing (``empty``) are free, as the reference's ``_SKIP_BYTES``; a
    fill writes its result and reads nothing; a gather (``index``,
    ``index_select``, ``gather``, ``embedding``) reads the rows it returns
    and its indices, not its source.  In-place slice writes
    (``copy_``, ``index_put_``, ``index_copy_``, ``scatter_``,
    ``slice_scatter``, ...) count twice the updated bytes, not the buffer,
    as the reference's dynamic-update-slice rule: every decode step's KV
    cache write goes through them.
  * bf16 -> f32 casts: the reference leaves them out on XLA:CPU as an
    artifact of the host (``_is_pure_upcast``).  On the H100 they run (the
    LM head's f32 products cast both operands), so they stay in ``bytes``
    and are also reported apart as ``upcast_bytes``.
  * Collective bytes: operand bytes of each c10d collective, by the
    reference's kinds and wire factors (x2 for all-reduce); ``broadcast``,
    which carries the port's gathers over gloo, has a key of its own.
  * The hand-written kernels are ctypes calls that no dispatch mode sees:
    each launch charges its module's ``cost()`` (the FLOPs and bytes its
    bound counts) through ``kernels._build.cost_counter``.
  * Scopes: ``attn_core``, ``moe_ffn`` and ``ssd_core``
    (``common.scopes``), forward and backward, kernels included.
  * Memory: the counterpart of ``memory_analysis``: ``argument`` (the
    call's input storages), ``output`` (its result's), ``alias`` (result
    storages that are inputs: the train step updates params and optimizer
    state in place where the reference donates them), ``temp`` (the
    highest sum of live storages the call created, less the result's new
    ones; tracked by ``weakref.finalize`` on each new storage) and
    ``peak = argument + output + temp - alias``.

Shapes on a rank are local, so all numbers are per device.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.common import scopes
from repro_torch.kernels import _build

_WIRE_FACTOR = {"all-gather": 1.0, "reduce-scatter": 1.0, "all-reduce": 2.0,
                "all-to-all": 1.0, "collective-permute": 1.0, "broadcast": 1.0}
# c10d op -> (kind, index of the argument that holds the operand)
_C10D = {
    "allreduce_": ("all-reduce", 0),
    "allgather_": ("all-gather", 1), "_allgather_base_": ("all-gather", 1),
    "reduce_scatter_": ("reduce-scatter", 1), "_reduce_scatter_base_": ("reduce-scatter", 1),
    "alltoall_": ("all-to-all", 1), "alltoall_base_": ("all-to-all", 1),
    "send": ("collective-permute", 0), "broadcast_": ("broadcast", 0),
}
# the functional collectives a DTensor's redistribution issues: op -> kind
_FUNCTIONAL = {"all_reduce": "all-reduce", "all_gather_into_tensor": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_to_all_single": "all-to-all", "broadcast": "broadcast"}

_aten = torch.ops.aten
_FREE = {_aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
         _aten.new_empty_strided, _aten.empty_permuted}
_FILLS = {_aten.fill_, _aten.zero_}
_GATHERS = {_aten.index, _aten.index_select, _aten.gather, _aten.embedding}
_UPCAST_FROM = (torch.bfloat16, torch.float16)


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of ``tree``, a ``DTensor`` as this rank's local shard."""
    return _local(tree_flatten(tree)[0])


def _local(leaves) -> list[torch.Tensor]:
    return [t._local_tensor if isinstance(t, DTensor) else t
            for t in leaves if isinstance(t, torch.Tensor)]


def _nbytes(tree) -> int:
    return sum(tensor_bytes(t) for t in _tensors(tree))


def _storage_key(t: torch.Tensor):
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):   # a tensor without a storage
        return None


def _storages(tree) -> dict:
    """{storage key: bytes} of every tensor in ``tree``, each storage once."""
    out = {}
    for t in _tensors(tree):
        key = _storage_key(t)
        if key is not None:
            out[key] = t.untyped_storage().nbytes()
    return out


def _updated_bytes(func, args, out) -> float | None:
    """Twice the updated bytes of an in-place slice write (read and write of
    the slice, as the reference's dynamic-update-slice rule), a gather's rows
    read and written, or None for any other op."""
    packet = func.overloadpacket
    if packet is _aten.copy_:
        return float(tensor_bytes(args[1]) + tensor_bytes(args[0]))
    if packet is _aten.index_put_:
        self, indices = args[0], args[1]
        idx = [i for i in indices if i is not None]
        if not idx or any(i.dtype == torch.bool for i in idx):
            return None
        n = torch.broadcast_shapes(*[i.shape for i in idx]).numel()
        for d in range(self.dim()):
            if d >= len(indices) or indices[d] is None:
                n *= self.shape[d]
        return 2.0 * n * self.element_size()
    if packet in _GATHERS:
        # a gather reads the rows it returns (and its indices), not the source
        return float(2 * _nbytes(out) + sum(
            _nbytes(a) for a in args[1:] if isinstance(a, (torch.Tensor, list, tuple))))
    if packet is _aten.index_copy_:
        return 2.0 * tensor_bytes(args[3])
    if packet is _aten.scatter_:
        return 2.0 * args[2].numel() * args[0].element_size()
    if packet is _aten.slice_scatter:
        return 2.0 * tensor_bytes(args[1])
    return None


def _mutated(func, args, kwargs) -> list:
    """The arguments an in-place or ``out=`` op writes."""
    out = []
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is not None and a.alias_info.is_write:
            out.append(args[i] if i < len(args) else kwargs.get(a.name))
    return out


_MUTATION: dict = {}


def _is_mutation(func) -> bool:
    m = _MUTATION.get(func)
    if m is None:
        m = _MUTATION[func] = any(a.alias_info is not None and a.alias_info.is_write
                                  for a in func._schema.arguments)
    return m


@dataclasses.dataclass
class Costs:
    flops: float = 0.0
    bytes: float = 0.0
    upcast_bytes: float = 0.0       # bf16/f16 -> f32 casts, also in ``bytes``
    coll: dict[str, float] = dataclasses.field(default_factory=dict)
    # per named-scope (flops, bytes) attribution
    scopes: dict[str, list] = dataclasses.field(default_factory=dict)
    # per hand-written kernel: [launches, flops, bytes]
    kernels: dict[str, list] = dataclasses.field(default_factory=dict)
    memory: dict[str, float] = dataclasses.field(default_factory=dict)
    # with ``analyze(..., rows=True)``: (op, shapes, scope) -> [count, flops, bytes]
    rows: dict | None = None

    def add(self, other: "Costs", mult: float = 1.0) -> None:
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        self.upcast_bytes += other.upcast_bytes * mult
        for k, v in other.coll.items():
            self.coll[k] = self.coll.get(k, 0.0) + v * mult
        for k, (f, b) in other.scopes.items():
            cur = self.scopes.setdefault(k, [0.0, 0.0])
            cur[0] += f * mult
            cur[1] += b * mult
        for k, (n, f, b) in other.kernels.items():
            cur = self.kernels.setdefault(k, [0, 0.0, 0.0])
            cur[0] += n
            cur[1] += f * mult
            cur[2] += b * mult

    def tag(self, scope: str | None, flops: float, byts: float) -> None:
        if scope:
            cur = self.scopes.setdefault(scope, [0.0, 0.0])
            cur[0] += flops
            cur[1] += byts


def _shapes(args) -> str:
    return ", ".join(f"{str(t.dtype).removeprefix('torch.')}{list(t.shape)}"
                     for t in _tensors(args))


class CostMode(TorchDispatchMode):
    """Counts every aten op executed under it (see the module docstring)
    into ``self.costs``; with ``rows`` it also keeps ``self.rows``, the
    identical (op, shapes, scope) calls grouped as [count, flops, bytes].
    Memory: :meth:`watch` names the call's inputs, :meth:`memory` reads the
    record after the call."""

    def __init__(self, *, rows: bool = False):
        super().__init__()
        self.costs = Costs()
        self.rows: dict | None = {} if rows else None
        self._args: dict = {}
        self._live: dict = {}
        self._cur = 0
        self._peak = 0
        self._saved = None

    # -- memory ------------------------------------------------------------
    def watch(self, *inputs) -> None:
        """Record the storages of the call's inputs (``argument``)."""
        self._args.update(_storages(inputs))

    def _freed(self, key) -> None:
        self._cur -= self._live.pop(key, 0)

    def _track(self, outs: list) -> None:
        for t in outs:
            key = _storage_key(t)
            if key is None or key in self._live or key in self._args:
                continue
            st = t.untyped_storage()
            n = st.nbytes()
            self._live[key] = n
            self._cur += n
            self._peak = max(self._peak, self._cur)
            weakref.finalize(st, self._freed, key)

    def memory(self, result) -> dict[str, float]:
        outs = _storages(result)
        argument = float(sum(self._args.values()))
        output = float(sum(outs.values()))
        alias = float(sum(n for k, n in outs.items() if k in self._args))
        created = sum(n for k, n in outs.items() if k in self._live)
        temp = float(max(self._peak - created, 0))
        return {"argument": argument, "output": output, "temp": temp, "alias": alias,
                "peak": argument + output + temp - alias}

    # -- counting ----------------------------------------------------------
    def _add(self, op: str, tensors: list, flops: float, nbytes: float) -> None:
        scope = scopes.current()
        c = self.costs
        c.flops += flops
        c.bytes += nbytes
        c.tag(scope, flops, nbytes)
        if self.rows is not None:
            row = self.rows.setdefault((op, _shapes(tensors), scope or ""), [0, 0.0, 0.0])
            row[0] += 1
            row[1] += flops
            row[2] += nbytes

    def charge(self, kernel: str, cost) -> None:
        """A hand-written kernel's launch (``kernels._build.cost_counter``):
        ``cost()`` -> (FLOPs, bytes), evaluated with this mode off (it may
        read the launch's data, such as ``decode_attention``'s lens, which is
        no work of the step)."""
        with _disable_current_modes():
            flops, nbytes = cost()
        self._add(f"kernel:{kernel}", [], flops, nbytes)
        cur = self.costs.kernels.setdefault(kernel, [0, 0.0, 0.0])
        cur[0] += 1
        cur[1] += flops
        cur[2] += nbytes

    def _collective(self, func, args, out) -> bool:
        ns, name = func.namespace, func.__name__.split(".")[0]
        if ns == "c10d" and name in _C10D:
            kind, i = _C10D[name]
            operand = _nbytes(args[i])
            moved = _nbytes(args)
        elif ns == "_c10d_functional" and name in _FUNCTIONAL:
            kind = _FUNCTIONAL[name]
            operand = _nbytes(args[0])
            moved = operand + _nbytes(out)
        else:
            return ns in ("c10d", "_c10d_functional")     # barriers, waits: free
        self.costs.coll[kind] = self.costs.coll.get(kind, 0.0) + operand * _WIRE_FACTOR[kind]
        self._add(func.__name__, _tensors(args), 0.0, float(moved))
        return True

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented    # DTensor runs it as ops on its local shards, counted
        if any(issubclass(t, FakeTensor) for t in types):
            return func(*args, **kwargs)    # DTensor's sharding propagation: no work
        out = func(*args, **kwargs)
        flat_out = tree_flatten(out)[0]
        if any(isinstance(t, FakeTensor) for t in flat_out):
            return out                      # its fake inputs, made from no tensor
        if self._collective(func, args, out):
            return out
        packet = func.overloadpacket
        outs = _local(flat_out)
        if packet in _FREE:
            self._track(outs)
            return out
        ins = _tensors((args, kwargs))
        in_keys = {_storage_key(t) for t in ins}
        mutation = _is_mutation(func)
        if not mutation and outs and all(_storage_key(t) in in_keys for t in outs):
            return out                                   # a view or an alias
        self._track(outs)
        flops = 0.0
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs, out_val=out))
        nbytes = _updated_bytes(func, args, out)
        if nbytes is None:
            if packet in _FILLS:
                nbytes = float(_nbytes(args[0]))
            else:
                read = sum(tensor_bytes(t) for t in ins)
                # in place: the operands are read, the mutated ones written
                written = _nbytes(_mutated(func, args, kwargs)) if mutation \
                    else sum(tensor_bytes(t) for t in outs)
                nbytes = float(read + written)
        if self._is_upcast(func, args, out):
            self.costs.upcast_bytes += nbytes
        self._add(str(packet).removeprefix("aten."), ins, flops, nbytes)
        return out

    @staticmethod
    def _is_upcast(func, args, out) -> bool:
        packet = func.overloadpacket
        if packet is _aten._to_copy:
            return (isinstance(out, torch.Tensor) and out.dtype == torch.float32
                    and args[0].dtype in _UPCAST_FROM)
        if packet is _aten.copy_:
            return args[0].dtype == torch.float32 and args[1].dtype in _UPCAST_FROM
        return False

    def __enter__(self):
        self._saved = (scopes.ACTIVE, _build.cost_counter)
        scopes.reset()
        scopes.ACTIVE = True
        _build.cost_counter = self.charge
        return super().__enter__()

    def __exit__(self, *exc):
        scopes.ACTIVE, _build.cost_counter = self._saved
        scopes.reset()
        return super().__exit__(*exc)


def analyze(fn, *args, rows: bool = False, flop_counter: bool = False, **kwargs) -> Costs:
    """Run ``fn(*args, **kwargs)`` under a :class:`CostMode` and return its
    costs (the counterpart of the reference's ``analyze_text``), memory
    included.  With ``flop_counter`` the call also runs under
    ``torch.utils.flop_counter.FlopCounterMode``, whose total lands in
    ``costs.memory["flop_counter_flops"]``; with ``rows`` the grouped rows
    are in ``costs.rows``."""
    mode = CostMode(rows=rows)
    mode.watch(args, kwargs)
    fc = FlopCounterMode(display=False) if flop_counter else None
    if fc is not None:
        fc.__enter__()
    try:
        with mode:
            result = fn(*args, **kwargs)
        costs = mode.costs
        costs.coll["total"] = sum(costs.coll.values())
        costs.memory = mode.memory(result)
    finally:
        if fc is not None:
            fc.__exit__(None, None, None)
    if fc is not None:
        costs.memory["flop_counter_flops"] = float(fc.get_total_flops())
    costs.memory["upcast_bytes"] = costs.upcast_bytes
    costs.rows = mode.rows
    del result
    return costs
