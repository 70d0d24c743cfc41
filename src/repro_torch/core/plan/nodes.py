"""Logical plan IR: one dataclass per semantic operator.

Nodes are cheap immutable-ish descriptions (langex + knobs + child nodes);
they carry *no* execution state.  Rewrites produce new nodes with
``dataclasses.replace``.  ``columns()`` propagates the static schema the same
way the eager ``SemFrame`` does (joins prefix right columns with ``right_``),
which is what the pushdown rule reasons over.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

from repro_torch.core.langex import Langex, as_langex


@dataclasses.dataclass
class LogicalNode:
    """Base: children are the dataclass fields holding LogicalNodes."""

    def children(self) -> list["LogicalNode"]:
        return [v for f in dataclasses.fields(self)
                if isinstance(v := getattr(self, f.name), LogicalNode)]

    def replace_children(self, mapping: dict[int, "LogicalNode"]) -> "LogicalNode":
        """New node with children swapped (keyed by id of the old child)."""
        kw = {f.name: mapping[id(v)]
              for f in dataclasses.fields(self)
              if isinstance(v := getattr(self, f.name), LogicalNode) and id(v) in mapping}
        return dataclasses.replace(self, **kw) if kw else self

    def columns(self) -> set[str]:
        raise NotImplementedError

    def label(self) -> str:
        return type(self).__name__


def _lx(langex) -> Langex:
    return as_langex(langex)


@dataclasses.dataclass
class Scan(LogicalNode):
    records: Sequence[dict]

    def columns(self) -> set[str]:
        return set(self.records[0].keys()) if self.records else set()

    def label(self) -> str:
        return f"Scan[n={len(self.records)}]"


@dataclasses.dataclass
class StreamScan(LogicalNode):
    """Leaf over a versioned ``repro_torch.stream.table.CorpusTable``.

    ``version=None`` floats with the table (resolved at each access);
    a pinned version is a reproducible snapshot — the serving gateway pins
    every StreamScan at run start so one pipeline never sees two versions,
    and subscriptions pin each re-execution to the commit that triggered it.
    """

    table: Any
    version: int | None = None

    @property
    def records(self) -> list[dict]:
        return self.table.snapshot(self.version)

    def columns(self) -> set[str]:
        return self.table.schema()

    def label(self) -> str:
        v = self.version if self.version is not None else self.table.version
        return (f"StreamScan[{self.table.table_id}@v{v}, "
                f"n={self.table.count(self.version)}]")


@dataclasses.dataclass
class Partition(LogicalNode):
    """Fragment source: split the child's rows into ``n_partitions``.

    Strategies:
      * ``contiguous`` — near-equal contiguous row ranges (the row-parallel
        default; order-preserving, so a gather is a plain concat);
      * ``subtree``    — contiguous ranges aligned to the consuming Agg's
        reduction-tree boundaries (``fanout ** (depth-1)`` leaves per
        partition), which makes the partition-local reduce subtrees exactly
        the root's child subtrees — record-identical by construction;
      * ``hash``       — rows keyed by ``key`` hash to a partition, so every
        group of a group-by lands whole in one fragment;
      * ``range``      — rows sorted by ``key`` then cut into contiguous
        runs (order statistics stay partition-local).

    Semantically transparent: an executor that ignores partitioning may run
    the child unsplit and produce identical results.
    """

    child: LogicalNode
    n_partitions: int
    strategy: str = "contiguous"
    key: str | None = None

    def columns(self) -> set[str]:
        return self.child.columns()

    def label(self) -> str:
        key = f", key={self.key}" if self.key else ""
        return f"Partition[{self.strategy}, P={self.n_partitions}{key}]"


@dataclasses.dataclass
class Exchange(LogicalNode):
    """Data-movement boundary between plan fragments.

    ``kind`` is the exchange the boundary performs:
      * ``gather``    — merge fragment outputs back into one stream (concat
        for row-parallel operators; operator-specific lossless merges for
        top-k / hierarchical aggregation);
      * ``broadcast`` — replicate the child to every fragment of the
        consuming operator (the small side of a join, a shared right-side
        retrieval index);
      * ``hash`` / ``range`` — repartition rows by key between fragments.

    Like :class:`Partition`, a partition-unaware executor may treat it as a
    no-op wrapper — the plan's results do not depend on fragmentation.
    """

    child: LogicalNode
    kind: str = "gather"
    n_partitions: int = 1

    def columns(self) -> set[str]:
        return self.child.columns()

    def label(self) -> str:
        return f"Exchange[{self.kind}, P={self.n_partitions}]"


def plain(node: LogicalNode) -> LogicalNode:
    """Strip Partition/Exchange wrappers (the underlying data-defining node:
    what corpus identity, stream-scan checks, and schema logic care about)."""
    while isinstance(node, (Partition, Exchange)):
        node = node.child
    return node


@dataclasses.dataclass
class Filter(LogicalNode):
    child: LogicalNode
    langex: Langex
    recall_target: float | None = None
    precision_target: float | None = None
    delta: float | None = None
    selectivity: float | None = None  # estimate installed by the optimizer

    def __post_init__(self):
        self.langex = _lx(self.langex)

    @property
    def is_cascade(self) -> bool:
        return self.recall_target is not None or self.precision_target is not None

    def columns(self) -> set[str]:
        return self.child.columns()

    def label(self) -> str:
        sel = f", sel~{self.selectivity:.2f}" if self.selectivity is not None else ""
        mode = "cascade" if self.is_cascade else "gold"
        return f"Filter[{mode}{sel}] {self.langex.template!r}"


@dataclasses.dataclass
class Join(LogicalNode):
    left: LogicalNode
    right: LogicalNode
    langex: Langex
    recall_target: float | None = None
    precision_target: float | None = None
    delta: float | None = None
    project_fn: Callable | None = None
    force_plan: str | None = None
    prefilter_k: int | None = None  # sim-join candidate prefilter (optimizer)
    selectivity: float | None = None  # pair-grid match rate (stats feedback)
    # fast-join strategy: None = today's dispatch (cascade iff targets set),
    # "cascade" = force the pairwise cascade, "block" = IVF blocking +
    # block prompts + transitivity inference, "auto" = let the optimizer's
    # cost model pick ("block" vs "cascade")
    strategy: str | None = None
    strategy_auto: bool = False  # strategy chosen by the optimizer, so the
                                 # adaptive executor may re-choose at run time

    def __post_init__(self):
        self.langex = _lx(self.langex)

    @property
    def is_cascade(self) -> bool:
        return self.recall_target is not None or self.precision_target is not None

    def columns(self) -> set[str]:
        return self.left.columns() | {f"right_{c}" for c in self.right.columns()}

    def label(self) -> str:
        mode = self.strategy or ("cascade" if self.is_cascade else "gold")
        pf = f", prefilter_k={self.prefilter_k}" if self.prefilter_k else ""
        sel = f", sel~{self.selectivity:.3f}" if self.selectivity is not None else ""
        return f"Join[{mode}{pf}{sel}] {self.langex.template!r}"


@dataclasses.dataclass
class TopK(LogicalNode):
    child: LogicalNode
    langex: Langex
    k: int
    algorithm: str = "quickselect"
    pivot_query: str | None = None
    group_by: str | None = None

    def __post_init__(self):
        self.langex = _lx(self.langex)

    def columns(self) -> set[str]:
        return self.child.columns()

    def label(self) -> str:
        return f"TopK[k={self.k}, {self.algorithm}] {self.langex.template!r}"


@dataclasses.dataclass
class Agg(LogicalNode):
    child: LogicalNode
    langex: Langex
    fanout: int = 8
    group_by: str | None = None
    partitioner: Callable | None = None
    out_column: str = "aggregate"

    def __post_init__(self):
        self.langex = _lx(self.langex)

    def columns(self) -> set[str]:
        cols = {self.out_column}
        if self.group_by is not None:
            cols.add(self.group_by)
        return cols

    def label(self) -> str:
        return f"Agg[fanout={self.fanout}] {self.langex.template!r}"


@dataclasses.dataclass
class GroupBy(LogicalNode):
    child: LogicalNode
    langex: Langex
    C: int
    accuracy_target: float | None = None
    delta: float | None = None

    def __post_init__(self):
        self.langex = _lx(self.langex)

    def columns(self) -> set[str]:
        return self.child.columns() | {"group", "group_label"}

    def label(self) -> str:
        return f"GroupBy[C={self.C}] {self.langex.template!r}"


@dataclasses.dataclass
class Map(LogicalNode):
    child: LogicalNode
    langex: Langex
    out_column: str = "mapped"

    def __post_init__(self):
        self.langex = _lx(self.langex)

    def columns(self) -> set[str]:
        return self.child.columns() | {self.out_column}

    def label(self) -> str:
        return f"Map[->{self.out_column}] {self.langex.template!r}"


@dataclasses.dataclass
class FusedMap(LogicalNode):
    """N sem_maps over the same input collapsed into one prompt pass."""

    child: LogicalNode
    langexes: tuple[Langex, ...]
    out_columns: tuple[str, ...]

    def __post_init__(self):
        self.langexes = tuple(_lx(l) for l in self.langexes)
        assert len(self.langexes) == len(self.out_columns)

    def columns(self) -> set[str]:
        return self.child.columns() | set(self.out_columns)

    def label(self) -> str:
        return f"FusedMap[->{','.join(self.out_columns)}] x{len(self.langexes)}"


@dataclasses.dataclass
class Extract(LogicalNode):
    child: LogicalNode
    langex: Langex
    source_field: str
    out_column: str = "extracted"

    def __post_init__(self):
        self.langex = _lx(self.langex)

    def columns(self) -> set[str]:
        return self.child.columns() | {self.out_column}

    def label(self) -> str:
        return f"Extract[{self.source_field}->{self.out_column}] {self.langex.template!r}"


def _index_tag(index_kind: str, nprobe, shards=None, quantize=None) -> str:
    out = ""
    if index_kind == "ivf":
        tag = "ivf-int8" if quantize == "int8" else "ivf"
        out = f", {tag}(nprobe={nprobe})" if nprobe else f", {tag}"
    elif index_kind != "auto":
        out = f", {index_kind}"
    if shards:
        out += f", shards={shards}"
    return out


@dataclasses.dataclass
class Search(LogicalNode):
    child: LogicalNode
    column: str
    query: str
    k: int = 10
    n_rerank: int = 0
    rerank_langex: Any = None
    index: Any = None
    index_kind: str = "auto"   # "exact" | "ivf" | "auto" (optimizer decides)
    nprobe: int | None = None  # IVF recall knob, installed by the optimizer
    shards: int | None = None  # device-shard layout, installed by the optimizer
    quantize: str | None = None  # IVF tile precision ("none"|"int8"), rule 5
    # True when rule 5 chose index_kind from a cardinality *estimate* (vs a
    # user pin): only then may the adaptive executor re-choose at run time
    index_auto: bool = False

    def columns(self) -> set[str]:
        return self.child.columns()

    def label(self) -> str:
        return (f"Search[k={self.k}"
                f"{_index_tag(self.index_kind, self.nprobe, self.shards, self.quantize)}] "
                f"{self.column}~{self.query!r}")


@dataclasses.dataclass
class SimJoin(LogicalNode):
    left: LogicalNode
    right: LogicalNode
    left_col: str
    right_col: str
    k: int = 1
    index_kind: str = "auto"
    nprobe: int | None = None
    shards: int | None = None
    quantize: str | None = None
    index_auto: bool = False   # kind chosen from an estimate (see Search)

    def columns(self) -> set[str]:
        return (self.left.columns()
                | {f"right_{c}" for c in self.right.columns()} | {"sim_score"})

    def label(self) -> str:
        return (f"SimJoin[k={self.k}"
                f"{_index_tag(self.index_kind, self.nprobe, self.shards, self.quantize)}] "
                f"{self.left_col}~{self.right_col}")
