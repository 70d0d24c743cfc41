"""Lazy logical-plan layer for semantic operators (paper §2: "each operator
opens a rich space for execution plans, similar to relational operators").

Four pieces:

  * ``nodes``    — the logical IR (Scan/Filter/Join/TopK/Agg/GroupBy/Map/
                   FusedMap/Extract/Search/SimJoin dataclasses forming a DAG,
                   plus the Partition/Exchange fragment boundaries);
  * ``optimize`` — rule-based rewrites over the DAG (filter reordering by
                   cost x selectivity, filter pushdown below joins, map
                   fusion, sim-join prefilters under high-fanout joins,
                   cost-based retrieval choice, partition planning);
  * ``execute``  — the batched physical executor: walks the optimized DAG,
                   dispatches to the gold/cascade operator implementations,
                   and routes all model traffic through ``BatchedModelCache``
                   (prompt dedup + LRU memoization across pipeline stages).
                   ``PartitionedExecutor`` additionally runs Exchange-bounded
                   plan fragments over row partitions (``plan.parallel``)
                   with guarantee-preserving merge semantics;
  * ``parallel`` — the partitioned operator implementations + fragment
                   scheduling;
  * ``adaptive`` — :class:`AdaptivePlanExecutor`, mid-query re-optimization:
                   filter chains re-ranked on live blended selectivities,
                   retrieval re-chosen on observed corpus size, fragments
                   re-sized on observed row counts — record-identical by the
                   strict-mode equivalence contract.

``SemFrame.lazy()`` is the entry point; the default eager path builds the
same single-node plans and executes them immediately (identical behavior and
stats to the pre-plan-layer code).
"""
from repro_torch.core.plan.adaptive import (AdaptivePlanExecutor, AdaptivePolicy,
                                            adaptive_default)
from repro_torch.core.plan.cache import BatchedModelCache
from repro_torch.core.plan.execute import PartitionedExecutor, PlanExecutor
from repro_torch.core.plan.nodes import (Agg, Exchange, Extract, Filter, FusedMap,
                                         GroupBy, Join, LogicalNode, Map, Partition,
                                         Scan, Search, SimJoin, TopK)
from repro_torch.core.plan.optimize import PlanOptimizer, explain_plan

__all__ = [
    "AdaptivePlanExecutor", "AdaptivePolicy", "Agg", "BatchedModelCache",
    "Exchange", "Extract", "Filter", "FusedMap", "GroupBy", "Join",
    "LogicalNode", "Map", "Partition", "PartitionedExecutor", "PlanExecutor",
    "PlanOptimizer", "Scan", "Search", "SimJoin", "TopK", "adaptive_default",
    "explain_plan",
]
