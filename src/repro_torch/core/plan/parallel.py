"""Partitioned physical operators + fragment scheduling.

This is the execution side of the plan layer's ``Partition``/``Exchange``
nodes: every function here runs one operator over row partitions and merges
with semantics that *provably preserve* the single-partition output:

  * gold filter / map family — row-parallel fragments, gather = positional
    concat (prompts are per-row, so fragment outputs are the global outputs);
  * cascade filter — the proxy scores and the mid-region oracle labels are
    produced by per-partition fragments, but the importance sample, the
    learned (tau+, tau-) thresholds, and the decision rule stay GLOBAL: the
    cascade sees exactly the score vector and sample labels of the
    unpartitioned run, so thresholds — and the statistical guarantee — are
    bit-identical;
  * hierarchical agg — fragment boundaries align to the reduction tree's
    root subtrees (``fanout ** (depth-1)`` leaves each), so partition-local
    reduces are exactly the root's child subtrees and the one root reduce
    reproduces the unpartitioned tree prompt-for-prompt;
  * gold join — fragments tile the (left x right) pair space (broadcast:
    left partitions x full right; repartition: a fragment grid); each pair's
    prompt is unchanged, so the merged mask is the gold mask.

Top-k's per-partition quickselect + lossless merge lives with its algorithm
in ``repro_torch.core.operators.topk`` (``sem_topk_partitioned``).

``run_fragments`` is the scheduler seam: tasks run serially without a pool
(deterministic library mode) or concurrently on the caller's
``ThreadPoolExecutor`` (the serving gateway shares one across sessions).
Each fragment re-installs the coordinating thread's accounting context
(``accounting.capture``/``activate``) so per-partition model calls roll up
into the same operator block and serve-session scope.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import accounting
from repro_torch.core.langex import as_langex
from repro_torch.obs import audit as _audit
from repro_torch.obs import trace as _trace
from repro_torch.core.operators.agg import _agg_prompt
from repro_torch.core.operators.filter import predicate_prompt
from repro_torch.core.operators.join import _pair_prompts
from repro_torch.core.optimizer import cascades
from repro_torch.core.plan import nodes as N


# ---------------------------------------------------------------------------
# Fragment scheduling
# ---------------------------------------------------------------------------


def run_fragments(pool, tasks):
    """Run ``tasks`` (thunks) and return their results in order.

    ``pool=None`` runs serially on the calling thread.  With a pool, every
    task is wrapped to carry the submitting thread's accounting context so
    fragment model calls are attributed exactly like serial ones."""
    tasks = list(tasks)
    # annotate the owning operator span with the fan-out shape (fragment
    # spans themselves come from the per-fragment ``accounting.track``)
    sp = _trace.current_span()
    if sp is not None:
        sp.set(n_fragments=len(tasks),
               fragment_pooled=pool is not None and len(tasks) > 1)
    if pool is None or len(tasks) <= 1:
        return [t() for t in tasks]
    ctx = accounting.capture()

    def wrap(task):
        def run():
            with accounting.activate(ctx):
                return task()
        return run

    futures = [pool.submit(wrap(t)) for t in tasks]
    return [f.result() for f in futures]


# ---------------------------------------------------------------------------
# Partition splitters
# ---------------------------------------------------------------------------


def contiguous_partitions(n: int, n_partitions: int) -> list[np.ndarray]:
    """Near-equal contiguous index ranges (first ``n % P`` get the extra)."""
    P = max(1, min(n_partitions, n)) if n else 1
    bounds = np.linspace(0, n, P + 1).astype(int)
    return [np.arange(lo, hi) for lo, hi in zip(bounds, bounds[1:])]


def partition_count(n_rows: float, configured: int | None,
                    min_rows: int) -> int:
    """Fragments for an operator over ``n_rows`` rows: the configured count,
    gated by ``min_rows`` and capped so no fragment is empty.  One
    definition shared by the optimizer (estimated rows, plan time) and the
    adaptive executor (observed rows, run time), so a mid-query fragment
    resize is exactly the partitioning the planner would have chosen had it
    known the true cardinality — bit-identical output either way (the
    contiguous gather is a positional concat)."""
    if not configured or configured < 2 or n_rows < min_rows:
        return 1
    return max(1, min(int(configured), int(n_rows)))


def hash_partitions(records, n_partitions: int, key: str) -> list[np.ndarray]:
    """Rows bucketed by the group key's *equality class* (built-in ``hash``,
    under which 1, 1.0 and True coincide exactly as they do in the
    unpartitioned group dict) — every group lands whole in one partition,
    original order kept within each.  Assignment is stable within a process
    (string hashing is interpreter-seeded), which is all the
    partitioned-equals-unpartitioned contract needs.  Partitions may be
    empty."""
    P = max(1, n_partitions)
    buckets: list[list[int]] = [[] for _ in range(P)]
    for i, t in enumerate(records):
        buckets[hash(t[key]) % P].append(i)
    return [np.asarray(b, int) for b in buckets]


def range_partitions(records, n_partitions: int, key: str) -> list[np.ndarray]:
    """Rows sorted by ``record[key]`` then cut into contiguous runs: order
    statistics over the key stay partition-local.  Sorts on the native key
    value (numeric keys order numerically, not lexicographically), falling
    back to string order only for un-comparable mixed types.  No optimizer
    rule emits this strategy yet — it is IR surface for hand-built plans
    and future range-aware rewrites."""
    try:
        order = sorted(range(len(records)), key=lambda i: records[i][key])
    except TypeError:  # mixed/unorderable key types
        order = sorted(range(len(records)), key=lambda i: str(records[i][key]))
    parts = contiguous_partitions(len(records), n_partitions)
    order = np.asarray(order, int)
    return [order[p] for p in parts]


def subtree_partitions(n: int, fanout: int, n_partitions: int
                       ) -> list[np.ndarray]:
    """Contiguous ranges aligned to the hierarchical-reduce tree: with
    ``depth = ceil(log_fanout n)`` levels, each partition takes
    ``fanout ** (depth-1)`` consecutive leaves — exactly the leaves of one
    child subtree of the root, so partition-local reduces compose into the
    unpartitioned tree verbatim.  ``n_partitions`` caps nothing here (the
    alignment fixes the count, always <= fanout); it is accepted for
    interface symmetry."""
    del n_partitions
    if n <= 0:
        return [np.arange(0)]
    f = max(fanout, 2)
    if n <= f:  # single root group: the whole reduce is one prompt already
        return [np.arange(n)]
    depth = 1
    while f ** depth < n:
        depth += 1
    chunk = f ** (depth - 1)
    return [np.arange(lo, min(lo + chunk, n)) for lo in range(0, n, chunk)]


def split_partitions(records, part: "N.Partition", *,
                     fanout: int = 8) -> list[np.ndarray]:
    """Materialize a Partition node's strategy into index arrays."""
    if part.strategy == "contiguous":
        return contiguous_partitions(len(records), part.n_partitions)
    if part.strategy == "hash":
        return hash_partitions(records, part.n_partitions, part.key)
    if part.strategy == "range":
        return range_partitions(records, part.n_partitions, part.key)
    if part.strategy == "subtree":
        return subtree_partitions(len(records), fanout, part.n_partitions)
    raise ValueError(f"unknown partition strategy {part.strategy!r}")


def _fragment_sizes(parts) -> list[int]:
    return [int(len(p)) for p in parts]


# ---------------------------------------------------------------------------
# Filter
# ---------------------------------------------------------------------------


def sem_filter_gold_partitioned(records, langex, oracle, parts, pool
                                ) -> tuple[np.ndarray, dict]:
    """Row-parallel gold filter: one oracle fragment per partition; the
    gathered mask is positionally identical to the unpartitioned scan."""
    lx = as_langex(langex)
    with accounting.track("sem_filter_gold") as st:
        def frag(pi, idx):
            def task():
                with accounting.track(f"fragment[{pi}]"):
                    passed, _ = oracle.predicate(
                        [predicate_prompt(lx, records[i]) for i in idx])
                    return np.asarray(passed, bool)
            return task

        results = run_fragments(pool, [frag(pi, idx)
                                       for pi, idx in enumerate(parts)])
        mask = np.zeros(len(records), bool)
        for idx, sub in zip(parts, results):
            mask[idx] = sub
        st.details.update(n_partitions=len(parts),
                          partition_sizes=_fragment_sizes(parts))
        return mask, st.as_dict()


def sem_filter_cascade_partitioned(records, langex, oracle, proxy, parts,
                                   pool, *, recall_target: float = 0.9,
                                   precision_target: float = 0.9,
                                   delta: float = 0.2, sample_size: int = 100,
                                   seed: int = 0) -> tuple[np.ndarray, dict]:
    """Partitioned Algorithm 1 with the calibration kept global.

    Fragments do the *scoring work* (proxy pass, mid-region oracle labels)
    partition-locally, but the importance sample is drawn over the full
    score vector with the same seed and the thresholds are learned from the
    same sample labels as the unpartitioned run — so ``tau_plus`` /
    ``tau_minus``, the accept/reject/mid regions, and the returned pass-set
    are identical, and the (recall, precision, delta) guarantee carries
    over unchanged."""
    lx = as_langex(langex)
    n = len(records)
    owner = np.zeros(n, int)
    for pi, idx in enumerate(parts):
        owner[idx] = pi
    with accounting.track("sem_filter") as st:
        prompts = [predicate_prompt(lx, t) for t in records]

        def score_frag(pi, idx):
            def task():
                with accounting.track(f"fragment[{pi}]"):
                    _, s = proxy.predicate([prompts[i] for i in idx])
                    return np.asarray(s, float)
            return task

        scores = np.zeros(n, float)
        for idx, s in zip(parts, run_fragments(
                pool, [score_frag(pi, idx) for pi, idx in enumerate(parts)])):
            scores[idx] = s

        def oracle_fn(indices):
            indices = np.asarray(indices, int)
            by_part: dict[int, list[int]] = {}
            for pos, i in enumerate(indices):
                by_part.setdefault(int(owner[i]), []).append(pos)

            def label_frag(pi, positions):
                def task():
                    with accounting.track(f"fragment[{pi}]"):
                        passed, _ = oracle.predicate(
                            [prompts[indices[p]] for p in positions])
                        return np.asarray(passed, bool)
                return task

            out = np.zeros(len(indices), bool)
            results = run_fragments(
                pool, [label_frag(pi, pos) for pi, pos in
                       sorted(by_part.items())])
            for (_, positions), labels in zip(sorted(by_part.items()), results):
                out[positions] = labels
            return out

        res = cascades.run_cascade(
            scores, oracle_fn, recall_target=recall_target,
            precision_target=precision_target, delta=delta,
            sample_size=sample_size, seed=seed)
        _audit.emit_cascade("Filter", lx.template, res,
                            lambda idx: [prompts[i] for i in idx],
                            recall_target=recall_target,
                            precision_target=precision_target)
        st.details.update(tau_plus=res.tau_plus, tau_minus=res.tau_minus,
                          oracle_calls_cascade=res.oracle_calls,
                          auto_accepted=res.auto_accepted,
                          auto_rejected=res.auto_rejected,
                          oracle_region=res.oracle_region,
                          n_partitions=len(parts),
                          partition_sizes=_fragment_sizes(parts))
        return res.passed, st.as_dict()


# ---------------------------------------------------------------------------
# Map family
# ---------------------------------------------------------------------------


def rows_partitioned(op_name: str, parts, pool, frag_fn) -> tuple[list, dict]:
    """Generic row-parallel runner: ``frag_fn(idx) -> per-row outputs`` for
    one partition; outputs are gathered back into global row order.
    Returns (outputs aligned to the input rows, stats)."""
    with accounting.track(op_name) as st:
        def frag(pi, idx):
            def task():
                with accounting.track(f"fragment[{pi}]"):
                    return frag_fn(idx)
            return task

        results = run_fragments(pool, [frag(pi, idx)
                                       for pi, idx in enumerate(parts)])
        n = int(sum(len(p) for p in parts))
        out: list = [None] * n
        for idx, sub in zip(parts, results):
            for i, row in zip(idx, sub):
                out[int(i)] = row
        st.details.update(n_partitions=len(parts),
                          partition_sizes=_fragment_sizes(parts))
        return out, st.as_dict()


# ---------------------------------------------------------------------------
# Hierarchical aggregation
# ---------------------------------------------------------------------------


def _reduce_levels(texts: list[str], template: str, model, fanout: int,
                   levels: int) -> list[str]:
    """Run exactly ``levels`` rounds of the level-synchronous reduce.  A
    length-1 level is still re-prompted as a singleton group — exactly what
    the unpartitioned loop does to a small trailing subtree whose partial
    closes early — so partition-local trees stay level-aligned with the
    global one (with a real model, ``agg([x]) != x``, so skipping those
    rounds would feed the root different inputs)."""
    level = list(texts)
    for _ in range(levels):
        groups = [level[i:i + fanout] for i in range(0, len(level), fanout)]
        level = model.generate([_agg_prompt(template, g) for g in groups])
    return level


def sem_agg_partitioned(records, langex, model, parts, pool, *,
                        fanout: int = 8) -> tuple[str, dict]:
    """Hierarchical reduce as partition-local subtrees + one global root.

    ``parts`` must be subtree-aligned (``subtree_partitions``): each
    fragment runs the first ``depth-1`` reduce levels of its subtree
    (including any singleton re-prompts of an early-closing tail), and the
    root prompt combines the partials — prompt-for-prompt the tree the
    unpartitioned ``sem_agg_hierarchical`` issues, so the final answer is
    record-identical for any corpus size."""
    lx = as_langex(langex)
    with accounting.track("sem_agg") as st:
        leaves = [lx.render(t) for t in records]
        depth = _tree_depth(len(leaves), fanout)

        def frag(pi, idx):
            def task():
                with accounting.track(f"fragment[{pi}]"):
                    return _reduce_levels([leaves[i] for i in idx],
                                          lx.template, model, fanout,
                                          depth - 1)
            return task

        partials = [x for chunk in run_fragments(
            pool, [frag(pi, idx) for pi, idx in enumerate(parts)])
            for x in chunk]
        # level ``depth``: one root group (<= fanout partials by alignment;
        # with depth == 1 the "partials" are the leaves themselves and this
        # is the unpartitioned run's single prompt)
        answer = model.generate([_agg_prompt(lx.template, partials)])[0]
        st.details.update(depth=depth, n_partitions=len(parts),
                          partition_sizes=_fragment_sizes(parts))
        return answer, st.as_dict()


def _tree_depth(n: int, fanout: int) -> int:
    f = max(fanout, 2)
    depth = 1
    while f ** depth < max(n, 1):
        depth += 1
    return depth


def sem_agg_groupby_partitioned(records, langex, model, group_by: str,
                                parts, pool, *, fanout: int = 8,
                                out_column: str = "aggregate"
                                ) -> tuple[list[dict], list[dict]]:
    """Group-by aggregation over hash partitions: every group's rows land
    whole in one fragment (hash on the group key), so each fragment runs
    the ordinary per-group hierarchical reduce; the merge re-orders group
    rows to the key's global first-seen order — exactly the unpartitioned
    iteration order.  Returns (rows, per-group stats dicts)."""
    from repro_torch.core.operators.agg import sem_agg_hierarchical
    lx = as_langex(langex)

    def frag(pi, idx):
        def task():
            with accounting.track(f"fragment[{pi}]"):
                groups: dict = {}
                for i in idx:
                    groups.setdefault(records[i][group_by],
                                      []).append(records[i])
                out = []
                for g, sub in groups.items():
                    answer, stats = sem_agg_hierarchical(sub, lx, model,
                                                         fanout=fanout)
                    out.append((g, answer, stats))
                return out
        return task

    results = run_fragments(pool, [frag(pi, idx)
                                   for pi, idx in enumerate(parts)])
    by_key = {g: (answer, stats) for chunk in results
              for g, answer, stats in chunk}
    rows, stats_list = [], []
    seen = set()
    for t in records:  # global first-seen order of group keys
        g = t[group_by]
        if g in seen:
            continue
        seen.add(g)
        answer, stats = by_key[g]
        rows.append({group_by: g, out_column: answer})
        stats_list.append(stats)
    return rows, stats_list


# ---------------------------------------------------------------------------
# Join
# ---------------------------------------------------------------------------


def sem_join_gold_partitioned(left, right, langex, oracle, lparts, rparts,
                              pool, *, exchange: str
                              ) -> tuple[np.ndarray, dict]:
    """Gold nested-loop join over a fragment tiling of the pair space:
    ``broadcast`` pairs each left partition with the full right side;
    ``repartition`` runs the (lparts x rparts) grid.  Per-pair prompts are
    unchanged, so the stitched mask equals the unpartitioned gold mask."""
    lx = as_langex(langex)
    with accounting.track("sem_join_gold") as st:
        n1, n2 = len(left), len(right)
        mask = np.zeros((n1, n2), bool)
        tiles = [(li, ri) for li in range(len(lparts))
                 for ri in range(len(rparts))]

        def frag(li, ri):
            lidx, ridx = lparts[li], rparts[ri]

            def task():
                with accounting.track(f"fragment[{li},{ri}]"):
                    pairs = [(int(i), int(j)) for i in lidx for j in ridx]
                    passed, _ = oracle.predicate(
                        _pair_prompts(lx, left, right, pairs))
                    sub = np.zeros((len(lidx), len(ridx)), bool)
                    for (pi, pj), p in zip(
                            ((a, b) for a in range(len(lidx))
                             for b in range(len(ridx))), passed):
                        sub[pi, pj] = p
                    return sub
            return task

        results = run_fragments(pool, [frag(li, ri) for li, ri in tiles])
        for (li, ri), sub in zip(tiles, results):
            mask[np.ix_(lparts[li], rparts[ri])] = sub
        st.details.update(exchange=exchange, n_fragments=len(tiles),
                          grid=(len(lparts), len(rparts)))
        return mask, st.as_dict()
