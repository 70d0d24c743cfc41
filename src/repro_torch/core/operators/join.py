"""sem_join (§2.3, §3.2).

Gold algorithm: nested-loop predicate evaluation, O(N1*N2) oracle calls.

Optimized: two embedding-based proxy plans with learned cascade thresholds —
  * sim-filter:          A1(i,j) = sim(emb(left_i),            emb(right_j))
  * project-sim-filter:  A2(i,j) = sim(emb(project(left_i)),   emb(right_j))
    (the projection is an *ungrounded* sem_map over the left table: predict
    the right join key from the left tuple alone — fully parallel, N1 calls)
— the optimizer prices both plans from one oracle-labeled pair sample and
executes the cheaper one (paper Table 5).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import accounting
from repro_torch.core.langex import as_langex
from repro_torch.core.operators.filter import predicate_prompt
from repro_torch.core.optimizer import blocks, cascades, stats
from repro_torch.index.quantile import quantile_calibrate
from repro_torch.index.vector_index import VectorIndex
from repro_torch.obs import audit as _audit

PROJECT_INSTRUCTION = (
    "{rendered}\nPredict the most likely value of the missing right-hand "
    "field, given only this input. Answer with the value only.\nAnswer:")


def _pair_prompts(lx, left, right, pairs):
    return [predicate_prompt(lx, left[i], right[j]) for i, j in pairs]


def sem_join_gold(left: list[dict], right: list[dict], langex, oracle,
                  *, batch: int = 4096) -> tuple[np.ndarray, dict]:
    """Returns (mask [N1,N2] bool, stats).

    Pair batches are generated lazily from the flat row-major pair index —
    the full O(N1*N2) tuple list is never materialized, so a gold join over
    large tables holds only one ``batch`` of pairs in host memory at a time
    (prompt order is unchanged: row-major, exactly the eager list's)."""
    lx = as_langex(langex)
    with accounting.track("sem_join_gold") as st:
        n1, n2 = len(left), len(right)
        out = np.zeros((n1, n2), bool)
        total = n1 * n2
        for s in range(0, total, batch):
            chunk = [divmod(flat, n2) for flat in range(s, min(s + batch, total))]
            passed, _ = oracle.predicate(_pair_prompts(lx, left, right, chunk))
            for (i, j), p in zip(chunk, passed):
                out[i, j] = p
        return out, st.as_dict()


def _render_side(records, fields):
    return [" ".join(str(t[f.name]) for f in fields) for t in records]


def sem_join_cascade(left: list[dict], right: list[dict], langex, oracle,
                     embedder, *, project_fn=None,
                     recall_target: float = 0.9, precision_target: float = 0.9,
                     delta: float = 0.2, sample_size: int = 100, seed: int = 0,
                     force_plan: str | None = None) -> tuple[np.ndarray, dict]:
    """Optimized join: plan selection between sim-filter and
    project-sim-filter, each a cascade with (recall, precision, delta)
    guarantees vs the gold nested-loop join.

    ``project_fn(left_records) -> list[str]`` overrides the LLM projection
    (defaults to oracle.generate over the ungrounded projection prompt).
    """
    lx = as_langex(langex)
    with accounting.track("sem_join") as st:
        n1, n2 = len(left), len(right)
        lfields = [f for f in lx.fields if f.side != "right"]
        rfields = [f for f in lx.fields if f.side == "right"]
        left_texts = _render_side(left, lfields)
        right_texts = _render_side(right, rfields)

        # -- plan 1 proxy: raw embedding similarity (scored through the
        # retrieval layer: proxy calibration needs the full exact matrix) ---
        emb_l = embedder.embed(left_texts)
        right_index = VectorIndex(embedder.embed(right_texts))
        a1 = quantile_calibrate(right_index.pairwise(emb_l)).ravel()

        # -- plan 2 proxy: project left -> right-key space -----------------
        if project_fn is None:
            proj_prompts = [PROJECT_INSTRUCTION.format(rendered=lx.render(t, None)
                            if not lx.is_binary else lx.render(t, {f.name: "?" for f in rfields}))
                            for t in left]
            projected = oracle.generate(proj_prompts)
        else:
            projected = project_fn(left)
        emb_p = embedder.embed(list(projected))
        a2 = quantile_calibrate(right_index.pairwise(emb_p)).ravel()

        # -- one oracle-labeled pair sample prices both plans --------------
        rng = np.random.default_rng(seed)
        s = min(sample_size, n1 * n2)
        mix_scores = np.maximum(a1, a2)          # defensive union of proxies
        probs = stats.defensive_importance_probs(mix_scores, power=16.0)
        idx = stats.importance_sample(rng, probs, s)
        uniq = np.unique(idx)
        pairs = [(int(i) // n2, int(i) % n2) for i in uniq]
        labels_uniq, _ = oracle.predicate(_pair_prompts(lx, left, right, pairs))
        label_of = dict(zip(uniq.tolist(), np.asarray(labels_uniq, bool).tolist()))
        labels = np.asarray([label_of[i] for i in idx], bool)

        plans = []
        for name, scores, extra in (("sim-filter", a1, 0),
                                    ("project-sim-filter", a2, n1)):
            sample = stats.Sample(idx=idx, probs=probs, labels=labels,
                                  scores=scores[idx])
            plans.append(cascades.estimate_plan(
                name, scores, sample, label_of,
                recall_target=recall_target, precision_target=precision_target,
                delta=delta, extra_lm_calls=extra))

        if force_plan:
            chosen = next(p for p in plans if p.name == force_plan)
        else:
            chosen = min(plans, key=lambda p: p.total_cost)

        def oracle_fn(flat_indices):
            prs = [(int(i) // n2, int(i) % n2) for i in flat_indices]
            passed, _ = oracle.predicate(_pair_prompts(lx, left, right, prs))
            return passed

        res = cascades.execute_plan(chosen, oracle_fn)
        _audit.emit_cascade(
            "Join", lx.template, res,
            lambda idx: _pair_prompts(
                lx, left, right, [(int(i) // n2, int(i) % n2) for i in idx]),
            recall_target=recall_target, precision_target=precision_target)
        st.details.update(plan=chosen.name, tau_plus=res.tau_plus, tau_minus=res.tau_minus,
                          plan_costs={p.name: p.total_cost for p in plans},
                          oracle_calls_cascade=res.oracle_calls,
                          auto_accepted=res.auto_accepted, oracle_region=res.oracle_region)
        return res.passed.reshape(n1, n2), st.as_dict()


def sem_join_block(left: list[dict], right: list[dict], langex, oracle,
                   embedder, *, recall_target: float = 0.9,
                   precision_target: float = 0.9, delta: float = 0.2,
                   sample_size: int = 100, seed: int = 0,
                   block_size: int | None = None,
                   candidate_k: int | None = None,
                   equivalence: bool | None = None,
                   agreement_floor: float = 0.9,
                   probe_size: int = 24,
                   index_builder=None) -> tuple[np.ndarray, dict]:
    """Three-stage fast join: IVF blocking -> block-prompted oracle ->
    transitivity-based verdict inference.

    Stage 1 (*blocking*): the right side is indexed through the retrieval
    layer (``index_builder(texts, n_queries)`` — the executor passes its
    cost-model-driven builder, so large corpora get IVF / int8 tiles) and
    each left row retrieves only its top-``k`` candidate block: candidate
    compute and memory are O(n1*k), never O(n1*n2).  A small uniform
    pairwise probe estimates the candidate set's match *coverage*; ``k``
    doubles (up to 3x) until coverage reaches the recall target, and the
    cascade's effective recall target is divided by the final coverage so
    the end-to-end guarantee is stated against the gold O(n1*n2) join.

    Stage 2 (*block prompts*): calibration labels and mid-region verdicts
    come from :class:`~repro_torch.core.optimizer.blocks.BlockJudge` — B pairs per
    structured prompt through ``oracle.generate`` (micro-batch-fused), with
    parse-validate-retry and a pairwise fallback so verdicts are never
    silently dropped.  Calibration blocks are agreement-checked against
    pairwise gold (:func:`~repro_torch.core.optimizer.cascades.block_labeled_sample`).

    Stage 3 (*verdict inference*): when the predicate is an equivalence
    (``equivalence=True``, the langex declares it, or
    :func:`~repro_torch.core.optimizer.blocks.detect_equivalence` confirms it on
    the calibration sample), confirmed verdicts propagate through a
    union-find transitivity closure: implied candidate pairs are pruned
    from the oracle bill entirely, and the closure is applied over the full
    pair grid at the end so true matches the blocking stage never retrieved
    are still recovered (``pairs_recovered_by_inference``).
    """
    lx = as_langex(langex)
    with accounting.track("sem_join_block") as st:
        n1, n2 = len(left), len(right)
        st.details.update(strategy="block")
        if n1 == 0 or n2 == 0:
            st.details.update(candidate_pairs=0, block_prompts=0,
                              block_fallbacks=0, pairs_pruned_by_inference=0)
            return np.zeros((n1, n2), bool), st.as_dict()
        lfields = [f for f in lx.fields if f.side != "right"]
        rfields = [f for f in lx.fields if f.side == "right"]
        left_texts = _render_side(left, lfields)
        right_texts = _render_side(right, rfields)

        if index_builder is None:
            def index_builder(texts, n_queries):
                from repro_torch.index.backend import build_index
                return build_index(embedder.embed(texts), kind="auto")
        right_index = index_builder(right_texts, n1)
        emb_l = embedder.embed(left_texts)
        rng = np.random.default_rng(seed)

        # pairwise gold judge with a label cache: coverage probes, block
        # agreement checks and mid-region reuse all share one bill
        label_cache: dict[tuple[int, int], bool] = {}

        def pairwise(prs):
            prs = [(int(i), int(j)) for i, j in prs]
            need = [p for p in dict.fromkeys(prs) if p not in label_cache]
            if need:
                passed, _ = oracle.predicate(_pair_prompts(lx, left, right, need))
                for p, v in zip(need, np.asarray(passed, bool)):
                    label_cache[p] = bool(v)
            return np.asarray([label_cache[p] for p in prs], bool)

        # -- stage 1: blocking with coverage-adaptive candidate width -------
        from repro_torch.index.backend import MASKED_SCORE
        k = min(int(candidate_k) if candidate_k else blocks.blocking_k(n2), n2)
        doublings = 0
        while True:
            scores_m, cand_m = right_index.search(emb_l, k)
            cand_pairs: list[tuple[int, int]] = []
            cand_scores: list[float] = []
            cand_set: set[tuple[int, int]] = set()
            for i in range(n1):
                for r in range(cand_m.shape[1]):
                    j, sc = int(cand_m[i, r]), float(scores_m[i, r])
                    if j < 0 or j >= n2 or sc <= MASKED_SCORE / 2:
                        continue
                    cand_pairs.append((i, j))
                    cand_scores.append(sc)
                    cand_set.add((i, j))
            n_cand, n_off = len(cand_pairs), n1 * n2 - len(cand_set)
            if n_off <= 0 or n_cand == 0:
                coverage = 1.0
            else:
                pick = rng.choice(n_cand, size=min(probe_size, n_cand),
                                  replace=False)
                p_cand = float(pairwise([cand_pairs[int(x)] for x in pick]).mean())
                off_probe: list[tuple[int, int]] = []
                tries = 0
                while len(off_probe) < min(probe_size, n_off) and tries < probe_size * 20:
                    pr = (int(rng.integers(n1)), int(rng.integers(n2)))
                    tries += 1
                    if pr not in cand_set:
                        off_probe.append(pr)
                p_off = float(pairwise(off_probe).mean()) if off_probe else 0.0
                mass_c, mass_o = p_cand * n_cand, p_off * n_off
                coverage = mass_c / (mass_c + mass_o) if mass_c + mass_o > 0 else 1.0
            if coverage >= recall_target or k >= n2 or doublings >= 3:
                break
            k = min(2 * k, n2)
            doublings += 1
        if n_cand == 0:
            st.details.update(candidate_pairs=0, candidate_k=k, block_prompts=0,
                              block_fallbacks=0, pairs_pruned_by_inference=0,
                              index=right_index.kind)
            return np.zeros((n1, n2), bool), st.as_dict()
        a = quantile_calibrate(np.asarray(cand_scores, np.float32)).ravel()

        # -- stage 2: block-labeled calibration sample + thresholds ---------
        judge = blocks.BlockJudge(
            oracle, lx, left, right,
            lambda prs: _pair_prompts(lx, left, right, prs),
            block_size=int(block_size) if block_size else blocks.DEFAULT_BLOCK_SIZE)
        s = min(sample_size, n_cand)
        probs = stats.defensive_importance_probs(a, power=16.0)
        idx = stats.importance_sample(rng, probs, s)
        uniq = np.unique(idx)
        uniq_pairs = [cand_pairs[int(u)] for u in uniq]
        cal = cascades.block_labeled_sample(uniq_pairs, judge, pairwise, rng=rng,
                                            agreement_floor=agreement_floor)
        label_of = dict(zip(uniq.tolist(), np.asarray(cal.labels, bool).tolist()))
        labels = np.asarray([label_of[int(i)] for i in idx], bool)
        sample = stats.Sample(idx=idx, probs=probs, labels=labels, scores=a[idx])
        # the cascade guarantees recall vs the *candidate* set; dividing the
        # target by the blocking coverage states it vs the gold join
        rt_eff = min(0.999, recall_target / max(coverage, 1e-6))
        plan = cascades.estimate_plan("block-join", a, sample, label_of,
                                      recall_target=rt_eff,
                                      precision_target=precision_target,
                                      delta=delta)

        # -- stage 3: equivalence resolution + inference-pruned execution --
        eq = equivalence
        if eq is None:
            eq = bool(getattr(lx, "equivalence", False)) or \
                blocks.detect_equivalence(uniq_pairs, cal.labels)
        inference = blocks.MatchInference(n1, n2) if eq else None
        if inference is not None:
            for (pi, pj), v in zip(uniq_pairs, cal.labels):
                inference.observe(pi, pj, bool(v))

        passed = np.zeros(n_cand, bool)
        auto = a >= plan.tau_plus
        passed[auto] = True
        mid = (~auto) & (a >= plan.tau_minus)
        known_mask = np.zeros(n_cand, bool)
        known_mask[uniq] = True
        for u in uniq:
            if mid[u]:
                passed[u] = label_of[int(u)]
        need = np.flatnonzero(mid & ~known_mask)
        # high-score-first waves: confident verdicts land early and seed the
        # transitivity closure, so later waves prune more implied pairs
        order = need[np.argsort(-a[need], kind="stable")]
        pruned = 0
        block_pairs: list[tuple[int, int]] = []
        block_verdicts: list[bool] = []
        wave = judge.block_size * 4
        pos = 0
        while pos < len(order):
            batch_idx: list[int] = []
            while pos < len(order) and len(batch_idx) < wave:
                fi = int(order[pos])
                pos += 1
                i, j = cand_pairs[fi]
                if (i, j) in label_cache:
                    passed[fi] = label_cache[(i, j)]
                    if inference is not None:
                        inference.observe(i, j, bool(passed[fi]))
                    continue
                if inference is not None:
                    v = inference.resolve(i, j)
                    if v is not None:
                        passed[fi] = v
                        pruned += 1
                        continue
                batch_idx.append(fi)
            if batch_idx:
                prs = [cand_pairs[fi] for fi in batch_idx]
                verdicts = np.asarray(judge.judge_pairs(prs), bool)
                for fi, v in zip(batch_idx, verdicts):
                    passed[fi] = bool(v)
                    i, j = cand_pairs[fi]
                    if inference is not None:
                        inference.observe(i, j, bool(v))
                block_pairs.extend(prs)
                block_verdicts.extend(bool(v) for v in verdicts)

        oracle_calls = judge.stats.block_prompts + \
            judge.stats.pairs_fallback_judged + len(label_cache)
        res = cascades.CascadeResult(
            passed=passed, tau_plus=plan.tau_plus, tau_minus=plan.tau_minus,
            oracle_calls=oracle_calls, sample_size=s,
            auto_accepted=int(auto.sum()),
            auto_rejected=int((a < plan.tau_minus).sum()),
            oracle_region=int(mid.sum()), judged=mid.copy())
        _audit.emit_cascade(
            "Join", lx.template, res,
            lambda fidx: _pair_prompts(
                lx, left, right, [cand_pairs[int(f)] for f in fidx]),
            recall_target=recall_target, precision_target=precision_target)
        _audit.emit_block_join(
            "Join", lx.template, block_pairs, block_verdicts,
            lambda fidx: _pair_prompts(
                lx, left, right, [block_pairs[int(f)] for f in fidx]),
            agreement_target=agreement_floor)

        mask = np.zeros((n1, n2), bool)
        for (i, j), p in zip(cand_pairs, passed):
            if p:
                mask[i, j] = True
        recovered = 0
        if inference is not None:
            # close the verdicts over the FULL pair grid: a true match the
            # blocking stage never retrieved still joins when the confirmed
            # classes imply it, so end-to-end recall is not capped by the
            # candidate coverage
            implied = inference.implied_matrix()
            recovered = int((implied & ~mask).sum())
            mask |= implied
        st.details.update(
            candidate_pairs=n_cand, candidate_k=k,
            coverage_est=round(float(coverage), 4),
            tau_plus=res.tau_plus, tau_minus=res.tau_minus,
            block_prompts=judge.stats.block_prompts,
            block_retries=judge.stats.block_retries,
            block_fallbacks=judge.stats.block_fallbacks,
            pairs_block_judged=judge.stats.pairs_block_judged,
            pairs_pruned_by_inference=pruned,
            pairs_recovered_by_inference=recovered,
            match_classes=inference.n_classes() if inference is not None else 0,
            block_agreement=round(float(cal.agreement), 4),
            blocks_rejudged=cal.blocks_rejudged,
            equivalence=bool(eq), auto_accepted=res.auto_accepted,
            oracle_region=res.oracle_region,
            oracle_calls_cascade=res.oracle_calls, index=right_index.kind)
        return mask, st.as_dict()
