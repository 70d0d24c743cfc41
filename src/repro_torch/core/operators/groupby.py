"""sem_group_by (§2.3, §3.3).

Gold algorithm (two stages):
  1. discover C group labels: sem_map each tuple to a candidate label ->
     embed -> k-means -> for each cluster, sem_agg a label over the top-m
     centroid-nearest members;
  2. point-wise classification: M(t, mu_1..mu_C) for every tuple.

Optimized classification: embedding-similarity proxy between each tuple's
candidate label and the discovered centers, with a PT-style learned threshold
guaranteeing classification accuracy >= gamma w.p. 1-delta (uniform sample);
below-threshold tuples fall back to the oracle classifier.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import accounting
from repro_torch.core.langex import as_langex
from repro_torch.core.operators.agg import sem_agg_hierarchical
from repro_torch.core.optimizer import stats
from repro_torch.index.kmeans import kmeans
from repro_torch.index.vector_index import VectorIndex

MAP_LABEL_INSTRUCTION = ("Task: produce a short category label for: {item}\n"
                         "Criteria: {criteria}\nLabel:")
CLASSIFY_INSTRUCTION = ("Criteria: {criteria}\nItem: {item}\nCategories:\n{cats}\n"
                        "Answer with the number of the best category.\nAnswer:")


@dataclasses.dataclass
class GroupByResult:
    labels: list[str]           # C discovered group labels
    assignment: np.ndarray      # [N] group index per tuple
    stats: dict


def _discover(records, lx, model, embedder, C, *, label_sample: int, seed: int):
    """Stage 1: candidate labels -> embed -> kmeans -> label each cluster.

    -> (cand_labels [N], center_sims [N, C], group_labels [C])."""
    cand_prompts = [MAP_LABEL_INSTRUCTION.format(item=lx.render(t), criteria=lx.template)
                    for t in records]
    cand_labels = model.generate(cand_prompts)
    emb = embedder.embed(list(cand_labels))
    centers, assign = kmeans(emb, C, seed=seed)
    # center scoring rides the retrieval layer (the exact backend over the
    # C discovered centers) so the similarity math matches search/sim_join;
    # the same [N, C] matrix doubles as the cascade's proxy scores
    center_sims = VectorIndex(centers).pairwise(emb)
    group_labels: list[str] = []
    for j in range(len(centers)):
        members = np.flatnonzero(assign == j)
        if len(members) == 0:
            group_labels.append(f"group-{j}")
            continue
        top = members[np.argsort(-center_sims[members, j])[:label_sample]]
        label, _ = sem_agg_hierarchical(
            [{"label": cand_labels[i]} for i in top],
            "a short category label capturing all of: {label}", model)
        group_labels.append(label)
    return cand_labels, center_sims, group_labels


def _oracle_classify(records, lx, model, group_labels, indices) -> np.ndarray:
    cats = "\n".join(f"{i}. {l}" for i, l in enumerate(group_labels))
    prompts = [CLASSIFY_INSTRUCTION.format(criteria=lx.template,
                                           item=lx.render(records[i]), cats=cats)
               for i in indices]
    return np.asarray(model.choose(prompts, len(group_labels)), int)


def sem_group_by_gold(records, langex, C, model, embedder, *,
                      label_sample: int = 8, seed: int = 0) -> GroupByResult:
    lx = as_langex(langex)
    with accounting.track("sem_group_by_gold") as st:
        _, _, group_labels = _discover(records, lx, model, embedder, C,
                                       label_sample=label_sample, seed=seed)
        assign = _oracle_classify(records, lx, model, group_labels, range(len(records)))
        return GroupByResult(group_labels, assign, st.as_dict())


def sem_group_by_cascade(records, langex, C, model, embedder, *,
                         accuracy_target: float = 0.9, delta: float = 0.2,
                         sample_size: int = 100, label_sample: int = 8,
                         seed: int = 0) -> GroupByResult:
    lx = as_langex(langex)
    with accounting.track("sem_group_by") as st:
        _, sims, group_labels = _discover(
            records, lx, model, embedder, C, label_sample=label_sample, seed=seed)

        # proxy: candidate-label similarity to the discovered centers
        # (the [N, C] matrix _discover already scored)
        proxy_label = np.argmax(sims, axis=1)
        proxy_score = np.max(sims, axis=1)      # A(t_i, mu_j) = sim(t'_i, mu_j)

        # learn accuracy threshold on a uniform sample (PT-style, §3.3)
        rng = np.random.default_rng(seed)
        n = len(records)
        s = min(sample_size, n)
        sample_idx = rng.choice(n, size=s, replace=False)
        oracle_lab = _oracle_classify(records, lx, model, group_labels, sample_idx)
        correct = oracle_lab == proxy_label[sample_idx]
        tau = stats.accuracy_threshold(proxy_score[sample_idx], correct,
                                       accuracy_target, delta)

        assign = proxy_label.copy()
        known = dict(zip(sample_idx.tolist(), oracle_lab.tolist()))
        for i, lab in known.items():
            assign[i] = lab
        need = np.flatnonzero((proxy_score < tau)
                              & ~np.isin(np.arange(n), sample_idx))
        if len(need):
            assign[need] = _oracle_classify(records, lx, model, group_labels, need)
        st.details.update(tau=float(tau), oracle_classified=len(need) + s,
                          proxy_classified=int(n - len(need) - s))
        return GroupByResult(group_labels, assign, st.as_dict())
