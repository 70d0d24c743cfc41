"""Synthetic bulk-semantic-processing workloads mirroring the paper's four
applications (FEVER fact-checking, BioDEX multilabel join, SciFact/HellaSwag
ranking, ArXiv topic analysis), built over SimulatedWorld truth tables.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.backends.simulated import (SimConfig, SimulatedEmbedder,
                                           SimulatedModel, SimulatedWorld, tag)


def make_filter_world(n: int, *, positive_rate: float = 0.4,
                      proxy_alpha: float = 2.0, seed: int = 0,
                      cfg: SimConfig | None = None):
    """FEVER-like: claims, truth = supported/not. Returns (records, world,
    oracle, proxy, embedder)."""
    cfg = cfg or SimConfig(proxy_alpha=proxy_alpha)
    world = SimulatedWorld(cfg, seed=seed)
    rng = np.random.default_rng(seed)
    records = []
    for i in range(n):
        rid = f"claim{i}"
        world.filter_truth[rid] = bool(rng.random() < positive_rate)
        records.append({"id": rid, "claim": f"claim text {i} {tag(rid)}"})
    oracle = SimulatedModel(world, "oracle")
    proxy = SimulatedModel(world, "proxy", alpha=proxy_alpha)
    return records, world, oracle, proxy, SimulatedEmbedder(world)


def add_phrase_predicate(world: SimulatedWorld, records: list[dict], phrase: str,
                         rate: float, *, seed: int = 0) -> None:
    """Attach an independent named predicate to an existing corpus: prompts
    containing ``phrase`` are true for each record w.p. ``rate`` (fixed per
    record).  Multiple phrases on one corpus give the plan optimizer filter
    chains with genuinely different selectivities."""
    import zlib
    rng = np.random.default_rng((seed, zlib.crc32(phrase.encode())))
    world.phrase_truth[phrase] = {t["id"]: bool(rng.random() < rate)
                                  for t in records}


def make_join_world(n_left: int, n_right: int, *, labels_per_left: int = 2,
                    sim_correlation: float = 0.8, seed: int = 0,
                    cfg: SimConfig | None = None):
    """BioDEX-like extreme multilabel: left articles x right labels; each
    article truly matches `labels_per_left` labels.  ``sim_correlation``
    controls whether raw article/label embeddings correlate with matches
    (the sim-filter regime) — at low correlation only the projected proxy
    works (the project-sim-filter regime, paper Table 5)."""
    cfg = cfg or SimConfig(sim_correlation=sim_correlation)
    world = SimulatedWorld(cfg, seed=seed)
    rng = np.random.default_rng(seed)
    right = []
    for j in range(n_right):
        rid = f"label{j}"
        world.class_of[rid] = j % 8 if sim_correlation > 0 else j
        right.append({"id": rid, "reaction": f"reaction {j} {tag(rid)}"})
    left = []
    for i in range(n_left):
        lid = f"art{i}"
        matches = rng.choice(n_right, size=min(labels_per_left, n_right), replace=False)
        for j in matches:
            world.join_truth[(lid, f"label{j}")] = True
        # the article's latent topic matches its first true label's topic iff
        # similarity correlates with the predicate
        world.class_of[lid] = world.class_of[f"label{int(matches[0])}"] \
            if sim_correlation > 0 else 10_000 + i
        world.right_key_of[lid] = f"label{int(matches[0])}"
        left.append({"id": lid, "abstract": f"patient article {i} {tag(lid)}"})
    oracle = SimulatedModel(world, "oracle")
    proxy = SimulatedModel(world, "proxy")
    return left, right, world, oracle, proxy, SimulatedEmbedder(world)


def make_entity_world(n_left: int, n_right: int, n_classes: int, *,
                      sim_correlation: float = 0.85, seed: int = 0,
                      cfg: SimConfig | None = None):
    """Entity-resolution-like join with *equivalence* structure: every left
    and right record belongs to one of ``n_classes`` latent entities, and
    the join predicate is "same entity" — so matches are complete bipartite
    within a class and transitivity holds exactly (the regime where
    block-join verdict inference pays).  Embeddings correlate with the
    entity via ``sim_correlation``.  Returns
    (left, right, world, oracle, proxy, embedder)."""
    cfg = cfg or SimConfig(sim_correlation=sim_correlation)
    world = SimulatedWorld(cfg, seed=seed)
    rng = np.random.default_rng(seed)
    right = []
    r_class = rng.integers(0, n_classes, size=n_right)
    for j in range(n_right):
        rid = f"ent{j}"
        world.class_of[rid] = int(r_class[j])
        right.append({"id": rid, "entity": f"entity record {j} {tag(rid)}"})
    left = []
    for i in range(n_left):
        lid = f"mention{i}"
        c = int(rng.integers(0, n_classes))
        world.class_of[lid] = c
        mates = [j for j in range(n_right) if int(r_class[j]) == c]
        for j in mates:
            world.join_truth[(lid, f"ent{j}")] = True
        if mates:
            world.right_key_of[lid] = f"ent{mates[0]}"
        left.append({"id": lid, "mention": f"mention {i} {tag(lid)}"})
    oracle = SimulatedModel(world, "oracle")
    proxy = SimulatedModel(world, "proxy")
    return left, right, world, oracle, proxy, SimulatedEmbedder(world)


def make_rank_world(n: int, *, compare_noise: float = 0.08, seed: int = 0,
                    topic_for_query: bool = True):
    """HellaSwag-bench-like: items with scalar ground-truth values; noisy
    pairwise comparisons; embedding similarity correlates with value so the
    §3.4 pivot optimization has signal."""
    cfg = SimConfig(compare_noise=compare_noise, sim_correlation=0.9)
    world = SimulatedWorld(cfg, seed=seed)
    rng = np.random.default_rng(seed)
    records = []
    vals = rng.uniform(0, 1, n)
    for i in range(n):
        rid = f"doc{i}"
        world.rank_value[rid] = float(vals[i])
        # topic 0 center direction scaled by value -> similarity ~ value
        world.class_of[rid] = 0 if topic_for_query else i % 7
        records.append({"id": rid, "abstract": f"paper {i} accuracy {vals[i]:.3f} {tag(rid)}"})
    model = SimulatedModel(world, "oracle")
    embedder = SimulatedEmbedder(world)

    # pivot scores: similarity to query direction, correlated with value
    base = world.topic_center(0)
    noise = rng.normal(size=(n, cfg.dim)) * 0.2
    sim_scores = (vals[:, None] * base[None, :] + noise) @ base
    return records, world, model, embedder, np.asarray(sim_scores)


def make_topic_world(n: int, n_topics: int, *, label_noise: float = 0.1,
                     choose_acc: float = 0.95, sim_correlation: float = 0.85,
                     seed: int = 0):
    """ArXiv-like corpus with latent topics (sem_group_by ground truth)."""
    cfg = SimConfig(label_noise=label_noise, choose_acc=choose_acc,
                    sim_correlation=sim_correlation)
    world = SimulatedWorld(cfg, seed=seed)
    rng = np.random.default_rng(seed)
    records = []
    for i in range(n):
        rid = f"paper{i}"
        world.class_of[rid] = int(rng.integers(n_topics))
        records.append({"id": rid, "paper": f"arxiv paper {i} {tag(rid)}"})
    model = SimulatedModel(world, "oracle")
    return records, world, model, SimulatedEmbedder(world)
