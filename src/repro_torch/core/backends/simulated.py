"""Simulated oracle/proxy/embedder over synthetic worlds with known ground
truth and *controllable* noise.

No pretrained weights ship in this offline environment, so task accuracy on
FEVER/BioDEX is not reproducible — but the paper's contribution (gold
algorithms + cascade optimizations with statistical guarantees) is a claim
about *model-access patterns and statistics*, which this backend validates
exactly: the oracle realizes the gold algorithm's labels, proxies have
configurable quality (score separation alpha), embeddings have configurable
similarity/predicate correlation (the sim-filter vs project-sim-filter
regimes of §3.2), and comparisons flip with value-gap-dependent noise.

Records embed an id marker ("<rec:xyz>") in their text; the backend parses
ids out of rendered prompts to consult the world's truth tables, exactly as
a real model would read the tuple content.
"""
from __future__ import annotations

import dataclasses
import hashlib
import re

import numpy as np

ID_RE = re.compile(r"<rec:([\w\-]+)>")


def _hash_rng(*parts) -> np.random.Generator:
    h = hashlib.blake2b("|".join(str(p) for p in parts).encode(), digest_size=8)
    return np.random.default_rng(int.from_bytes(h.digest(), "little"))


def _unit(v: np.ndarray) -> np.ndarray:
    return v / max(np.linalg.norm(v), 1e-9)


@dataclasses.dataclass
class SimConfig:
    dim: int = 32
    oracle_flip: float = 0.0       # oracle == gold algorithm by default
    proxy_alpha: float = 2.0       # proxy score separation (quality)
    proxy_seed: int = 7
    compare_noise: float = 0.1     # logistic noise scale on rank comparisons
    sim_correlation: float = 0.8   # emb-similarity vs join-truth correlation
    label_noise: float = 0.1       # candidate-label corruption (group-by)
    choose_acc: float = 0.95       # oracle classifier accuracy


class SimulatedWorld:
    """Truth tables the simulated models consult."""

    def __init__(self, cfg: SimConfig | None = None, seed: int = 0):
        self.cfg = cfg or SimConfig()
        self.seed = seed
        self.filter_truth: dict[str, bool] = {}
        # per-predicate truth: phrase (matched against the rendered prompt)
        # -> {record id -> bool}; lets one corpus carry several filters with
        # different selectivities (plan-optimizer workloads)
        self.phrase_truth: dict[str, dict[str, bool]] = {}
        self.join_truth: dict[tuple[str, str], bool] = {}
        self.rank_value: dict[str, float] = {}
        self.class_of: dict[str, int] = {}
        self.right_key_of: dict[str, str] = {}   # left id -> matching right id
        self.topic_centers: np.ndarray | None = None

    def topic_center(self, c: int) -> np.ndarray:
        if self.topic_centers is None or c >= len(self.topic_centers):
            n = max(c + 1, 8)
            rng = _hash_rng("topics", self.seed)
            self.topic_centers = np.stack([_unit(rng.normal(size=self.cfg.dim))
                                           for _ in range(n)])
        return self.topic_centers[c]


def tag(rid: str) -> str:
    return f"<rec:{rid}>"


class SimulatedModel:
    """PredicateModel + GenerativeModel against a SimulatedWorld.

    role='oracle' realizes the gold algorithm; role='proxy' is the cheap
    scorer with cfg.proxy_alpha quality."""

    def __init__(self, world: SimulatedWorld, role: str = "oracle", *,
                 alpha: float | None = None, flip: float | None = None,
                 seed: int = 1):
        self.w = world
        self.role = role
        self.alpha = alpha if alpha is not None else (
            1e9 if role == "oracle" else world.cfg.proxy_alpha)
        self.flip = flip if flip is not None else (
            world.cfg.oracle_flip if role == "oracle" else 0.0)
        self.seed = seed

    # -- truth lookup -----------------------------------------------------
    def _ids(self, prompt: str) -> list[str]:
        return ID_RE.findall(prompt)

    def _class_of(self, rid: str) -> int | None:
        if rid in self.w.class_of:
            return self.w.class_of[rid]
        if rid.startswith("label") and rid[5:].isdigit():
            return int(rid[5:])
        return None

    def _truth(self, prompt: str) -> bool:
        ids = self._ids(prompt)
        if len(ids) >= 2:
            for i in range(len(ids) - 1):
                if self.w.join_truth.get((ids[i], ids[i + 1])) or \
                   self.w.join_truth.get((ids[i + 1], ids[i])):
                    return True
            return False
        if ids:
            for phrase, table in self.w.phrase_truth.items():
                if phrase in prompt and ids[0] in table:
                    return bool(table[ids[0]])
            return bool(self.w.filter_truth.get(ids[0], False))
        return False

    # -- PredicateModel ----------------------------------------------------
    def predicate(self, prompts):
        out_b, out_s = [], []
        for p in prompts:
            t = self._truth(p)
            rng = _hash_rng("pred", self.role, self.seed, p)
            if self.flip and rng.random() < self.flip:
                t = not t
            logit = self.alpha * (1.0 if t else -1.0) + rng.normal()
            score = 1.0 / (1.0 + np.exp(-np.clip(logit, -30, 30)))
            out_b.append(score > 0.5)
            out_s.append(score)
        return np.asarray(out_b, bool), np.asarray(out_s, np.float32)

    # -- comparisons (sem_topk) --------------------------------------------
    def compare(self, prompts):
        out = []
        for p in prompts:
            ids = self._ids(p)
            va = self.w.rank_value.get(ids[0], 0.0) if ids else 0.0
            vb = self.w.rank_value.get(ids[1], 0.0) if len(ids) > 1 else 0.0
            rng = _hash_rng("cmp", self.seed, p)
            noise = self.w.cfg.compare_noise
            pa = 1.0 / (1.0 + np.exp(-np.clip((va - vb) / max(noise, 1e-6), -60, 60)))
            out.append(rng.random() < pa)
        return np.asarray(out, bool)

    def _block_verdicts(self, prompt: str) -> str:
        """Answer a numbered multi-pair join block prompt: one
        '<number>: YES/NO' line per numbered candidate-pair line, judged
        from join_truth with per-line flip noise."""
        lines_out = []
        for line in prompt.splitlines():
            m = re.match(r"\s*(\d+)\.\s", line)
            if not m:
                continue
            ids = ID_RE.findall(line)
            t = False
            for a in range(len(ids) - 1):
                if self.w.join_truth.get((ids[a], ids[a + 1])) or \
                   self.w.join_truth.get((ids[a + 1], ids[a])):
                    t = True
                    break
            rng = _hash_rng("blk", self.role, self.seed, line)
            if self.flip and rng.random() < self.flip:
                t = not t
            lines_out.append(f"{m.group(1)}: {'YES' if t else 'NO'}")
        return "\n".join(lines_out)

    # -- generation ---------------------------------------------------------
    def generate(self, prompts):
        out = []
        for p in prompts:
            ids = self._ids(p)
            rng = _hash_rng("gen", self.seed, p)
            if "numbered candidate pair" in p:
                out.append(self._block_verdicts(p))
            elif "category label" in p and ids:
                cls = [self._class_of(i) for i in ids]
                cls = [c for c in cls if c is not None]
                c = int(np.bincount(cls).argmax()) if cls else 0
                if rng.random() < self.w.cfg.label_noise:
                    c = int(rng.integers(0, max(self.w.class_of.values()) + 1))
                out.append(f"topic-{c} {tag(f'label{c}')}")
            elif "combined answer" in p:
                # aggregation: echo a canonical reduction over member ids,
                # preserving tags so deeper reduce levels keep provenance
                mids = sorted(set(ids))
                cls = [self._class_of(i) for i in mids]
                cls = [c for c in cls if c is not None]
                if cls and "category label" not in p:
                    c = int(np.bincount(cls).argmax())
                    out.append(f"topic-{c} {tag(f'label{c}')}")
                else:
                    out.append("summary(" + ",".join(tag(i) for i in mids[:8]) + ")")
            elif "missing right-hand field" in p and ids:
                # ungrounded projection: emit the true right key's tag (noisy)
                rid = self.w.right_key_of.get(ids[0])
                if rid is None or rng.random() < self.w.cfg.label_noise:
                    cands = list(self.w.right_key_of.values()) or ["none"]
                    rid = cands[int(rng.integers(len(cands)))]
                out.append(f"predicted {tag(rid)}")
            else:
                out.append("ok " + " ".join(tag(i) for i in ids[:2]))
        return out

    def choose(self, prompts, n_options):
        """Classification against the categories *shown in the prompt*: the
        answer is the index of the listed category whose latent class matches
        the item's class (as a real model would pick among the options)."""
        out = []
        for p in prompts:
            rng = _hash_rng("choose", self.seed, p)
            item_id = None
            cats: list[tuple[int, str]] = []
            for line in p.splitlines():
                m = re.match(r"\s*(\d+)\.\s", line)
                ids = ID_RE.findall(line)
                if m and ids:
                    cats.append((int(m.group(1)), ids[0]))
                elif ids and item_id is None and not m:
                    item_id = ids[0]
            c = 0
            if item_id is not None and cats:
                want = self._class_of(item_id)
                match = [i for i, cid in cats if self._class_of(cid) == want]
                c = match[0] if match else int(rng.integers(n_options))
            if rng.random() > self.w.cfg.choose_acc:
                c = int(rng.integers(n_options))
            out.append(min(c, n_options - 1))
        return np.asarray(out, int)


class SimulatedEmbedder:
    """Deterministic text -> unit vector with topic structure.

    Texts containing a record tag embed near their record's topic center
    (or the record-specific latent for join keys), with correlation
    cfg.sim_correlation; unknown text hashes to a random direction."""

    def __init__(self, world: SimulatedWorld, *, seed: int = 3):
        self.w = world
        self.seed = seed
        self._latent: dict[str, np.ndarray] = {}

    @property
    def dim(self) -> int:
        return self.w.cfg.dim

    def _class(self, rid: str) -> int | None:
        if rid in self.w.class_of:
            return self.w.class_of[rid]
        if rid.startswith("label") and rid[5:].isdigit():
            return int(rid[5:])        # canonical label ids carry their class
        return None

    def latent(self, rid: str) -> np.ndarray:
        if rid not in self._latent:
            cls = self._class(rid)
            if cls is not None:
                base = self.w.topic_center(cls)
                rng = _hash_rng("lat", self.seed, rid)
                corr = self.w.cfg.sim_correlation
                v = corr * base + (1 - corr) * rng.normal(size=self.dim) * 0.5
            else:
                v = _hash_rng("lat", self.seed, rid).normal(size=self.dim)
            self._latent[rid] = _unit(v)
        return self._latent[rid]

    def embed(self, texts):
        out = []
        for t in texts:
            ids = ID_RE.findall(t)
            if ids:
                v = np.mean([self.latent(i) for i in ids], axis=0)
                out.append(_unit(v))
            else:
                out.append(_unit(_hash_rng("txt", self.seed, t).normal(size=self.dim)))
        return np.stack(out).astype(np.float32)
