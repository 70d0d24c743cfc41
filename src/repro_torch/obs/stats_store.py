"""Process-wide observed-statistics store for adaptive optimization.

The optimizer prices plans from a static importance sample; this store is
the feedback path: every executed plan node reports its observed
cardinalities, model-call bill, and wall time keyed by
``(operator, predicate-fingerprint)``, so a future adaptive optimizer (and
``explain_analyze`` today) can compare the cost model's predictions with
what the same predicate actually did across sessions.

The fingerprint hashes the semantics of the node — the natural-language
template / query / target columns — not the input data, so observations
for one predicate accumulate across corpora of different sizes (selectivity
is a property of the predicate, per the paper's proxy-calibration setup).

Persistence is a small JSON document saved alongside the semantic cache
(the gateway saves it in ``close()``); ``load()`` merges additively so
multiple processes can fold their runs together.

Windowing: a feedback loop must weight the last five minutes over last
month's sessions, so the store supports exponential decay — with
``decay < 1`` every accumulator (runs, rows, calls, wall) is multiplied by
``decay`` before each new observation folds in, making the stored values
exponentially-weighted sums whose ratios (selectivity, calls/row) become
EWMAs.  ``load(path, discount=...)`` down-weights a persisted store the
same way, so history carried across processes arrives as a prior, not a
veto.  The default ``decay=1.0`` keeps the original additive semantics.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import threading

log = logging.getLogger(__name__)


def predicate_fingerprint(operator: str, *parts) -> str:
    """Stable 16-hex-char fingerprint of an operator's semantic identity."""
    h = hashlib.sha1()
    h.update(operator.encode())
    for p in parts:
        h.update(b"\x1f")
        h.update(str(p).encode())
    return h.hexdigest()[:16]


def node_fingerprint(node) -> str | None:
    """Fingerprint a plan node by its semantic payload (duck-typed so this
    module stays import-free of the plan IR).  Returns None for nodes with
    no semantic identity worth accumulating (scans, limits, exchanges)."""
    kind = type(node).__name__
    parts = []
    for attr in ("langex", "template", "query", "instruction"):
        v = getattr(node, attr, None)
        if v is None:
            continue
        # langex objects carry the natural-language template
        v = getattr(v, "template", v)
        parts.append(v)
    for attr in ("on", "columns", "by", "k", "fields"):
        v = getattr(node, attr, None)
        if v is not None and not callable(v):  # some IRs expose columns()
            parts.append(f"{attr}={v}")
    if not parts:
        return None
    return predicate_fingerprint(kind, *parts)


_SUM_FIELDS = ("rows_in", "rows_out", "oracle_calls", "proxy_calls",
               "embed_calls", "compare_calls", "generate_calls",
               "cache_hits")


@dataclasses.dataclass
class ObservedStats:
    # accumulators are ints under the default additive semantics and become
    # exponentially-weighted float sums once the store decays (decay < 1)
    operator: str
    fingerprint: str
    runs: float = 0
    rows_in: float = 0
    rows_out: float = 0
    oracle_calls: float = 0
    proxy_calls: float = 0
    embed_calls: float = 0
    compare_calls: float = 0
    generate_calls: float = 0
    cache_hits: float = 0
    wall_s: float = 0.0
    details: dict = dataclasses.field(default_factory=dict)

    @property
    def selectivity(self) -> float | None:
        if self.rows_in <= 0:
            return None
        return self.rows_out / self.rows_in

    @property
    def mean_wall_s(self) -> float:
        return self.wall_s / self.runs if self.runs else 0.0

    @property
    def oracle_calls_per_row(self) -> float:
        return self.oracle_calls / self.rows_in if self.rows_in else 0.0

    def as_dict(self) -> dict:
        rnd = lambda v: v if isinstance(v, int) else round(v, 4)
        d = {"operator": self.operator, "fingerprint": self.fingerprint,
             "runs": rnd(self.runs), "wall_s": round(self.wall_s, 6),
             "selectivity": (round(self.selectivity, 6)
                             if self.selectivity is not None else None),
             "details": {k: rnd(v) if isinstance(v, (int, float))
                         and not isinstance(v, bool) else v
                         for k, v in self.details.items()}}
        for f in _SUM_FIELDS:
            d[f] = rnd(getattr(self, f))
        return d


class StatsStore:
    """Accumulates ``ObservedStats`` keyed by (operator, fingerprint)."""

    def __init__(self, path: str | None = None, *, decay: float = 1.0,
                 load_discount: float = 1.0):
        if not 0.0 < decay <= 1.0:
            raise ValueError(f"decay={decay} (expected 0 < decay <= 1)")
        self._lock = threading.Lock()
        self._stats: dict[tuple[str, str], ObservedStats] = {}
        self.decay = decay
        self.path = path
        self.poisoned = 0     # entries dropped by guarantee-audit violations
        if path and os.path.exists(path):
            self.load(path, discount=load_discount)

    def _age(self, obs: ObservedStats) -> None:
        """Apply one step of exponential decay (lock held). runs becomes the
        EWMA weight mass, so ratio properties stay unbiased."""
        if self.decay >= 1.0:
            return
        d = self.decay
        obs.runs *= d
        obs.wall_s *= d
        for f in _SUM_FIELDS:
            setattr(obs, f, getattr(obs, f) * d)
        for k in obs.details:
            v = obs.details[k]
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                obs.details[k] = v * d

    def observe(self, operator: str, fingerprint: str, *, rows_in: int = 0,
                rows_out: int = 0, wall_s: float = 0.0,
                stats: dict | None = None, **details) -> ObservedStats:
        with self._lock:
            key = (operator, fingerprint)
            obs = self._stats.get(key)
            if obs is None:
                obs = self._stats[key] = ObservedStats(operator, fingerprint)
            self._age(obs)
            obs.runs += 1
            obs.rows_in += int(rows_in)
            obs.rows_out += int(rows_out)
            obs.wall_s += float(wall_s)
            if stats:
                for f in ("oracle_calls", "proxy_calls", "embed_calls",
                          "compare_calls", "generate_calls", "cache_hits"):
                    v = stats.get(f)
                    if isinstance(v, (int, float)) and not isinstance(v, bool):
                        setattr(obs, f, getattr(obs, f) + int(v))
            for k, v in details.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    obs.details[k] = obs.details.get(k, 0) + v
            return obs

    def observe_node(self, node, stats: dict | None, *, rows_in: int,
                     rows_out: int, wall_s: float = 0.0) -> ObservedStats | None:
        """Record one plan-node execution; skips nodes with no semantic
        fingerprint (scans, limits)."""
        fp = node_fingerprint(node)
        if fp is None:
            return None
        operator = (stats or {}).get("operator") or type(node).__name__.lower()
        numeric_details = {
            k: v for k, v in (stats or {}).items()
            if k not in ("operator", "wall_s") and k not in _SUM_FIELDS
            and isinstance(v, (int, float)) and not isinstance(v, bool)}
        if stats and not wall_s:
            wall_s = float(stats.get("wall_s") or 0.0)
        return self.observe(operator, fp, rows_in=rows_in, rows_out=rows_out,
                            wall_s=wall_s, stats=stats, **numeric_details)

    # -- queries ---------------------------------------------------------
    def get(self, operator: str, fingerprint: str) -> ObservedStats | None:
        with self._lock:
            return self._stats.get((operator, fingerprint))

    def selectivity(self, operator: str, fingerprint: str) -> float | None:
        obs = self.get(operator, fingerprint)
        return obs.selectivity if obs is not None else None

    def selectivity_for_node(self, node) -> float | None:
        """Observed selectivity for a plan node, any operator — the lookup
        the adaptive optimizer will use."""
        obs = self.stats_for_node(node)
        return obs.selectivity if obs is not None else None

    def stats_for_node(self, node) -> ObservedStats | None:
        """Full observed entry for a plan node's fingerprint, any operator
        — selectivity plus the run weight the shrinkage blend needs."""
        fp = node_fingerprint(node)
        if fp is None:
            return None
        with self._lock:
            for (_, f), obs in self._stats.items():
                if f == fp and obs.runs > 0:
                    return obs
        return None

    def poison(self, fingerprint: str) -> int:
        """Drop every entry with this fingerprint (all operators).

        Called by the GuaranteeAuditor when a CI violation shows the
        predicate's history was earned under a drifted proxy/oracle — the
        adaptive executor and feedback costing must stop trusting its
        selectivities; fresh observations rebuild the entry from zero."""
        with self._lock:
            victims = [k for k in self._stats if k[1] == fingerprint]
            for k in victims:
                del self._stats[k]
            self.poisoned += len(victims)
        if victims:
            log.warning("stats-store poisoned %d entr%s for fingerprint %s",
                        len(victims), "y" if len(victims) == 1 else "ies",
                        fingerprint)
        return len(victims)

    def snapshot(self) -> list[dict]:
        with self._lock:
            entries = list(self._stats.values())
        return [e.as_dict() for e in sorted(
            entries, key=lambda e: (e.operator, e.fingerprint))]

    def __len__(self) -> int:
        with self._lock:
            return len(self._stats)

    # -- persistence -----------------------------------------------------
    def save(self, path: str | None = None) -> str:
        path = path or self.path
        if not path:
            raise ValueError("StatsStore.save() needs a path")
        doc = {"version": 1, "entries": self.snapshot()}
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, path)
        return path

    def load(self, path: str, *, discount: float = 1.0,
             strict: bool = False) -> int:
        """Merge a saved store into this one.  ``discount`` scales every
        incoming accumulator (1.0 = the original additive merge): a
        down-weighted load makes cross-process history a shrinkage prior
        that fresh observations quickly outvote, instead of a month of
        stale sessions outvoting the last five minutes.

        A missing, truncated, or corrupt file (crashed writer, torn disk,
        wrong schema) is log-and-continue with whatever state already loaded
        — persisted stats are advisory history, and a bad file must never
        block gateway startup.  ``strict=True`` restores the raising
        behavior for callers that want the error."""
        if not 0.0 <= discount <= 1.0:
            raise ValueError(f"discount={discount} (expected 0 <= d <= 1)")
        try:
            with open(path) as f:
                doc = json.load(f)
            entries = doc.get("entries", ())
            if not isinstance(entries, (list, tuple)):
                raise ValueError(f"entries is {type(entries).__name__}, "
                                 "expected a list")
        except (OSError, json.JSONDecodeError, UnicodeDecodeError,
                ValueError, AttributeError) as exc:
            if strict:
                raise
            log.warning("stats store load failed (%s: %s) — continuing "
                        "with fresh state", path, exc)
            return 0
        scale = (lambda v: v) if discount == 1.0 else (lambda v: v * discount)
        n = skipped = 0
        for e in entries:
            try:
                key = (e["operator"], e["fingerprint"])
                counts = {f: float(e.get(f, 0) or 0) for f in _SUM_FIELDS
                          if f not in ("rows_in", "rows_out")}
                runs = float(e.get("runs", 0) or 0)
                rows_in = float(e.get("rows_in", 0) or 0)
                rows_out = float(e.get("rows_out", 0) or 0)
                wall_s = float(e.get("wall_s", 0.0) or 0.0)
                details = e.get("details") or {}
            except (TypeError, KeyError, ValueError, AttributeError):
                skipped += 1   # malformed entry: drop it, keep the rest
                continue
            with self._lock:
                obs = self._stats.get(key)
                if obs is None:
                    obs = self._stats[key] = ObservedStats(key[0], key[1])
                obs.runs += scale(runs)
                obs.rows_in += scale(rows_in)
                obs.rows_out += scale(rows_out)
                obs.wall_s += scale(wall_s)
                for f, v in counts.items():
                    setattr(obs, f, getattr(obs, f) + scale(v))
                for k, v in details.items():
                    if isinstance(v, (int, float)) and not isinstance(v, bool):
                        obs.details[k] = obs.details.get(k, 0) + scale(v)
            n += 1
        if skipped:
            log.warning("stats store load: skipped %d malformed entr%s in %s",
                        skipped, "y" if skipped == 1 else "ies", path)
        return n
