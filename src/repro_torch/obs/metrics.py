"""MetricsRegistry: the production metrics plane (Prometheus text format).

One registry unifies every serving-layer series — gateway throughput and
per-tenant SLOs, dispatcher fusion, semantic-cache sharing, index/matview
registries, and the guarantee auditor's precision/recall CIs and violation
counters — behind three primitive types:

  * :class:`Counter`   — monotonically increasing totals;
  * :class:`Gauge`     — point-in-time values;
  * :class:`Histogram` — fixed-bucket distributions with ``_sum``/``_count``.

All three carry label sets (``reg.counter("x", "help", ("tenant",))`` then
``c.inc(1, tenant="a")``) and serialize to the Prometheus text exposition
format via :meth:`MetricsRegistry.render`.  Producers are *collected on
demand*: the gateway's ``metrics_text()`` builds a registry and asks each
subsystem to ``collect(reg)`` from its own authoritative counters, so the
hot paths never pay a second bookkeeping write.

Thread-safe (one lock per registry, shared by its metrics);
:func:`parse_exposition` is the validating parser the tests and benchmarks
use to assert the output is well-formed exposition text.
"""
from __future__ import annotations

import math
import re
import threading

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# default latency bucket bounds (seconds) for exported histograms
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 60.0)


def _escape(value) -> str:
    return (str(value).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _fmt(value: float) -> str:
    if value != value:                       # NaN
        return "NaN"
    if value in (math.inf, -math.inf):
        return "+Inf" if value > 0 else "-Inf"
    if float(value).is_integer() and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


class _Metric:
    """Shared machinery: label validation + per-labelset child storage."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: tuple,
                 lock: threading.Lock):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lock
        self._children: dict[tuple, object] = {}

    def _key(self, labels: dict) -> tuple:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared "
                f"{sorted(self.labelnames)}")
        return tuple(str(labels[ln]) for ln in self.labelnames)

    def _label_str(self, key: tuple) -> str:
        if not self.labelnames:
            return ""
        inner = ",".join(f'{ln}="{_escape(v)}"'
                         for ln, v in zip(self.labelnames, key))
        return "{" + inner + "}"

    def samples(self) -> list[tuple[str, str, float]]:
        """-> [(sample_name, label_str, value)] (lock held by caller)."""
        raise NotImplementedError


class Counter(_Metric):
    kind = "counter"

    def inc(self, n: float = 1, **labels) -> None:
        if n < 0:
            raise ValueError(f"{self.name}: counters only go up (inc {n})")
        key = self._key(labels)
        with self._lock:
            self._children[key] = self._children.get(key, 0.0) + n

    def set_total(self, v: float, **labels) -> None:
        """Install an externally-accumulated monotone total (the collect-on-
        demand pattern: the source of truth lives in the producer)."""
        key = self._key(labels)
        with self._lock:
            self._children[key] = float(v)

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._children.get(self._key(labels), 0.0))

    def samples(self):
        return [(self.name, self._label_str(k), v)
                for k, v in sorted(self._children.items())]


class Gauge(_Metric):
    kind = "gauge"

    def set(self, v: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._children[key] = float(v)

    def inc(self, n: float = 1, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._children[key] = self._children.get(key, 0.0) + n

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._children.get(self._key(labels), 0.0))

    def samples(self):
        return [(self.name, self._label_str(k), v)
                for k, v in sorted(self._children.items())]


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help, labelnames, lock,
                 buckets=DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames, lock)
        b = tuple(sorted(float(x) for x in buckets))
        if not b:
            raise ValueError(f"{self.name}: needs at least one bucket bound")
        self.buckets = b

    def observe(self, x: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = {
                    "counts": [0] * len(self.buckets), "sum": 0.0, "n": 0}
            for i, bound in enumerate(self.buckets):
                if x <= bound:
                    child["counts"][i] += 1
                    break
            child["sum"] += float(x)
            child["n"] += 1

    def observe_buckets(self, cumulative: list[int], total: int,
                        sum_: float, **labels) -> None:
        """Install pre-aggregated cumulative bucket counts (exporting an
        existing histogram, e.g. the gateway's ``LatencyHistogram``)."""
        if len(cumulative) != len(self.buckets):
            raise ValueError(
                f"{self.name}: {len(cumulative)} cumulative counts for "
                f"{len(self.buckets)} buckets")
        key = self._key(labels)
        counts = [cumulative[0]] + [cumulative[i] - cumulative[i - 1]
                                    for i in range(1, len(cumulative))]
        with self._lock:
            self._children[key] = {"counts": counts, "sum": float(sum_),
                                   "n": int(total)}

    def samples(self):
        out = []
        for key, child in sorted(self._children.items()):
            acc = 0
            base = self._label_str(key)
            for bound, c in zip(self.buckets, child["counts"]):
                acc += c
                ls = self._bucket_label(key, _fmt(bound))
                out.append((f"{self.name}_bucket", ls, acc))
            out.append((f"{self.name}_bucket",
                        self._bucket_label(key, "+Inf"), child["n"]))
            out.append((f"{self.name}_sum", base, child["sum"]))
            out.append((f"{self.name}_count", base, child["n"]))
        return out

    def _bucket_label(self, key: tuple, le: str) -> str:
        pairs = [f'{ln}="{_escape(v)}"'
                 for ln, v in zip(self.labelnames, key)]
        pairs.append(f'le="{le}"')
        return "{" + ",".join(pairs) + "}"


class MetricsRegistry:
    """Holds the metric families and renders the exposition document."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def _register(self, cls, name, help, labelnames, **kw) -> _Metric:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if type(existing) is not cls \
                        or existing.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} re-registered with a different "
                        "type or label set")
                return existing
            m = cls(name, help, tuple(labelnames), self._lock, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: tuple = ()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: tuple = ()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "", labelnames: tuple = (),
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help, labelnames,
                              buckets=buckets)

    def get(self, name: str) -> _Metric | None:
        with self._lock:
            return self._metrics.get(name)

    def render(self) -> str:
        """Prometheus text exposition (format version 0.0.4)."""
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
            lines: list[str] = []
            for m in metrics:
                if m.help:
                    lines.append(f"# HELP {m.name} {_escape(m.help)}")
                lines.append(f"# TYPE {m.name} {m.kind}")
                for sample_name, label_str, value in m.samples():
                    lines.append(f"{sample_name}{label_str} {_fmt(value)}")
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Validating parser (tests / benchmarks: "is this real exposition text?")
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^{}]*)\})?"
    r"\s+(?P<value>[^ \n]+)(?:\s+\d+)?$")
_LABEL_PAIR_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_exposition(text: str) -> dict[str, float]:
    """Parse Prometheus text exposition; raises ``ValueError`` on any
    malformed line.  Returns ``{"name{labels}": value}`` plus a ``# TYPE``
    consistency check (every sample must belong to a declared family)."""
    samples: dict[str, float] = {}
    types: dict[str, str] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4 or parts[3] not in (
                    "counter", "gauge", "histogram", "summary", "untyped"):
                raise ValueError(f"line {lineno}: bad TYPE line {line!r}")
            types[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: malformed sample {line!r}")
        name = m.group("name")
        labels = m.group("labels") or ""
        if labels:
            consumed = ",".join(f'{k}="{v}"' for k, v
                                in _LABEL_PAIR_RE.findall(labels))
            if consumed != labels.rstrip(","):
                raise ValueError(f"line {lineno}: malformed labels {labels!r}")
        raw = m.group("value")
        try:
            value = float(raw)
        except ValueError:
            if raw == "+Inf":
                value = math.inf
            elif raw == "-Inf":
                value = -math.inf
            elif raw == "NaN":
                value = math.nan
            else:
                raise ValueError(
                    f"line {lineno}: bad sample value {raw!r}") from None
        family = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[: -len(suffix)] in types:
                family = name[: -len(suffix)]
                break
        if family not in types:
            raise ValueError(f"line {lineno}: sample {name!r} has no TYPE")
        key = name + ("{" + labels + "}" if labels else "")
        samples[key] = value
    return samples
