"""Concurrent semantic-query serving layer (the system half of the paper).

PR 1 made one pipeline cheap (plan IR + optimizer + batched executor); this
package makes *many concurrent* pipelines cheap by sharing work across them:

  * ``store``    — :class:`SharedSemanticCache`, the process-wide semantic
                   answer store (TTL, LRU capacity, per-role namespaces,
                   optional JSON-lines persistence across runs);
  * ``dispatch`` — :class:`MicroBatchDispatcher`, cross-query micro-batching:
                   oracle/proxy/embed calls from all in-flight executors are
                   coalesced (deduplicated) into fused backend batches on a
                   short time/size window;
  * ``session``  — :class:`ServeSession`, the future-style handle with
                   deadlines, cooperative cancellation, and per-session
                   OpStats roll-ups;
  * ``gateway``  — :class:`Gateway`, multi-tenant admission (bounded queue,
                   FIFO-with-fairness) plus the worker pool that executes
                   plans through the shared runtime;
  * ``metrics``  — gateway-level throughput / latency tails / cross-query
                   cache hit rate;
  * ``index_registry`` — :class:`IndexRegistry`, process-wide retrieval-index
                   sharing: concurrent sessions over the same corpus trigger
                   exactly one embed+build (exact or IVF); streaming corpora
                   use versioned keys (``get_or_update``) so an append
                   embeds/indexes only the delta rows;
  * ``matview``  — :class:`MatViewRegistry`, multi-query subplan sharing:
                   concurrent sessions whose plans contain the same
                   fingerprinted subtree (normalized predicate + corpus
                   version) latch exactly one computation and serve the rest
                   from the materialization (``Gateway(matview=True)``).

Streaming corpora (``repro_torch.stream.CorpusTable``) plug in through
``Gateway.subscribe(pipeline)``: a continuous query re-executed on every
table commit, with the shared cache keeping re-executions delta-only.

    gw = Gateway(session, max_inflight=4, cache_ttl_s=600)
    handles = [gw.submit(sf.lazy().sem_filter(...)) for sf in frames]
    rows = [h.result() for h in handles]
    sub = gw.subscribe(table.lazy(session).sem_filter(...))
    print(gw.snapshot())
"""
from repro_torch.serve.dispatch import (DispatchedEmbedder, DispatchedModel,
                                        DispatchError, MicroBatchDispatcher)
from repro_torch.serve.gateway import AdmissionError, Gateway
from repro_torch.serve.index_registry import IndexRegistry
from repro_torch.serve.matview import MatViewRegistry, plan_fingerprint
from repro_torch.serve.metrics import GatewayMetrics
from repro_torch.serve.session import (ServeSession, SessionCancelled,
                                       SessionDeadlineExceeded)
from repro_torch.serve.store import SharedSemanticCache

__all__ = [
    "AdmissionError", "DispatchError", "DispatchedEmbedder",
    "DispatchedModel", "Gateway", "GatewayMetrics", "IndexRegistry",
    "MatViewRegistry", "MicroBatchDispatcher", "ServeSession",
    "SessionCancelled", "SessionDeadlineExceeded", "SharedSemanticCache",
    "plan_fingerprint",
]
