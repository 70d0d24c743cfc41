"""Streaming corpus subsystem: versioned tables + continuous queries.

PRs 1-3 made one query cheap (plan IR), many concurrent queries cheap
(gateway), and retrieval sub-linear (IVF) — all over a *frozen* corpus.
This package makes the corpus itself a first-class, changing object:

  * ``table``      — :class:`CorpusTable`, rows with stable ids, a
                     monotonically versioned append/update/delete delta log,
                     replayable snapshots, and a commit change feed;
  * ``continuous`` — :class:`Subscription` / :class:`Emission`, the
                     continuous-query machinery behind
                     ``Gateway.subscribe(pipeline)``: re-execute on new
                     versions, delta-only model traffic via the shared
                     semantic cache, record-identical to a from-scratch run.

Incremental *index* maintenance lives with the indexes themselves
(``repro_torch.index``: ``RetrievalBackend.add``, the IVF delta side buffer +
drift-triggered retrain) and the version-aware sharing in
``repro_torch.serve.index_registry.IndexRegistry.get_or_update``.

    table = CorpusTable(records)
    with Gateway(session) as gw:
        sub = gw.subscribe(table.lazy(session).sem_filter("the {claim} holds"))
        first = sub.poll(timeout=30)          # full result at v1
        table.append(new_rows)                # -> only new rows hit the oracle
        delta = sub.poll(timeout=30)          # delta.added == new matches
"""
from repro_torch.stream.continuous import (Emission, Subscription,
                                           find_stream_tables, pin_stream_scans)
from repro_torch.stream.table import CorpusTable, DeltaSet

__all__ = [
    "CorpusTable", "DeltaSet", "Emission", "Subscription",
    "find_stream_tables", "pin_stream_scans",
]
