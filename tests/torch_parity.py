"""Helpers shared by the port's parity tests of the semantic layer
(``test_torch_operators.py``, ``test_torch_plan.py``): stats without wall
times, records with their similarity scores held to a stated tolerance, and
the cosine planes an operator scores recorded or replayed.

The cascade join and the cascade group-by read thresholds from cosine
planes that the port (torch) and the reference (jnp) compute to within
SCORE_TIE of each other.  Where a world's scores tie within that (the
cascade join's projected plane pairs each article with a copy of its
label's own vector, so its true pairs all score 1.0 up to rounding), the
frameworks may rank the tied pairs in another order and a threshold read
from the ranks can part.  ``with_planes`` therefore runs the port twice,
on its own planes and on the reference's, and reports how many tied scores
changed order; the tests require the replay to be identical always and the
port's own run wherever no tied score changed order.
"""
import numpy as np

from repro.index.vector_index import VectorIndex as JIndex
from repro_torch.index.quantile import quantile_calibrate
from repro_torch.index.vector_index import VectorIndex as TIndex

SCORE_TIE = 1e-6   # the frameworks' cosine scores of the same unit vectors
SIM_TOL = 1e-5     # a sim-join record's ``sim_score`` (f32 sums in another order)


def no_wall(st: dict) -> dict:
    return {k: v for k, v in st.items() if k != "wall_s"}


def logs(stats_log: list) -> list[dict]:
    return [no_wall(st) for st in stats_log]


def same_records(got: list[dict], want: list[dict]) -> bool:
    """Identical records, but ``sim_score`` within SIM_TOL."""
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if g.keys() != w.keys():
            return False
        for k, v in g.items():
            if k == "sim_score":
                if abs(v - w[k]) > SIM_TOL:
                    return False
            elif v != w[k]:
                return False
    return True


class Planes:
    """Stands in for an operator module's ``VectorIndex``: records every
    cosine plane the operator scores with ``pairwise``, or returns the
    given planes, in order, in their place."""

    def __init__(self, index_cls, replay=None):
        self.planes: list[np.ndarray] = []
        replay = None if replay is None else list(replay)
        planes = self.planes

        class Index(index_cls):
            def pairwise(self, queries):
                out = super().pairwise(queries)
                if replay is not None:
                    want = replay.pop(0)
                    assert want.shape == out.shape
                    out = want
                planes.append(out)
                return out
        self.cls = Index


def order_changes(got: list, want: list) -> int:
    """Hold the port's planes to the reference's within SCORE_TIE and print
    the tied scores whose order differs between them.  -> their count."""
    assert len(got) == len(want)
    changed = 0
    for g, w in zip(got, want):
        assert g.shape == w.shape and float(np.abs(g - w).max()) <= SCORE_TIE
        at = np.flatnonzero(quantile_calibrate(g).ravel() != quantile_calibrate(w).ravel())
        if len(at):
            print(f"tied scores in another order (port, reference), tolerance {SCORE_TIE}:",
                  [(float(g.flat[i]), float(w.flat[i])) for i in at[:12]])
        changed += len(at)
    return changed


def with_planes(monkeypatch, run, tmod, jmod):
    """``run(mod)`` with ``mod`` the port's and then the reference's module
    whose ``VectorIndex`` scores the planes; then the port's again on the
    reference's planes.  -> (port output, reference output, port output on
    the reference's planes, number of tied scores in another order)."""
    tp, jp = Planes(TIndex), Planes(JIndex)
    monkeypatch.setattr(tmod, "VectorIndex", tp.cls)
    monkeypatch.setattr(jmod, "VectorIndex", jp.cls)
    t, j = run(tmod), run(jmod)
    monkeypatch.setattr(tmod, "VectorIndex", Planes(TIndex, jp.planes).cls)
    return t, j, run(tmod), order_changes(tp.planes, jp.planes)
