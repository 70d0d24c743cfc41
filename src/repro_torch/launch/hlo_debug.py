"""Dry-run profiler: the top byte / FLOP contributors of a cell's step, the
port's counterpart of the reference's walk over a cell's HLO with loop-trip
multipliers -- the 'profile' of the §Perf hypothesis loop.

The step runs once under the cost counter (``hlo_analysis.CostMode`` with
rows): identical (op, shapes, scope) calls are grouped, and their count
takes the place of the reference's trip multiplier.

    PYTHONPATH=src python -m repro_torch.launch.hlo_debug --arch zamba2-7b --shape train_4k
"""
from __future__ import annotations

import argparse

from repro_torch.launch.hlo_analysis import Costs


def top_contributors(costs: Costs, n: int = 20):
    """(the ``n`` heaviest rows, every row) of a counted run
    (``hlo_analysis.analyze(..., rows=True)``), each row (bytes, FLOPs,
    count, op, scope, shapes), heaviest bytes first."""
    rows = [(b, f, cnt, op, scope, shapes)
            for (op, shapes, scope), (cnt, f, b) in (costs.rows or {}).items()]
    rows.sort(key=lambda r: (r[0], r[1]), reverse=True)
    return rows[:n], rows


def cell_costs(arch: str, shape: str, mesh_name: str, *, rules=None, microbatches=None
               ) -> Costs:
    """One dry-run trace of a cell with its rows."""
    from repro_torch.launch import dryrun, hlo_analysis
    with dryrun.fake_world(dryrun.world_size(mesh_name)):
        mesh = dryrun.make_mesh(mesh_name)
        traced, meta = dryrun.build_cell(arch, shape, mesh, rules=rules,
                                         microbatches=microbatches)
        if traced is None:
            raise SystemExit(f"{arch} x {shape}: skipped ({meta['skipped']})")
        return hlo_analysis.analyze(traced.fn, *traced.args, rows=True)


def cell_rows(arch: str, shape: str, mesh_name: str, **kw) -> list:
    """Every grouped row of a cell as JSON-ready lists."""
    return [list(r) for r in top_contributors(cell_costs(arch, shape, mesh_name, **kw))[1]]


def print_table(costs: Costs, top: int) -> None:
    rows, every = top_contributors(costs, top)
    total_b = sum(r[0] for r in every)
    total_f = sum(r[1] for r in every)
    print(f"total bytes/dev {total_b/1e9:.1f}GB  flops/dev {total_f/1e12:.2f}T")
    print(f"{'GB':>9} {'GF':>9} {'x':>6} {'op':28} {'scope':10} shapes")
    for b, f, cnt, op, sc, shapes in rows:
        print(f"{b/1e9:9.2f} {f/1e9:9.1f} {cnt:6d} {op[:28]:28} {sc:10} {shapes[:90]}")
    print("memory:", {k: round(costs.memory.get(k, 0.0) / 1e9, 2)
                      for k in ("argument", "output", "temp", "alias")})


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--rules", default=None)
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args()
    print_table(cell_costs(args.arch, args.shape, args.mesh, rules=args.rules), args.top)


if __name__ == "__main__":
    main()
