"""The readings that the limits of ``correct`` are set from.

    python3 bench/calibrate.py --workload deepseek-7b.filter --seeds 101-112

For each seed, in one process: the cell's set-up as ``run.py`` makes it
(``lib/cell.prepare``), one call of the timed entry at the cell's own
sizes (not timed), the program's state freed, then the adapter's check
twice over the same sample: the program's numbers against the float32
reference, and the control's (the reference at float8 e4m3 in the
program's place) against the same float32 reference, each through the
cell's limits as ``run.py`` judges them.  One JSON line per seed on
standard output.  ``--fault`` plants the entry's fault in the program
first (a scored answer or a served token altered where it is produced).
``bench/run.py`` never runs this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from bench.lib import adapter as adapter_mod  # noqa: E402
from bench.lib import cell as cell_mod  # noqa: E402
from bench.lib import check, manifest  # noqa: E402


def seeds(spec: str) -> list[int]:
    out = []
    for part in spec.split(","):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b) + 1)) if b else [int(a)]
    return out


def readings(name: str, seed: int, *, device=None, fam=None, mix=None) -> dict:
    """The program's and the control's numbers and verdicts for one seed
    of cell ``name``."""
    man = manifest.load()
    cell = manifest.cell(man, name)
    dev = device or torch.device("cuda", 0)
    t0 = time.perf_counter()
    s = cell_mod.prepare(man, cell, seed=seed, device=dev, fam=fam, mix=mix)
    s.adapter.capture(s.table[: int(s.mix["check"].get("held", 0))])
    s.adapter.call(s.table[: int(s.mix["rows_per_call"])])
    adapter_mod.sync()
    t1 = time.perf_counter()
    s.adapter.release()
    lim = check.limits(name)
    prog = s.adapter.check(s.table, seed)
    ctrl = s.adapter.control()
    out = {"seed": seed, "program": prog, "control": ctrl,
           "program_correct": check.judge(prog, lim)[0],
           "control_correct": check.judge(ctrl, lim)[0],
           "calls_s": round(t1 - t0, 3), "check_s": round(time.perf_counter() - t1, 3)}
    del s
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault", action="store_true")
    args = ap.parse_args(argv)

    import repro_torch
    repro_torch.set_device("cuda")
    if args.fault:
        entry = cell_mod.mix_of(manifest.cell(manifest.load(), args.workload))["entry"]
        adapter_mod.load(entry).plant_fault()
    for seed in seeds(args.seeds):
        print(json.dumps(readings(args.workload, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
