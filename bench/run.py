"""Run one cell of ``BENCHMARK.json`` once and print one JSON line.

    python3 bench/run.py --workload deepseek-7b.filter --seed 7 --seconds 45 --trace 0

From the root of a checkout.  ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics under the profiler.  The last
line of standard output is the result; the last lines of standard error
are the numbers the check compared, each beside its limit.  Exits non-zero,
with no result, when no CUDA card is there (or fewer than the cell asks
for), when the program is missing, or when the process has loaded ``jax``,
``jaxlib``, ``flax`` or the JAX package ``repro``.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache of the program stays at a fixed place inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden() -> list[str]:
    """Modules whose top-level name (before the first dot) is forbidden,
    compared whole: ``repro_torch`` is not ``repro``."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN})


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench.lib import manifest
    man = manifest.load()
    cell = manifest.cell(man, args.workload)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        log(f"{args.workload} needs {cell['chips']} CUDA card(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    try:
        import repro_torch
    except ImportError as err:
        log(f"the program repro_torch is not in this checkout: {err}")
        return 4
    repro_torch.set_device("cuda")
    device = torch.device("cuda", 0)

    from bench.lib import cell as cell_mod
    result = cell_mod.run(man, cell, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device=device, t_start=T_START, log=log)
    bad = loaded_forbidden()
    if bad:
        log(f"forbidden modules loaded in this process: {', '.join(bad)}")
        return 5
    log(f"correct {result['correct']} attempted {result['attempted']} failed {result['failed']}")
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
