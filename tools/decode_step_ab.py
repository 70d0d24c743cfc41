"""The llama3.2-3b decode step of several trees in turns on one card: each
step's wall on the host's clock, as the generate phase (``chip_smoke.py``
phase 11) shapes it, with no engine around it.

    python3 tools/decode_step_ab.py TREE [TREE ...] [--steps 50] [--rounds 2]

A TREE is the root of a checkout of this repository; to compare against a
parent, unpack it (``git archive``) into an ignored directory.  Each tree
runs in a process of its own (``repro_torch`` from that tree, its kernels
built into its own ``build/kernels/``), in the order A B B A ... over
``--rounds`` rounds.  A run draws llama3.2-3b at its catalog config with
the vocabulary cut to 384 (phase 11's oracle; 28 layers, bf16) from seed
0, fills a cache of 32 slots x 1024 positions with random K/V, and times
``--steps`` calls of ``registry.decode_step`` (one token a slot, the slots'
lengths spread over 0..1023 and advanced by one a step; each step ends in a
synchronize) after 5 warm-up steps: the ``decode_attention`` kernel's path
on the card, whose 28 calls a step pass the model's cost scopes.  Prints
the card's name and power limit, a JSON line a run and a summary a tree.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def child(tree: str, steps: int) -> None:
    tree = os.path.abspath(tree)
    sys.path.insert(0, os.path.join(tree, "src"))
    import torch

    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import registry

    if not repro_torch.__file__.startswith(tree):
        sys.exit(f"imported {repro_torch.__file__}, not {tree}'s repro_torch")
    _build.build()
    cfg = get_config("llama3.2-3b").with_(vocab_size=384)
    g = torch.Generator(device="cuda").manual_seed(0)
    params = registry.init_params(cfg, g)
    slots, seq = 32, 1024
    cache = registry.init_cache(cfg, slots, seq, device=torch.device("cuda"))
    for entry in cache.values():
        for t in entry.values():
            t.normal_(generator=g)
    lens = torch.randint(0, seq - steps - 8, (slots,), generator=g, device="cuda",
                         dtype=torch.int32)
    toks = torch.randint(0, cfg.vocab_size, (slots, 1), generator=g, device="cuda")
    walls = []
    with torch.no_grad():
        for i in range(5 + steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = registry.decode_step(cfg, params, toks, cache, lens + i)
            torch.cuda.synchronize()
            if i >= 5:
                walls.append(time.perf_counter() - t0)
    assert bool(torch.isfinite(logits).all())
    print(json.dumps({"walls_ms": [w * 1e3 for w in walls]}))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--child", default=None)
    args = ap.parse_args()
    if args.child is not None:
        child(args.child, args.steps)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"device: {smi}", flush=True)
    order = []
    for r in range(args.rounds):
        order += args.trees if r % 2 == 0 else args.trees[::-1]
    runs: dict[str, list[list[float]]] = {t: [] for t in args.trees}
    for tree in order:
        res = subprocess.run([sys.executable, __file__, "_", "--child", tree,
                              "--steps", str(args.steps)], capture_output=True, text=True)
        if res.returncode != 0:
            sys.exit(f"{tree} failed:\n{res.stdout[-4000:]}\n{res.stderr[-4000:]}")
        walls = json.loads(res.stdout.strip().splitlines()[-1])["walls_ms"]
        runs[tree].append(walls)
        print(f"ran {tree}: median {statistics.median(walls):.3f} ms (quartiles "
              f"{statistics.quantiles(walls, n=4)[0]:.3f}, "
              f"{statistics.quantiles(walls, n=4)[2]:.3f})", flush=True)
    for tree, rs in runs.items():
        walls = [w for r in rs for w in r]
        print(f"{tree}: decode step wall median {statistics.median(walls):.3f} ms (min "
              f"{min(walls):.3f}, max {max(walls):.3f}, {len(walls)} steps); each run's "
              "median " + ", ".join(f"{statistics.median(r):.3f}" for r in rs) + " ms",
              flush=True)


if __name__ == "__main__":
    main()
