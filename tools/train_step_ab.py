"""The llama3.2-3b train step of several trees in turns on one card: each
step's wall, the device's busy time and the attention kernels' share of it,
and the host's own time, as ``chip_smoke.py``'s phase 19 runs the step.

    python3 tools/train_step_ab.py TREE [TREE ...] [--steps 4] [--rounds 2]

A TREE is the root of a checkout of this repository; to compare against a
parent, unpack it (``git archive``) into an ignored directory.  Each tree
runs in a process of its own (``chip_smoke`` and ``repro_torch`` from that
tree, its kernels built into its own ``build/kernels/``), in the order A B
B A ... over ``--rounds`` rounds.  A run draws llama3.2-3b at its catalog
config (28 layers, bf16, remat, the default AdamW) from seed 0, takes one
warm-up step of phase 19's first batch (4 x 512 tokens in 2 microbatches),
then ``--steps`` timed steps (host clock around a step that ends in a
synchronize), one step under the profiler's CUDA activity (busy time as
the union of the device records; the ``flash_attention`` backward and
forward families by kernel name) and one under its CPU activity (the sum
of every op's self CPU time: the host's work in a step).  Prints the
card's name and power limit, a JSON line a run, and a summary a tree.
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
    sys.path.insert(0, tree)
    import chip_smoke as cs   # puts the tree's own src/ first on sys.path
    import numpy as np
    import torch

    if not cs.__file__.startswith(tree):
        sys.exit(f"imported {cs.__file__}, not {tree}'s chip_smoke")
    cs._build.build()
    cfg = cs.get_config(cs.TRAIN)
    ocfg = cs.opt.OptimizerConfig()
    params = cs.registry.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    state = cs.opt.init_state(params, ocfg)
    step = cs.trainstep.make_train_step(cfg, ocfg, microbatches=cs.TRAIN_MICRO)
    toks, labels = cs.train_batch(0)
    batch = {"tokens": toks, "labels": labels}
    step(params, state, batch)
    torch.cuda.synchronize()
    walls = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step(params, state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    acts = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[acts.CUDA]) as prof:
        step(params, state, batch)
        torch.cuda.synchronize()
    dev = torch.autograd.DeviceType.CUDA
    recs = [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
            if e.device_type() == dev]
    busy = cs.union_ns(np.array([r[1:] for r in recs], np.int64)) / 1e6 if recs else None
    fam = {f: sum(b - a for n, a, b in recs if name in n) / 1e6
           for f, name in (("backward_ms", "flash_attention_bwd"),
                           ("forward_ms", cs.kfa.KERNEL_NAMES[torch.bfloat16]))}
    with torch.profiler.profile(activities=[acts.CPU]) as prof:
        step(params, state, batch)
        torch.cuda.synchronize()
    host = sum(e.self_cpu_time_total for e in prof.key_averages()) / 1e3
    print(json.dumps({"walls": walls, "busy_ms": busy, **fam, "host_self_cpu_ms": host}))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--steps", type=int, default=4)
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
    runs: dict[str, list[dict]] = {t: [] for t in args.trees}
    for tree in order:
        res = subprocess.run([sys.executable, __file__, "_", "--child", tree,
                              "--steps", str(args.steps)], capture_output=True, text=True)
        if res.returncode != 0:
            sys.exit(f"{tree} failed:\n{res.stdout[-4000:]}\n{res.stderr[-4000:]}")
        runs[tree].append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(f"ran {tree}: {json.dumps(runs[tree][-1])}", flush=True)
    for tree, rs in runs.items():
        walls = [w for r in rs for w in r["walls"]]
        print(f"{tree}: step wall median {statistics.median(walls):.4f} s (min "
              f"{min(walls):.4f}, max {max(walls):.4f}, {len(walls)} steps); one profiled step "
              f"a run: busy " + ", ".join(f"{r['busy_ms']:.1f}" for r in rs)
              + " ms, flash_attention backward " + ", ".join(f"{r['backward_ms']:.2f}" for r in rs)
              + " ms, forward " + ", ".join(f"{r['forward_ms']:.2f}" for r in rs)
              + " ms; host self CPU " + ", ".join(f"{r['host_self_cpu_ms']:.1f}" for r in rs)
              + " ms", flush=True)


if __name__ == "__main__":
    main()
