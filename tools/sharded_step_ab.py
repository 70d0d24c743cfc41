"""The sharded train step of this tree against another tree's, in one world
of ranks on one card: each step's wall, its peak memory above its start,
loss and grad norm.

    python3 tools/sharded_step_ab.py --other DIR [--ranks 4]

DIR is the root of another checkout; its ``src/repro_torch/dist/trainstep.py``
is loaded beside this tree's (the rest of the package is this tree's).  The
configuration is phase 20 (d) of ``chip_smoke.py``: llama3.2-3b's widths at
4 layers, vocabulary 384, a (2, 2) ("data", "model") mesh, 2 steps of 4 x
512 tokens, in f32 and in bf16 activations; the two versions run in the
order other, this, this, other from the same start.  Rank 0 prints one JSON
line a step.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import datetime
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def rank_main(rank: int, ranks: int, other: str, rdzv: str) -> None:
    import chip_smoke as cs
    import repro_torch
    from repro_torch.dist import sharding as shd
    from repro_torch.dist import trainstep as this
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.train import optimizer as opt
    spec = importlib.util.spec_from_file_location(
        "other_trainstep", os.path.join(other, "src", "repro_torch", "dist", "trainstep.py"))
    that = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(that)
    repro_torch.set_device("cuda")
    dist.init_process_group("gloo", init_method=f"file://{rdzv}", world_size=ranks, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_test_mesh((ranks // 2, 2), ("data", "model"))
        for dt in ("float32", "bfloat16"):
            cfg = cs.get_config(cs.DIST_ARCH).with_(vocab_size=cs.DIST_VOCAB,
                                                    num_layers=cs.TS_LAYERS, dtype=dt)
            ocfg = opt.OptimizerConfig(total_steps=cs.TS_STEPS, warmup_steps=0)
            pspecs = cs.registry.param_specs(cfg)
            psh = shd.spec_shardings(pspecs, mesh)
            ssh = shd.spec_shardings(opt.state_specs(pspecs, ocfg), mesh)
            params = cs.registry.init_params(cfg, cs.dist_gen(0))
            state = opt.init_state(params, ocfg)
            for name, mod in (("other", that), ("this", this), ("this", this),
                              ("other", that)):
                lp, ls = shd.place_tree(params, psh), shd.place_tree(state, ssh)
                step = mod.make_sharded_train_step(cfg, ocfg, mesh)
                for i, batch in enumerate(cs.ts_batches(cfg, 0)):
                    cs.free_card()
                    torch.cuda.synchronize()
                    start = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    t0 = time.perf_counter()
                    lp, ls, m = step(lp, ls, batch)
                    torch.cuda.synchronize()
                    line = {"dtype": dt, "version": name, "step": i,
                            "wall_s": time.perf_counter() - t0,
                            "peak_above_start_gib":
                                (torch.cuda.max_memory_allocated() - start) / 2**30,
                            "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
                    if rank == 0:
                        print(json.dumps(line), flush=True)
                del lp, ls
            del params, state
            cs.free_card()
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True)
    ap.add_argument("--ranks", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("sharded_step_ab.py needs a CUDA device; none is available")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    from repro_torch.kernels import _build
    print(f"kernels built in {_build.build():.1f} s (once, before the ranks start)", flush=True)
    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(rank_main, args=(args.ranks, os.path.abspath(args.other),
                                            os.path.join(d, "rdzv")),
                           nprocs=args.ranks, start_method="spawn")


if __name__ == "__main__":
    main()
