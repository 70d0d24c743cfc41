"""Training entry point.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b --steps 3 \\
        [--batch 4 --seq-len 512 --microbatches 2] [--smoke --device cpu]

It trains on the card (``--device cpu`` asks for the CPU).  Several
processes, as the reference's multi-host run:

    ... --coordinator host:port --num-processes N --process-id i

Each process joins a ``torch.distributed`` world over the coordinator's
address (gloo on the CPU, nccl on the card) and trains on its data shard
(``shard_id=i``, ``num_shards=N``).  As in the reference, the loop takes no
mesh and exchanges no gradients, and every process saves into
``--ckpt-dir``, so processes run at once want a directory each.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import torch.distributed as dist

import repro_torch
from repro_torch.configs import get_config, get_smoke
from repro_torch.data.tokenizer import TOKENIZER
from repro_torch.train import optimizer as opt
from repro_torch.train.loop import LoopConfig, run

# the checkout's ignored build/ directory, not a path outside the checkout
CKPT_DIR = Path(__file__).resolve().parents[3] / "build" / "train_ckpt"


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=str(CKPT_DIR))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    # multi-host
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    args = ap.parse_args(argv)

    if args.device:
        repro_torch.set_device(args.device)
    if args.coordinator:
        backend = "gloo" if repro_torch.current_device().type == "cpu" else "nccl"
        dist.init_process_group(backend, init_method=f"tcp://{args.coordinator}",
                                world_size=args.num_processes, rank=args.process_id)
    try:
        return _train(args)
    finally:
        if args.coordinator:
            dist.destroy_process_group()


def _train(args) -> dict:
    cfg = (get_smoke(args.arch) if args.smoke else get_config(args.arch))
    cfg = cfg.with_(vocab_size=TOKENIZER.vocab_size) if args.smoke else cfg
    loop = LoopConfig(steps=args.steps, batch=args.batch, seq_len=args.seq_len,
                      microbatches=args.microbatches, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every,
                      compress_grads=args.compress_grads,
                      shard_id=args.process_id, num_shards=args.num_processes)
    ocfg = opt.OptimizerConfig(learning_rate=args.lr, total_steps=args.steps,
                               warmup_steps=max(args.steps // 20, 1))
    metrics = run(cfg, ocfg, loop)
    print("[train] final:", metrics)
    return metrics


if __name__ == "__main__":
    main()
