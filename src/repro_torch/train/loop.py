"""Training loop: resume-from-checkpoint, periodic async checkpoints,
SIGTERM/SIGINT preemption save, straggler-tolerant prefetch.

The torch form of ``repro.train.loop``.  It runs on
``repro_torch.current_device()``: the card unless the caller chose the CPU.
Fresh params are drawn by ``registry.init_params`` from a generator seeded
with ``LoopConfig.seed`` on that device (torch cannot replay the
reference's ``jax.random`` draws); a resumed run reads params and optimizer
state from the checkpoint, which may be the reference's.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable

import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.common import tree_to
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import Prefetcher, SyntheticSource, packed_batch
from repro_torch.device import current_device
from repro_torch.models import registry
from repro_torch.train import optimizer as opt
from repro_torch.train.trainstep import make_train_step


@dataclasses.dataclass
class LoopConfig:
    steps: int = 100
    batch: int = 8
    seq_len: int = 128
    microbatches: int = 1
    ckpt_dir: str = "/tmp/repro_ckpt"
    ckpt_every: int = 50
    log_every: int = 10
    keep: int = 3
    seed: int = 0
    compress_grads: bool = False
    shard_id: int = 0
    num_shards: int = 1


def run(cfg: ModelConfig, opt_cfg: opt.OptimizerConfig, loop: LoopConfig,
        *, source=None, log: Callable[[str], None] = print, saver=None) -> dict:
    """Train (or resume) a model; returns final metrics.  ``saver`` takes the
    checkpoints (``save(step, trees)``, ``wait()``); by default an
    ``AsyncCheckpointer`` on ``loop.ckpt_dir``."""
    device = current_device()
    source = source or SyntheticSource(seed=loop.seed)
    step0 = 0
    resumed = ckpt.latest_step(loop.ckpt_dir)
    if resumed is not None:
        step0, trees = ckpt.load(loop.ckpt_dir)
        params = tree_to(trees["params"], device)
        opt_state = tree_to(trees["opt_state"], device)
        log(f"[train] resumed from step {step0}")
    else:
        params = registry.init_params(cfg, torch.Generator(device=device).manual_seed(loop.seed))
        opt_state = opt.init_state(params, opt_cfg)

    err_buf = None
    if loop.compress_grads:
        from repro_torch.train.grad_compress import init_error_buffer
        err_buf = init_error_buffer(params)

    step_fn = make_train_step(cfg, opt_cfg, microbatches=loop.microbatches,
                              compress=loop.compress_grads)

    saver = saver or ckpt.AsyncCheckpointer(loop.ckpt_dir, keep=loop.keep)
    preempted = {"flag": False}

    def handle(sig, frame):  # preemption: save and stop cleanly
        preempted["flag"] = True

    old_handlers = {s: signal.signal(s, handle) for s in (signal.SIGTERM, signal.SIGINT)}

    def make_batch(step: int) -> dict:
        return packed_batch(source, step, batch=loop.batch, seq_len=loop.seq_len,
                            shard_id=loop.shard_id, num_shards=loop.num_shards,
                            seed=loop.seed)

    pre = Prefetcher(make_batch).start(from_step=step0)
    metrics: dict[str, Any] = {}
    t0 = time.time()
    tokens_done = 0
    try:
        for step in range(step0, loop.steps):
            batch = pre.get(step)
            batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
            if loop.compress_grads:
                params, opt_state, err_buf, metrics = step_fn(params, opt_state, batch, err_buf)
            else:
                params, opt_state, metrics = step_fn(params, opt_state, batch)
            tokens_done += loop.batch * loop.seq_len
            if (step + 1) % loop.log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                tps = tokens_done / max(time.time() - t0, 1e-9)
                log(f"[train] step {step+1} loss={m.get('loss', float('nan')):.4f} "
                    f"grad_norm={m.get('grad_norm', 0):.3f} lr={m.get('lr', 0):.2e} tok/s={tps:.0f}")
            if (step + 1) % loop.ckpt_every == 0 or step + 1 == loop.steps or preempted["flag"]:
                saver.save(step + 1, {"params": params, "opt_state": opt_state})
            if preempted["flag"]:
                log(f"[train] preemption signal — checkpointed at step {step+1}, exiting")
                break
    finally:
        pre.stop()
        saver.wait()
        for s, h in old_handlers.items():
            signal.signal(s, h)
    return {k: float(v) for k, v in metrics.items()} | {
        "last_step": step + 1 if loop.steps > step0 else step0,
        "stragglers": pre.stragglers,
    }
