"""How far two correct computations of a recurrent model's first decode step
part, on one CUDA card: the bound that ``chip_smoke.py`` phase 18's
first-step check (``REC_FIRST_STEP_BF16_TOL``) must sit above.

    python3 tools/recurrent_drift.py [--config zamba2-7b] [--seed N]

The config at its published size, random weights drawn on the card from
``--seed`` (as ``InferenceEngine`` draws them).  For prompts of 1 and 2
tokens and two of ``chip_smoke.oracle_prompts``, each followed by one fed
token, in bf16 and in f32 activations (the same bf16 weights), under
``attn_impl`` ``"auto"`` (the kernels) and ``"chunked"``, it prints three
max abs log-prob distances from the teacher-forced ``forward`` over prompt
+ token at batch 1:

- the true-length prefill and one decode step (``chip_smoke.forced_decode``);
- the same forward with a second, longer row beside it in the batch (the
  row's own positions are causal, so only the rounding of the batched
  products can move them);
- the prefill's own last logits against the forward over the prompt.

Each line carries the card's name and power limit.  It exits non-zero
without a card.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import chip_smoke as cs  # noqa: E402
from repro_torch.models import registry  # noqa: E402


def log_probs(logits: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(logits.float(), dim=-1)


@torch.inference_mode()
def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=cs.ZAMBA)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("recurrent_drift.py needs a CUDA device; none is available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    cs._build.build()
    engine = cs.rec_engine(args.config, args.seed, max_slots=1, max_seq=1024)
    cfg, params = engine.cfg, engine.runner.params
    prompts = [cs.TOKENIZER.encode(p) for p in cs.REC_SHORT + cs.oracle_prompts(2, 40)]
    other = torch.tensor([cs.TOKENIZER.encode(cs.oracle_prompts(1, 41)[0])[:600]],
                         device="cuda")
    tok = 65
    for dtype in ("bfloat16", "float32"):
        for impl in ("auto", "chunked"):
            c = cfg.with_(dtype=dtype, attn_impl=impl)
            for p in prompts:
                seq = torch.tensor([p + [tok]], device="cuda")
                alone = log_probs(registry.forward(c, params, seq)[0][0, -1])
                lp, _ = cs.forced_decode(c, params, seq[:, :-1],
                                         torch.tensor([[tok, tok]], device="cuda"), steps=2)
                both = torch.zeros((2, max(seq.shape[1], other.shape[1])), dtype=torch.long,
                                   device="cuda")
                both[0, :seq.shape[1]] = seq[0]
                both[1, :other.shape[1]] = other[0]
                batched = log_probs(registry.forward(c, params, both)[0][0, seq.shape[1] - 1])
                prefix = log_probs(registry.forward(c, params, seq[:, :-1])[0][0, -1])
                print(f"{cfg.name} on {smi}, {dtype}, attn_impl {impl}, prompt {len(p)} "
                      f"tokens: prefill + decode step vs forward "
                      f"{float((lp[0, 1] - alone).abs().max()):.4g}; forward in a batch of "
                      f"two vs alone {float((batched - alone).abs().max()):.4g}; prefill "
                      f"logits vs forward {float((lp[0, 0] - prefix).abs().max()):.4g}",
                      flush=True)


if __name__ == "__main__":
    main()
