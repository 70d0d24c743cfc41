"""Where the port runs: one explicit switch, CUDA unless the caller asks for
the CPU.

Every entry point that turns numpy input into tensors places them on
:func:`current_device`.  With no explicit choice that is ``cuda``; when no
CUDA device exists the call raises instead of carrying on on the CPU, so a
run that was meant for the card can never quietly measure the host.  Tests
and CPU-only callers say so once with ``set_device("cpu")``.

Every fp32 product of the port is IEEE fp32 (bf16 appears only where a
model config asks for it).  PyTorch may route fp32 matrix products through
TF32 tensor cores (10-bit mantissa) when these two flags are on, which
changes scores in the fourth digit and with them top-k ids, so they are
pinned off here, where the package is first imported.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_choice: torch.device | None = None


def set_device(device: str | torch.device | None) -> None:
    """Pin the port to ``device`` ("cuda", "cuda:1", "cpu"); ``None`` goes
    back to the default (CUDA, or an error when there is none)."""
    global _choice
    _choice = None if device is None else torch.device(device)


def current_device() -> torch.device:
    if _choice is not None:
        return _choice
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; call repro_torch.set_device('cpu') to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
