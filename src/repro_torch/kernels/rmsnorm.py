"""Fused RMSNorm: the hand-written CUDA kernel ``csrc/rmsnorm.cu`` behind
``ops.rmsnorm``.  As in the reference, the models call the plain
``models.layers.rmsnorm``, which does the same math; the kernel is reached
through ``ops.rmsnorm``.  Rows of up to 8192 bf16 / 4096 f32 values, 16-byte
aligned, are held in registers by persistent blocks and read once; wider
or unaligned rows take a two-pass fallback.

:func:`rmsnorm` takes CUDA tensors only; its plain version is
``ref.rmsnorm_ref``, which ``ops`` runs for tensors on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0   # kernel launches since the caller last set this to 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                                 ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def cost(rows: int, d: int, *, itemsize: int = 2) -> tuple[int, int]:
    """(FLOPs, bytes) of one launch, as its bound counts them: 4 FLOPs a
    value; x read and the output written once, the f32 scale read."""
    return 4 * rows * d, 2 * rows * d * itemsize + 4 * d


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """x [..., d] (f32 or bf16), scale [d] f32 -> like ``x``."""
    if not isinstance(x, torch.Tensor) or x.dim() == 0:
        raise ValueError("x must be a tensor of rank >= 1")
    _build.require(x, "x", tuple(DTYPES), x.dim())
    _build.require(scale, "scale", torch.float32, 1, x.device)
    d = x.shape[-1]
    if scale.shape[0] != d:
        raise ValueError(f"scale has {scale.shape[0]} entries, x rows have {d}")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    fn = _build.function("rmsnorm", "repro_rmsnorm", _ARGS)
    rc = fn(x.data_ptr(), scale.data_ptr(), out.data_ptr(), DTYPES[x.dtype],
            x.numel() // d, d, eps, x.device.index, _build.stream_of(x))
    _build.check(rc, "rmsnorm", "rmsnorm kernel")
    _build.count_launch(globals())
    if _build.cost_counter is not None:
        _build.cost_counter("rmsnorm", lambda: cost(x.numel() // d, d,
                                                    itemsize=x.element_size()))
    return out
