"""GQA flash attention, causal and/or sliding window: the hand-written CUDA
kernel ``csrc/flash_attention.cu`` behind ``ops.flash_attention``, which the
model's self-attention reaches under ``attn_impl="pallas"`` (and under the
configs' ``"auto"`` for activations on the card).  bf16 runs on the tensor
cores (``wgmma``, f32 accumulators); f32 stays IEEE f32 on the SIMT pipes.

:func:`flash_attention` takes CUDA tensors only; its plain version is
``ref.flash_attention_ref``, which ``ops`` runs for tensors on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attn_scale

launches = 0   # kernel launches since the caller last set this to 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel each dtype launches, by the name a profiler or cuobjdump shows
KERNEL_NAMES = {torch.float32: "flash_attention_simt_f32",
                torch.bfloat16: "flash_attention_wgmma_bf16"}
MAX_HEAD_DIM = 128

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_longlong] * 6 + \
    [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 window: int) -> None:
    """Raise on shapes the kernel does not take (a CPU-side check)."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"q [B,Sq,H,hd], k/v [B,Sk,Hk,hd] expected, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"{h} q-heads are not a multiple of {k.shape[2]} kv-heads")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} outside the kernel's 1..{MAX_HEAD_DIM}")
    if k.shape[1] == 0:
        raise ValueError("flash_attention needs at least one key")
    if window < 0:
        raise ValueError(f"window {window} < 0")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [B,Sq,H,hd], k/v [B,Sk,Hk,hd] (f32 or bf16, one type) ->
    [B,Sq,H,hd] in that type."""
    _build.require(q, "q", tuple(DTYPES), 4)
    _build.require(k, "k", q.dtype, 4, q.device)
    _build.require(v, "v", q.dtype, 4, q.device)
    check_shapes(q, k, v, window)
    b, sq, h, hd = q.shape
    sk, hk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _build.function("flash_attention", "repro_flash_attention", _ARGS)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), DTYPES[q.dtype],
            b, sq, sk, h, hk, hd, attn_scale(hd), int(causal), int(window),
            q.device.index, _build.stream_of(q))
    _build.check(rc, "flash_attention", "flash_attention kernel")
    _build.count_launch(globals())
    return out
