"""Flash-decoding, one new token per sequence against its KV cache: the
hand-written CUDA kernel ``csrc/decode_attention.cu`` behind
``ops.decode_attention``, which the model's decode step reaches for
activations on the card.

:func:`decode_attention` takes CUDA tensors only; its plain version is
``ref.decode_attention_ref``, which ``ops`` runs for tensors on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attn_scale

launches = 0   # kernel launches since the caller last set this to 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
BLOCK_K = 128      # key rows per tile of the kernel (csrc BK)

_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_longlong] * 5 + \
    [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p]


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lens: torch.Tensor, window: int) -> None:
    """Raise on shapes the kernel does not take (a CPU-side check)."""
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q [B,1,H,hd], k/v [B,S,Hk,hd] expected, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if tuple(lens.shape) != (b,):
        raise ValueError(f"lens must have shape ({b},), got {tuple(lens.shape)}")
    if k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"{h} q-heads are not a multiple of {k.shape[2]} kv-heads")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} outside the kernel's 1..{MAX_HEAD_DIM}")
    if k.shape[1] == 0:
        raise ValueError("decode_attention needs a cache of at least one position")
    if window < 0:
        raise ValueError(f"window {window} < 0")


def splits_for(b: int, hk: int, h: int, s: int, sms: int) -> int:
    """Blocks per (batch row, kv-head, group of up to 8 q-heads): enough to
    give each of the card's ``sms`` SMs about three (the most that fit
    beside each other in shared memory in bf16 at hd 128), never more than
    the cache has tiles; 1 when those blocks alone do."""
    blocks = b * hk * -(-(h // hk) // 8)
    return max(1, min(-(-s // BLOCK_K), -(-3 * sms // blocks)))


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lens: torch.Tensor, *, window: int = 0) -> torch.Tensor:
    """q [B,1,H,hd], k/v [B,S,Hk,hd] (f32 or bf16, one type), lens [B]
    int32 -> [B,1,H,hd] in that type."""
    global launches
    _build.require(q, "q", tuple(DTYPES), 4)
    _build.require(k, "k", q.dtype, 4, q.device)
    _build.require(v, "v", q.dtype, 4, q.device)
    _build.require(lens, "lens", torch.int32, 1, q.device)
    check_shapes(q, k, v, lens, window)
    b, _, h, hd = q.shape
    s, hk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    splits = splits_for(b, hk, h, s, sms)
    part = torch.empty(b * h * splits * (hd + 2) if splits > 1 else 0,
                       dtype=torch.float32, device=q.device)
    vec = (hd * q.element_size()) % 16 == 0 and k.data_ptr() % 16 == 0 \
        and v.data_ptr() % 16 == 0
    fn = _build.function("decode_attention", "repro_decode_attention", _ARGS)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr(),
            part.data_ptr() if splits > 1 else None, DTYPES[q.dtype], b, s, h, hk, hd,
            attn_scale(hd), int(window), splits, int(vec), q.device.index,
            _build.stream_of(q))
    _build.check(rc, "decode_attention", "decode_attention kernel")
    launches += 1
    return out
