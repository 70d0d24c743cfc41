"""GQA flash attention, causal and/or sliding window: the hand-written CUDA
kernel ``csrc/flash_attention.cu`` behind ``ops.flash_attention``, which the
model's self-attention reaches under ``attn_impl="pallas"`` (and under the
configs' ``"auto"`` for activations on the card).  bf16 runs on the tensor
cores (``wgmma``, f32 accumulators); f32 stays IEEE f32 on the SIMT pipes.

Its gradient is the hand-written kernel ``csrc/flash_attention_bwd.cu``
(:func:`flash_attention_bwd`); :class:`FlashAttention` binds the two as one
``torch.autograd.Function``, which ``ops.flash_attention`` calls on the
card, so a backward pass through the model's attention runs the kernel
pair.  The forward saves q, k, v and its output, and in bf16 each row's
softmax max and sum (``return_stats``); the backward recomputes the scores.
bf16 runs on the tensor cores there too; f32 on the SIMT pipes, which
recompute the row statistics themselves.

Both take CUDA tensors only; their plain versions are
``ref.flash_attention_ref`` and ``ref.flash_attention_bwd_ref``, which
``ops`` and the tests run for tensors on the CPU.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attn_scale

launches = 0            # forward launches since the caller last set this to 0
backward_launches = 0   # backward launches (csrc/flash_attention_bwd.cu), likewise

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel each dtype launches, by the name a profiler or cuobjdump shows
KERNEL_NAMES = {torch.float32: "flash_attention_simt_f32",
                torch.bfloat16: "flash_attention_wgmma_bf16"}
# the backward's two kernels for each dtype; every name holds
# "flash_attention_bwd"
BWD_KERNEL_NAMES = {torch.float32: ("flash_attention_bwd_dq", "flash_attention_bwd_dkdv"),
                    torch.bfloat16: ("flash_attention_bwd_dq_wgmma_bf16",
                                     "flash_attention_bwd_dkdv_wgmma_bf16")}
MAX_HEAD_DIM = 128

_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_longlong] * 6 + \
    [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] + [ctypes.c_longlong] * 6 + \
    [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def pairs(sq: int, sk: int, *, causal: bool, window: int) -> int:
    """The unmasked (q, k) pairs of one head: positions count from 0 on both
    axes (``ref.flash_attention_ref``); causal keeps k <= q, a window keeps
    q - k < window."""
    i = np.arange(sq, dtype=np.int64)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros_like(i)
    hi = np.minimum(i, sk - 1) if causal else np.full_like(i, sk - 1)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def cost(b: int, sq: int, sk: int, h: int, hk: int, hd: int, *, causal: bool = True,
         window: int = 0, itemsize: int = 2, stats: bool = False) -> tuple[int, int]:
    """(FLOPs, bytes) of one forward launch, as its bound counts them: the S
    and PV products over the unmasked pairs (4 B H hd a pair); q, k, v read
    once and the output written once, and with ``stats`` the f32 row
    statistics [2, B, H, Sq] written too."""
    flops = 4 * b * h * hd * pairs(sq, sk, causal=causal, window=window)
    nbytes = itemsize * 2 * (b * sq * h * hd + b * sk * hk * hd) + (8 * b * h * sq if stats else 0)
    return flops, nbytes


def backward_cost(b: int, sq: int, sk: int, h: int, hk: int, hd: int, *, causal: bool = True,
                  window: int = 0, itemsize: int = 2, stats: bool = False) -> tuple[int, int]:
    """(FLOPs, bytes) of one backward call, as its bound counts them: S, dP,
    dV, dK and dQ over the unmasked pairs (10 B H hd a pair); q, k, v, out
    and dout read once and dq, dk, dv written once, and with ``stats`` the
    forward's row statistics read too."""
    flops = 10 * b * h * hd * pairs(sq, sk, causal=causal, window=window)
    nbytes = itemsize * 4 * (b * sq * h * hd + b * sk * hk * hd) + (8 * b * h * sq if stats else 0)
    return flops, nbytes


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
                    causal: bool = True, window: int = 0, return_stats: bool = False):
    """q [B,Sq,H,hd], k/v [B,Sk,Hk,hd] (f32 or bf16, one type) ->
    [B,Sq,H,hd] in that type.  With ``return_stats`` -> (out, stats): in
    bf16 the same launch also writes each row's max m and sum l of its
    softmax, f32 [2, B, H, Sq] (``ref.flash_attention_stats_ref``), which
    :func:`flash_attention_bwd` reads; in f32 stats is None (its backward
    recomputes them).  Inference passes no stats pointer."""
    _build.require(q, "q", tuple(DTYPES), 4)
    _build.require(k, "k", q.dtype, 4, q.device)
    _build.require(v, "v", q.dtype, 4, q.device)
    check_shapes(q, k, v, window)
    b, sq, h, hd = q.shape
    sk, hk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    stats = None
    if return_stats and q.dtype == torch.bfloat16:
        stats = torch.empty((2, b, h, sq), dtype=torch.float32, device=q.device)
    if out.numel() > 0:
        fn = _build.function("flash_attention", "repro_flash_attention", _ARGS)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if stats is None else stats.data_ptr(), DTYPES[q.dtype],
                b, sq, sk, h, hk, hd, attn_scale(hd), int(causal), int(window),
                q.device.index, _build.stream_of(q))
        _build.check(rc, "flash_attention", "flash_attention kernel")
        _build.count_launch(globals())
        if _build.cost_counter is not None:
            _build.cost_counter("flash_attention", lambda: cost(
                b, sq, sk, h, hk, hd, causal=causal, window=window,
                itemsize=q.element_size(), stats=stats is not None))
    return (out, stats) if return_stats else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor, *, causal: bool = True,
                        window: int = 0, stats: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of :func:`flash_attention`: q/out/dout [B,Sq,H,hd], k/v
    [B,Sk,Hk,hd] (f32 or bf16, one type), ``out`` the forward's output and
    ``dout`` its gradient -> (dq, dk, dv) in that type.  bf16 needs the
    forward's ``stats`` (``flash_attention(..., return_stats=True)``) and
    runs on the tensor cores; f32 takes none and runs on the SIMT pipes.
    Two launches on the current stream (the q tiles' pass, then the kv
    tiles'), counted as one; no atomics, so two calls give the same bits."""
    _build.require(q, "q", tuple(DTYPES), 4)
    for t, what in ((k, "k"), (v, "v"), (out, "out"), (dout, "dout")):
        _build.require(t, what, q.dtype, 4, q.device)
    check_shapes(q, k, v, window)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout {tuple(dout.shape)} must have "
                         f"q's shape {tuple(q.shape)}")
    b, sq, h, hd = q.shape
    sk, hk = k.shape[1], k.shape[2]
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        if stats is None:
            raise ValueError("the bf16 backward reads the forward's row statistics: pass "
                             "stats from flash_attention(..., return_stats=True)")
        _build.require(stats, "stats", torch.float32, 4, q.device)
        if stats.shape != (2, b, h, sq):
            raise ValueError(f"stats {tuple(stats.shape)} must be [2, {b}, {h}, {sq}]")
    elif stats is not None:
        raise ValueError("the f32 backward recomputes its row statistics: pass no stats")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    # f32: each row's m, l and D; bf16: each row's record {m, 1 / l, D, 0}
    scratch = torch.empty((4 if bf16 else 3) * b * h * sq, dtype=torch.float32,
                          device=q.device)
    fn = _build.function("flash_attention_bwd", "repro_flash_attention_bwd", _BWD_ARGS)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            stats.data_ptr() if bf16 else None, scratch.data_ptr(), DTYPES[q.dtype],
            b, sq, sk, h, hk, hd, attn_scale(hd), int(causal), int(window), q.device.index,
            _build.stream_of(q))
    _build.check(rc, "flash_attention_bwd", "flash_attention backward kernel")
    _build.count_launch(globals(), "backward_launches")
    if _build.cost_counter is not None:
        _build.cost_counter("flash_attention_bwd", lambda: backward_cost(
            b, sq, sk, h, hk, hd, causal=causal, window=window, itemsize=q.element_size(),
            stats=bf16))
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """:func:`flash_attention` with :func:`flash_attention_bwd` as its
    gradient; the forward keeps its row statistics for the backward (bf16).
    Under ``torch.utils.checkpoint`` (the models' remat) the forward runs
    again in the backward pass, so a rematerialized layer launches the
    forward twice and the backward once."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        # statistics only where a gradient will be asked for: inference
        # (inputs that need none) launches without the stats pointer
        if any(ctx.needs_input_grad[:3]):
            out, stats = flash_attention(q, k, v, causal=causal, window=window,
                                         return_stats=True)
        else:
            out, stats = flash_attention(q, k, v, causal=causal, window=window), None
        ctx.save_for_backward(q, k, v, out, stats)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, stats = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(), causal=ctx.causal,
                                         window=ctx.window, stats=stats)
        return dq, dk, dv, None, None
