"""Flash-decoding, one new token per sequence against its KV cache: the
hand-written CUDA kernel ``csrc/decode_attention.cu`` behind
``ops.decode_attention``, which the model's decode step reaches for
activations on the card.  The grid divides each row's cache into chunks of
keys (:func:`chunk_for`, from the shapes alone: the host never reads
``lens``); the last block of a row to finish merges its chunks, so a call
is one launch.

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
# every device function the kernel launches, by the prefix a profiler shows
KERNEL_PREFIX = "decode_attention_"
MAX_HEAD_DIM = 128
CHUNK_KEYS = 1024  # keys a block takes at most
MIN_CHUNK = 256    # keys a block takes at least (a multiple of csrc CHUNK_ALIGN)

_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] + [ctypes.c_longlong] * 5 + \
    [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p]
_SMS: dict[int, int] = {}                 # SMs of each device, read once
_TICKETS: dict[tuple[int, int], torch.Tensor] = {}   # zeroed tickets, per (device, stream)


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


def cost(b: int, s: int, h: int, hk: int, hd: int, lens, *, window: int = 0,
         itemsize: int = 2) -> tuple[int, int]:
    """(FLOPs, bytes) of one launch, as its bound counts them, for this
    call's ``lens`` (a [B] tensor or sequence): the cache rows a row attends
    (positions p <= lens, p < S, and lens - p < window under a window), each
    read once as K and V; 4 H hd FLOPs a row; q read and the
    output written once, and lens read."""
    lens = lens.tolist() if isinstance(lens, torch.Tensor) else list(lens)
    rows = 0
    for n in map(int, lens):
        lo = max(n - window + 1, 0) if window else 0
        rows += max(min(n, s - 1) - lo + 1, 0)
    flops = 4 * rows * h * hd
    nbytes = rows * hk * hd * 2 * itemsize + 2 * b * h * hd * itemsize + 4 * len(lens)
    return flops, nbytes


def chunk_for(b: int, hk: int, h: int, s: int, sms: int) -> int:
    """Keys per block: CHUNK_KEYS, halved (down to MIN_CHUNK) while the
    ceil(s / chunk) chunks of each (batch row, kv-head, group of up to 8
    q-heads) would leave some of the card's ``sms`` SMs without a block.
    Long chunks pay a block's start, drain and merge fewer times.  On the
    H100 (bf16, hd 128, 8 kv-heads): at 32 x 1024 one chunk a row read
    0.0337 ms and 256-key chunks 0.0367 ms; at 8 x 1024 the split read
    0.0147 ms against one chunk's 0.0219, at 2 x 4096 0.0192 against
    0.0739; at 8 x 128 two 64-key chunks read 0.0090 ms against one chunk's
    0.0059, so no chunk is shorter than MIN_CHUNK.  The host never reads
    lens, so the rule sees shapes alone; on the card a block whose chunk
    holds no visited key returns at once."""
    groups = b * hk * -(-(h // hk) // 8)
    chunk = CHUNK_KEYS
    while chunk > MIN_CHUNK and -(-s // chunk) * groups < sms:
        chunk //= 2
    return chunk


def _sms(device: torch.device) -> int:
    n = _SMS.get(device.index)
    if n is None:
        n = _SMS[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return n


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` int32 tickets for launches on ``stream`` of ``device``,
    zeros between launches: the last block of a row resets its ticket.
    Launches on one stream follow each other, so they can share them;
    launches on two streams may overlap, so each stream has its own."""
    t = _TICKETS.get((device.index, stream))
    if t is None or t.numel() < n:
        t = _TICKETS[(device.index, stream)] = torch.zeros(max(n, 4096), dtype=torch.int32,
                                                           device=device)
    return t


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lens: torch.Tensor, *, window: int = 0) -> torch.Tensor:
    """q [B,1,H,hd], k/v [B,S,Hk,hd] (f32 or bf16, one type), lens [B]
    int32 -> [B,1,H,hd] in that type."""
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
    chunk = chunk_for(b, hk, h, s, _sms(q.device))
    nchunks = -(-s // chunk)
    stream = _build.stream_of(q)
    part = tickets = None   # the chunks' (m, l, acc) and the merge's tickets,
    if nchunks > 1:         # held until the launch is queued
        part = torch.empty(b * h * nchunks * (hd + 2), dtype=torch.float32,
                           device=q.device)
        tickets = _tickets(q.device, stream, b * hk * -(-(h // hk) // 8))
    vec = (hd * q.element_size()) % 16 == 0 and k.data_ptr() % 16 == 0 \
        and v.data_ptr() % 16 == 0
    fn = _build.function("decode_attention", "repro_decode_attention", _ARGS)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(),
            None if tickets is None else tickets.data_ptr(), DTYPES[q.dtype], b, s, h,
            hk, hd, attn_scale(hd), int(window), chunk, int(vec), q.device.index, stream)
    _build.check(rc, "decode_attention", "decode_attention kernel")
    _build.count_launch(globals())
    if _build.cost_counter is not None:
        _build.cost_counter("decode_attention", lambda: cost(
            b, s, h, hk, hd, lens, window=window, itemsize=q.element_size()))
    return out
