"""Int8 gradient compression with error feedback (1-bit-Adam-family trick).

The torch form of ``repro.train.grad_compress``: each gradient leaf is
quantized to int8 with a per-tensor scale before it would cross a slow
link, and the quantization residual is kept in an error-feedback buffer
that is added back into the next step's gradient, so the residuals
telescope.  On one card the quantize/dequantize pair runs just before the
optimizer; the same payloads and scales as the reference's (division and
round-half-to-even are IEEE in both).
"""
from __future__ import annotations

import torch

from repro_torch.train.optimizer import _map


def init_error_buffer(grads):
    return _map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)


def _quantize(x: torch.Tensor):
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_leaf(g: torch.Tensor, err: torch.Tensor):
    """Returns (int8 payload, scale, new_error_buffer, dequantized grad)."""
    x = g.to(torch.float32) + err
    q, scale = _quantize(x)
    deq = _dequantize(q, scale)
    return q, scale, x - deq, deq


def compress_tree(grads, err_buf):
    """Error-feedback int8 round-trip on every leaf -> (dequantized grads,
    new error buffers)."""
    outs = _map(compress_leaf, grads, err_buf)
    return _map(lambda o: o[3], outs), _map(lambda o: o[2], outs)
