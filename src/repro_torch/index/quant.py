"""Symmetric per-vector int8 scalar quantization for IVF tile stores.

The compression behind ``IVFIndex(quantize="int8")``: every corpus vector
``v`` is stored as ``q = round(v / s)`` with its own scale ``s = absmax(v) /
127`` (one f32 per vector, kept in a side array shaped like the tile's lane
axis), so a scanned vector costs ``d + 4`` bytes instead of ``4 * d`` —
~3.9x fewer bytes at d=64 streamed through the cluster-scan hot loop.
Scores dequantize *inside* the scan as one multiply per score after the
dot product (``(q_f32 @ qv^T) * s``; `repro_torch.kernels.ivf_scan_q`), and the exact
fp32 rerank on top (`IVFIndex._exact_rerank`) restores the measured
recall@k contract.

Everything here is pure numpy — this module is the *reference* the CUDA
kernel and torch contract (`repro_torch.kernels.ref.ivf_search_q_ref`) must match:

  * per-element round-trip error is bounded by ``s / 2 = absmax / 254``
    (tests/test_quant.py asserts it);
  * an all-zero vector has no meaningful scale — its scale pins to 1.0 so
    quantize/dequantize never divides by zero and the row round-trips to
    exact zeros (padding lanes in the tile store are all-zero by
    construction, so this guard runs on every tile).
"""
from __future__ import annotations

import numpy as np

INT8_MAX = 127          # symmetric range [-127, 127]; -128 stays unused
SCALE_BYTES = 4         # one f32 scale per stored vector


def bytes_per_vector(dim: int, quantize: str = "none") -> float:
    """HBM bytes one scanned corpus vector streams: ``4*d`` at fp32,
    ``d + 4`` (int8 payload + its f32 scale) when quantized."""
    if quantize == "none":
        return 4.0 * dim
    if quantize == "int8":
        return 1.0 * dim + SCALE_BYTES
    raise ValueError(f"quantize={quantize!r} (expected 'none'|'int8')")


def quantize_rows(vectors: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """[n, d] f32 -> (q int8 [n, d], scales f32 [n]).

    Symmetric per-vector: ``scale = absmax / 127``; a zero-norm row (absmax
    == 0, e.g. tile padding) pins its scale to 1.0 — no divide-by-zero, and
    the row dequantizes to exact zeros."""
    v = np.atleast_2d(np.asarray(vectors, np.float32))
    absmax = np.max(np.abs(v), axis=-1) if v.size else np.zeros(len(v))
    scales = np.where(absmax > 0, absmax / INT8_MAX, 1.0).astype(np.float32)
    q = np.clip(np.rint(v / scales[:, None]), -INT8_MAX, INT8_MAX)
    return q.astype(np.int8), scales


def quantize_tiles(store: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Padded IVF tile store [kc, L, d] f32 -> (q int8 [kc, L, d],
    scales f32 [kc, L]).  Padding rows are all-zero, so the zero-norm guard
    gives them scale 1.0 / payload 0 (they are masked out of scores anyway)."""
    kc, L, d = store.shape
    q, scales = quantize_rows(store.reshape(kc * L, d))
    return q.reshape(kc, L, d), scales.reshape(kc, L)


def dequantize_rows(q: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """Inverse of :func:`quantize_rows`: [..., d] int8 * [...] -> f32."""
    return q.astype(np.float32) * np.asarray(scales, np.float32)[..., None]


def quantized_scores(queries: np.ndarray, q: np.ndarray,
                     scales: np.ndarray) -> np.ndarray:
    """Fused dequantize+score, the numerics the kernel implements:
    queries [nq, d] f32 x (q [n, d] int8, scales [n]) -> [nq, n] f32.
    The per-vector scale factors out of the dot product, so dequantization
    is one multiply on the score plane, not ``n * d`` multiplies on the
    payload."""
    qf = np.asarray(queries, np.float32)
    return (qf @ q.astype(np.float32).T) * np.asarray(scales, np.float32)[None, :]
