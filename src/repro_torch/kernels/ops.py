"""Public entry points of the hand-written kernels with implementation
dispatch.

    impl="auto"   the CUDA kernel for CUDA tensors; the plain torch version
                  only for tensors the caller placed on the CPU
    impl="cuda"   the CUDA kernel; raises for CPU tensors
    impl="ref"    the plain torch contract (``kernels/ref.py``) on the
                  tensors' own device

Two boundaries, as in the reference:

* the retrieval entries take numpy arrays or tensors; numpy inputs are
  placed on ``repro_torch.current_device()`` (CUDA unless the caller chose
  the CPU), tensors stay where they are, so an index that keeps its store
  on the card passes it without a copy; results come back as numpy arrays;
* the model-facing entries (:func:`flash_attention`, :func:`rmsnorm`,
  :func:`decode_attention`) take and return tensors on their device, open no span and do not synchronize,
  so a layer's activations never leave the card.

Nothing here falls back: a kernel that fails to build or launch raises.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.device import current_device
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ivf_scan as _ivf
from repro_torch.kernels import ivf_scan_q as _ivfq
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import similarity as _sim
from repro_torch.obs import trace as _trace

DEFAULT_IMPL = "auto"
IMPLS = ("auto", "cuda", "ref")


@contextlib.contextmanager
def _kernel_span(name: str, mode: str, **attrs):
    """Kernel-dispatch observability, active only under a tracer: an NVTX
    range so the dispatch is labeled in device profiles, plus a
    ``kind="kernel"`` trace span so host-side kernel time is attributed to
    the owning operator span.  Yields the span (None when tracing is off —
    the zero-overhead default path)."""
    if _trace.current_tracer() is None:
        yield None
        return
    nvtx = torch.cuda.nvtx.range(f"repro.{name}") if mode == "cuda" \
        else contextlib.nullcontext()
    with nvtx:
        with _trace.span(f"kernel/{name}", kind="kernel",
                         impl=mode, **attrs) as sp:
            yield sp


def _ready(out: torch.Tensor, sp) -> torch.Tensor:
    """Under a tracer, wait for the device so the enclosing kernel span
    measures compute, not the launch; untraced calls stay asynchronous (the
    numpy conversion waits anyway)."""
    if sp is not None and out.is_cuda:
        torch.cuda.synchronize(out.device)
    return out


def _device(*xs) -> torch.device:
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return current_device()


def _tensor(x, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(x))
    return t.to(device=device, dtype=dtype).contiguous()


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _host(x) -> np.ndarray:
    return _numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _resolve(impl: str | None, t: torch.Tensor) -> str:
    impl = impl or DEFAULT_IMPL
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r} (expected one of {IMPLS})")
    if impl == "auto":
        return "cuda" if t.is_cuda else "ref"
    if impl == "cuda" and not t.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors; these are on "
                         f"{t.device}")
    return impl


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    impl: str | None = None) -> torch.Tensor:
    """GQA attention, q [B,Sq,H,hd], k/v [B,Sk,Hk,hd] -> [B,Sq,H,hd] on the
    tensors' device; torch contract ``ref.flash_attention_ref``.  Both paths
    are differentiable: the kernel's gradient is its backward kernel
    (``_fa.FlashAttention``), the contract's torch autograd."""
    if _resolve(impl, q) == "ref":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return _fa.FlashAttention.apply(q, k, v, causal, window)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lens: torch.Tensor, *, window: int = 0,
                     impl: str | None = None) -> torch.Tensor:
    """One new token per sequence against its cache: q [B,1,H,hd], k/v
    [B,S,Hk,hd], lens [B] -> [B,1,H,hd] on the tensors' device; torch
    contract ``ref.decode_attention_ref``."""
    if _resolve(impl, q) == "ref":
        return ref.decode_attention_ref(q, k, v, lens, window=window)
    return _da.decode_attention(q, k, v, lens, window=window)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5,
            impl: str | None = None) -> torch.Tensor:
    """x [..., d], scale [d] -> like ``x`` on its device; torch contract
    ``ref.rmsnorm_ref``."""
    if _resolve(impl, x) == "ref":
        return ref.rmsnorm_ref(x, scale, eps=eps)
    return _rn.rmsnorm(x, scale.float(), eps=eps)


def similarity(queries, corpus, *, normalize: bool = True,
               impl: str | None = None) -> np.ndarray:
    dev = _device(corpus, queries)
    q, c = _tensor(queries, dev), _tensor(corpus, dev)
    mode = _resolve(impl, c)
    with _kernel_span("similarity", mode, nq=len(q), nc=len(c)) as sp:
        if mode == "ref":
            out = ref.similarity_ref(q, c, normalize=normalize)
        else:
            out = _sim.similarity(q, c, normalize=normalize)
        return _numpy(_ready(out, sp))


def _ivf_inputs(queries, centroids, store, mask, *rest, store_dtype=torch.float32):
    dev = _device(store, centroids, mask, queries)
    q = _tensor(queries, dev)
    cents = _tensor(centroids, dev)
    st = _tensor(store, dev, store_dtype)
    mk = _tensor(mask, dev)
    return (q, cents, st, mk, *[_tensor(r, dev) for r in rest])


def ivf_search(queries, centroids, store, mask, *, nprobe: int,
               block_q: int = 8, impl: str | None = None
               ) -> tuple[np.ndarray, np.ndarray]:
    """Fused IVF retrieval: centroid scoring + per-query top-``nprobe``
    probe selection + masked cluster scan over the padded inverted file.

    -> (scores [nq, block_q*nprobe*L] f32, probe_blocks [nb, block_q*nprobe]);
    masked/padded candidates score ``ref.MASKED_SCORE``."""
    q, cents, st, mk = _ivf_inputs(queries, centroids, store, mask)
    mode = _resolve(impl, st)
    with _kernel_span("ivf_search", mode, nq=len(q), nprobe=nprobe) as sp:
        fn = ref.ivf_search_ref if mode == "ref" else _ivf.ivf_search
        s, p = fn(q, cents, st, mk, nprobe=nprobe, block_q=block_q)
        s = _ready(s, sp)
        return _numpy(s), _numpy(p)


def ivf_delta_search(queries, centroids, store, mask, delta_vectors, *,
                     nprobe: int, block_q: int = 8, impl: str | None = None
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Delta-aware IVF retrieval: the probed-cluster scan (:func:`ivf_search`)
    plus an exact scan of the streaming delta side buffer, concatenated
    along the candidate axis.  The buffer is small by construction (the
    drift detector retrains past the spill threshold), so its exact scan
    rides the similarity kernel.

    -> (scores [nq, block_q*nprobe*L + nd] f32, probe_blocks); torch
    contract: ``ref.ivf_delta_search_ref``."""
    q, cents, st, mk, dv = _ivf_inputs(queries, centroids, store, mask,
                                       delta_vectors)
    mode = _resolve(impl, st)
    if mode == "ref":
        s, p = ref.ivf_delta_search_ref(q, cents, st, mk, dv, nprobe=nprobe,
                                        block_q=block_q)
        return _numpy(s), _numpy(p)
    s, p = ivf_search(q, cents, st, mk, nprobe=nprobe, block_q=block_q,
                      impl=impl)
    ds = similarity(q, dv, normalize=True, impl=impl)
    return np.concatenate([s, np.asarray(ds, np.float32)], axis=1), p


def ivf_search_q(queries, centroids, store_q, scales, mask, *, nprobe: int,
                 block_q: int = 8, impl: str | None = None
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Fused *quantized* IVF retrieval: the :func:`ivf_search` pipeline over
    symmetric per-vector int8 tiles (``store_q`` int8 + ``scales`` f32;
    ``repro_torch.index.quant``), dequantization fused into the cluster scan
    as one multiply per score — ``d + 4`` bytes per scanned vector instead
    of ``4 * d``.

    -> (scores [nq, block_q*nprobe*L] f32, probe_blocks); torch contract:
    ``ref.ivf_search_q_ref``."""
    q, cents, st, mk, sc = _ivf_inputs(queries, centroids, store_q, mask,
                                       scales, store_dtype=torch.int8)
    mode = _resolve(impl, st)
    with _kernel_span("ivf_search_q", mode, nq=len(q), nprobe=nprobe) as sp:
        fn = ref.ivf_search_q_ref if mode == "ref" else _ivfq.ivf_search_q
        s, p = fn(q, cents, st, sc, mk, nprobe=nprobe, block_q=block_q)
        s = _ready(s, sp)
        return _numpy(s), _numpy(p)


def ivf_delta_search_q(queries, centroids, store_q, scales, mask, delta_q,
                       delta_scales, *, nprobe: int, block_q: int = 8,
                       impl: str | None = None
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Quantized delta-aware IVF retrieval: the fused quantized probed-
    cluster scan plus a dequantize-fused exact scan of the int8 streaming
    delta side buffer (numpy on the host, as in the reference),
    concatenated along the candidate axis.

    -> (scores [nq, block_q*nprobe*L + nd] f32, probe_blocks); torch
    contract: ``ref.ivf_delta_search_q_ref``."""
    q, cents, st, mk, sc = _ivf_inputs(queries, centroids, store_q, mask,
                                       scales, store_dtype=torch.int8)
    mode = _resolve(impl, st)
    if mode == "ref":
        s, p = ref.ivf_delta_search_q_ref(
            q, cents, st, sc, mk, _tensor(delta_q, q.device, torch.int8),
            _tensor(delta_scales, q.device), nprobe=nprobe, block_q=block_q)
        return _numpy(s), _numpy(p)
    s, p = ivf_search_q(q, cents, st, sc, mk, nprobe=nprobe, block_q=block_q,
                        impl=impl)
    from repro_torch.index.quant import quantized_scores
    qn = np.asarray(_host(queries), np.float32)
    qn = qn / np.maximum(np.linalg.norm(qn, axis=-1, keepdims=True), 1e-9)
    ds = quantized_scores(qn, _host(delta_q), _host(delta_scales))
    return np.concatenate([s, np.asarray(ds, np.float32)], axis=1), p


def _n_devices() -> int:
    """CUDA devices visible to the port (1 when it runs on the CPU)."""
    return torch.cuda.device_count() if current_device().type == "cuda" else 1


def effective_shards(shards: int) -> int:
    """The shard count the sharded entries will actually run.  Every mode
    runs the single-device simulation of the shard partitioning (what the
    reference runs on one device), the kernels scoring each shard for CUDA
    tensors; splitting the shards over several cards is still to be
    ported, so the requested count is kept.  Index layers use this so
    per-shard accounting (``scored_vectors_per_shard``) describes the real
    work split."""
    return max(int(shards), 1)


def sharded_search(queries, corpus, k: int, *, shards: int,
                   normalize: bool = True, impl: str | None = None
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Sharded exact top-k: corpus rows split into ``shards`` tiles
    (per-shard similarity kernel + local top-k), per-shard candidates merged
    on host.  Lossless — the merged top-k is identical to a full exact scan
    (``ref.sharded_search_ref`` is the torch contract).
    -> (scores [nq, k], global idx [nq, k])."""
    dev = _device(corpus, queries)
    q, c = _tensor(queries, dev), _tensor(corpus, dev)
    mode, shards = _resolve(impl, c), effective_shards(shards)
    with _kernel_span("sharded_search", mode, nq=len(q), nc=len(c),
                      shards=shards):
        if mode == "ref":
            s, i = ref.sharded_search_ref(q, c, k, shards, normalize=normalize)
        else:
            s, i = _sim.sharded_similarity_topk(q, c, k, n_shards=shards,
                                                normalize=normalize)
        return s, np.asarray(i, np.int64)


def sharded_ivf_search(queries, centroids, store, mask, *, nprobe: int,
                       shards: int, block_q: int = 8, impl: str | None = None
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Sharded IVF retrieval: cluster tiles partitioned into ``shards``,
    global probe selection, per-shard masked scan of the locally-owned
    probed clusters combined by elementwise max.  The score plane is
    identical to :func:`ivf_search`.  Torch contract:
    ``ref.sharded_ivf_search_ref``."""
    q, cents, st, mk = _ivf_inputs(queries, centroids, store, mask)
    mode, shards = _resolve(impl, st), effective_shards(shards)
    with _kernel_span("sharded_ivf_search", mode, nq=len(q), nprobe=nprobe,
                      shards=shards) as sp:
        fn = ref.sharded_ivf_search_ref if mode == "ref" \
            else _ivf.sharded_ivf_search
        s, p = fn(q, cents, st, mk, nprobe=nprobe, n_shards=shards,
                  block_q=block_q)
        s = _ready(s, sp)
        return _numpy(s), _numpy(p)


def sharded_ivf_search_q(queries, centroids, store_q, scales, mask, *,
                         nprobe: int, shards: int, block_q: int = 8,
                         impl: str | None = None
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Sharded quantized IVF retrieval: int8 cluster tiles + their scale
    rows partitioned into ``shards``, global probe selection, per-shard
    fused dequantize+scan combined by elementwise max.  Score plane
    identical to :func:`ivf_search_q`.  Torch contract:
    ``ref.sharded_ivf_search_q_ref``."""
    q, cents, st, mk, sc = _ivf_inputs(queries, centroids, store_q, mask,
                                       scales, store_dtype=torch.int8)
    mode, shards = _resolve(impl, st), effective_shards(shards)
    with _kernel_span("sharded_ivf_search_q", mode, nq=len(q), nprobe=nprobe,
                      shards=shards) as sp:
        fn = ref.sharded_ivf_search_q_ref if mode == "ref" \
            else _ivfq.sharded_ivf_search_q
        s, p = fn(q, cents, st, sc, mk, nprobe=nprobe, n_shards=shards,
                  block_q=block_q)
        s = _ready(s, sp)
        return _numpy(s), _numpy(p)
