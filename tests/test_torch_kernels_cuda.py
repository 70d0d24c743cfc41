"""The hand-written CUDA kernels against their plain torch versions, on the
card.  Every test here needs a CUDA device and skips without one; the file
imports neither ``jax`` nor ``repro``, so it runs on a machine with the card
and the port alone:

    python -m pytest -q tests/test_torch_kernels_cuda.py

The plain versions are held against the JAX reference on the CPU by
``test_torch_kernels.py``.  Tolerances as there: retrieval scores are dot
products of unit vectors summed in another order (``rtol=atol=1e-5`` in
f32); ``MASKED_SCORE`` lanes, probe blocks and ids must be exactly equal.
Attention (and decode attention) sums in another order and rounds its
probabilities to the input type at another point (before or after the
division by the row sum): ``1e-5`` in f32, ``2e-2`` in bf16.  RMSNorm agrees to ``1e-5`` in f32 and
to one bf16 unit in the last place in bf16."""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.common import init_params
from repro_torch.configs import get_smoke
from repro_torch.data.tokenizer import TOKENIZER
from repro_torch.engine.engine import InferenceEngine
from repro_torch.index.backend import MASKED_SCORE
from repro_torch.index.quant import quantize_tiles
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ivf_scan as tivf
from repro_torch.kernels import ivf_scan_q as tivfq
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rmsnorm as trn
from repro_torch.kernels import similarity as tsim
from repro_torch.models import attention as tattn

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    yield torch.device("cuda")
    repro_torch.set_device(None)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))   # a writable copy


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _assert_plane(got, want):
    """Masked lanes exactly equal, scored lanes allclose."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    masked = want <= MASKED_SCORE / 2
    np.testing.assert_array_equal(got[masked], want[masked])
    assert (got[~masked] > MASKED_SCORE / 2).all()
    np.testing.assert_allclose(got[~masked], want[~masked], **TOL)


def _ivf_world(kc, L, d, nq, seed):
    rng = np.random.default_rng(seed)
    store = rng.normal(size=(kc, L, d)).astype(np.float32)
    store /= np.linalg.norm(store, axis=-1, keepdims=True)
    mask = (rng.random((kc, L)) > 0.3).astype(np.float32)
    store[mask == 0] = 0.0
    cents = rng.normal(size=(kc, d)).astype(np.float32)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    sq, sc = quantize_tiles(store)
    return q, cents, store, mask, sq, sc


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nc,d", [(5, 7, 17), (64, 64, 64), (100, 300, 384),
                                     (1, 129, 3),
                                     # whole 128 x 128 tiles, d whole 32-float chunks
                                     (128, 128, 32), (256, 384, 384),
                                     # ragged in nq, nc and d; d % 4 != 0 (4-byte copies)
                                     (129, 257, 33), (130, 1001, 383),
                                     # 2 x 397 tiles: each persistent CTA walks several
                                     (200, 50693, 64),
                                     # nq <= 64 takes 64-row tiles; many of them
                                     (33, 20000, 384), (64, 1000, 99)])
@pytest.mark.parametrize("normalize", [True, False])
def test_similarity_kernel_matches_plain(cuda, nq, nc, d, normalize):
    rng = np.random.default_rng(nq + nc + d)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    c = rng.normal(size=(nc, d)).astype(np.float32)
    if not normalize:
        q, c = _unit(q), _unit(c)
    q, c = _t(q).to(cuda), _t(c).to(cuda)
    n0 = tsim.launches
    got = tsim.similarity(q, c, normalize=normalize)
    torch.cuda.synchronize()
    assert tsim.launches == n0 + 1
    torch.testing.assert_close(got, tref.similarity_ref(q, c, normalize=normalize),
                               **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("kc,L,d,bq,nprobe", [(6, 128, 17, 8, 2), (10, 256, 384, 8, 3),
                                              (5, 128, 64, 4, 2), (7, 384, 384, 16, 2),
                                              (4, 128, 32, 1, 2), (6, 200, 40, 2, 3),
                                              # L no multiple of the 128-row chunk
                                              (5, 300, 384, 8, 3), (3, 77, 17, 4, 2),
                                              # d of many 32-float stages
                                              (4, 160, 1000, 8, 2)])
@pytest.mark.parametrize("normalize", [True, False])
def test_cluster_scan_kernels_match_plain(cuda, kc, L, d, bq, nprobe, normalize):
    q, _, store, mask, sq, sc = _ivf_world(kc, L, d, 3 * bq, seed=kc + d)
    pb = np.random.default_rng(L).integers(0, kc, size=(3, bq * nprobe))
    q = q if normalize else _unit(q)
    q, store, mask, sq, sc = (_t(a).to(cuda) for a in (q, store, mask, sq, sc))
    pb = _t(pb.astype(np.int32)).to(cuda)
    n0 = (tivf.launches, tivfq.launches)
    got = tivf.cluster_scan(q, store, mask, pb, block_q=bq, normalize=normalize)
    _assert_plane(got, tref.ivf_scan_ref(q, store, mask, pb, block_q=bq,
                                         normalize=normalize))
    got = tivfq.cluster_scan_q(q, sq, sc, mask, pb, block_q=bq, normalize=normalize)
    _assert_plane(got, tref.ivf_scan_q_ref(q, sq, sc, mask, pb, block_q=bq,
                                           normalize=normalize))
    assert (tivf.launches, tivfq.launches) == (n0[0] + 1, n0[1] + 1)


def _similarity_case(case, normalize, rng):
    q = rng.normal(size=(70, 384)).astype(np.float32)
    c = rng.normal(size=(300, 384)).astype(np.float32)
    if not normalize:
        q, c = _unit(q), _unit(c)
    if case == "zero rows":          # the 1e-18 clamp: a zero row scores 0
        q[[0, 5, 69]] = 0.0
        c[[0, 127, 128, 299]] = 0.0
    qt, ct = _t(q).cuda(), _t(c).cuda()
    if case in ("unaligned q", "unaligned both"):   # 4 bytes past a 16-byte boundary
        qt = torch.cat([qt.new_zeros(1), qt.reshape(-1)])[1:].view(70, 384)
    if case in ("unaligned c", "unaligned both"):
        ct = torch.cat([ct.new_zeros(1), ct.reshape(-1)])[1:].view(300, 384)
    return qt, ct


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["zero rows", "unaligned q", "unaligned c", "unaligned both"])
@pytest.mark.parametrize("normalize", [True, False])
def test_similarity_kernel_edges_match_plain(cuda, case, normalize):
    q, c = _similarity_case(case, normalize, np.random.default_rng(5))
    if case.startswith("unaligned"):
        assert (q.data_ptr() % 16 != 0) or (c.data_ptr() % 16 != 0)
    torch.testing.assert_close(tsim.similarity(q, c, normalize=normalize),
                               tref.similarity_ref(q, c, normalize=normalize), **TOL)


@pytest.mark.cuda
def test_similarity_kernel_is_deterministic(cuda):
    rng = np.random.default_rng(6)
    q = _t(rng.normal(size=(256, 384)).astype(np.float32)).cuda()
    c = _t(rng.normal(size=(20000, 384)).astype(np.float32)).cuda()
    assert torch.equal(tsim.similarity(q, c), tsim.similarity(q, c))


def _scan_case(pattern, rng):
    """(queries, store, mask, probe_blocks, block_q) for a probe pattern the
    cluster-major scan could get wrong."""
    kc, L, d, bq, nb, slots = 6, 300, 64, 8, 5, 6
    if pattern == "every block probes one cluster, many groups":
        nb, slots = 40, 16             # 40 distinct blocks, 640 probers of cluster 2
    q, _, store, mask, _, _ = _ivf_world(kc, L, d, nb * bq, seed=11)
    pb = rng.integers(0, kc, size=(nb, slots))
    if pattern == "empty chunk":       # rows 128..255 of cluster 1 all masked
        mask[1, 128:256] = 0.0
        store[1, 128:256] = 0.0
        pb[:, 0] = 1
    elif pattern == "duplicates in a block":
        pb[0, :] = 3
        pb[2, 1::2] = 4
    elif pattern == "one cluster probed by every block":
        pb[:, 0] = 2
    elif pattern == "every block probes one cluster, many groups":
        pb[:, :] = 2
    elif pattern == "a cluster nobody probes":
        pb = rng.integers(0, 3, size=(nb, slots))   # clusters 3..5 unprobed
    elif pattern == "ids -1 and kc":
        pb[0, 0], pb[1, 2], pb[4, 5] = -1, kc, kc + 7
    return q, store, mask, pb.astype(np.int32), bq


SCAN_PATTERNS = ["empty chunk", "duplicates in a block", "one cluster probed by every block",
                 "every block probes one cluster, many groups", "a cluster nobody probes",
                 "ids -1 and kc"]


def _scan_planes(scan, q, store, mask, pb, bq, normalize):
    """(kernel plane, plain plane) of the fp32 scan over ``store`` or of the
    int8 scan over ``quantize_tiles(store)``, from numpy inputs.  The plain
    versions take ids in [0, kc) only: an id outside scores MASKED_SCORE
    over its whole strip, so those strips are masked in the plain plane."""
    kc, L, _ = store.shape
    bad = (pb < 0) | (pb >= kc)
    good = np.where(bad, 0, pb)
    q, mask, pb, good = (_t(a).cuda() for a in (q, mask, pb, good))
    if scan == "fp32":
        store = _t(store).cuda()
        got = tivf.cluster_scan(q, store, mask, pb, block_q=bq, normalize=normalize)
        want = tref.ivf_scan_ref(q, store, mask, good, block_q=bq, normalize=normalize)
        again = tivf.cluster_scan(q, store, mask, pb, block_q=bq, normalize=normalize)
    else:
        sq, sc = (_t(a).cuda() for a in quantize_tiles(store))
        got = tivfq.cluster_scan_q(q, sq, sc, mask, pb, block_q=bq, normalize=normalize)
        want = tref.ivf_scan_q_ref(q, sq, sc, mask, good, block_q=bq, normalize=normalize)
        again = tivfq.cluster_scan_q(q, sq, sc, mask, pb, block_q=bq, normalize=normalize)
    strip = _t(bad).cuda().repeat_interleave(L, dim=1).repeat_interleave(bq, dim=0)
    # two calls give the same bits
    assert torch.equal(got, again)
    return got, torch.where(strip, MASKED_SCORE, want)


@pytest.mark.cuda
@pytest.mark.parametrize("scan", ["fp32", "int8"])
@pytest.mark.parametrize("pattern", SCAN_PATTERNS)
@pytest.mark.parametrize("normalize", [True, False])
def test_cluster_scan_probe_patterns_match_plain(cuda, scan, pattern, normalize):
    q, store, mask, pb, bq = _scan_case(pattern, np.random.default_rng(7))
    q = q if normalize else _unit(q)
    _assert_plane(*_scan_planes(scan, q, store, mask, pb, bq, normalize))


@pytest.mark.cuda
@pytest.mark.parametrize("scan", ["fp32", "int8"])
@pytest.mark.parametrize("n_shards", [1, 3, 4])
def test_sharded_cluster_scan_matches_plain(cuda, scan, n_shards):
    """store[lo:hi] views through the sharded entry, L no multiple of 128."""
    q, cents, store, mask, sq, sc = _ivf_world(7, 300, 48, 21, seed=12)
    q, cents, store, mask, sq, sc = (_t(a).to(cuda) for a in (q, cents, store, mask, sq, sc))
    if scan == "fp32":
        got = tivf.sharded_ivf_search(q, cents, store, mask, nprobe=3, n_shards=n_shards)
        want = tref.sharded_ivf_search_ref(q, cents, store, mask, nprobe=3, n_shards=n_shards)
    else:
        got = tivfq.sharded_ivf_search_q(q, cents, sq, sc, mask, nprobe=3, n_shards=n_shards)
        want = tref.sharded_ivf_search_q_ref(q, cents, sq, sc, mask, nprobe=3,
                                             n_shards=n_shards)
    _assert_plane(got[0], want[0])
    assert torch.equal(got[1], want[1])


def _int8_edge_case(d, offset, rng):
    """An int8 store that holds -128 and 127, a valid row whose scale is 0
    and masked rows of non-zero bytes, as a view ``offset`` bytes past a
    16-byte boundary: (store_q view, scales, mask, probe_blocks)."""
    kc, L, nb, bq = 5, 300, 4, 8
    sq = rng.integers(-128, 128, size=(kc, L, d), dtype=np.int8)
    sq[0, :130] = -128                    # a whole chunk and more at each extreme
    sq[0, 130:260] = 127
    sq[1, 3, ::2], sq[1, 3, 1::2] = -128, 127
    sc = (rng.random((kc, L)) / (127 * np.sqrt(d))).astype(np.float32)
    mask = (rng.random((kc, L)) > 0.3).astype(np.float32)   # masked rows keep their bytes
    mask[0, :260] = 1.0
    mask[1, 3] = mask[2, 5] = 1.0
    sc[2, 5] = 0.0
    pb = rng.integers(0, kc, size=(nb, 2 * bq)).astype(np.int32)
    pb[:, 0] = np.arange(nb) % 3
    buf = torch.zeros(sq.size + 32, dtype=torch.int8, device="cuda")
    at = (-buf.data_ptr()) % 16 + offset
    view = buf[at:at + sq.size].view(sq.shape)
    view.copy_(_t(sq).cuda())
    assert view.data_ptr() % 16 == offset
    return view, _t(sc).cuda(), _t(mask).cuda(), _t(pb).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [17, 33, 384, 1000])
@pytest.mark.parametrize("offset", [0, 1, 4])
@pytest.mark.parametrize("normalize", [True, False])
def test_cluster_scan_q_int8_edges_match_plain(cuda, d, offset, normalize):
    """Every way the int8 rows reach shared memory: 16-byte copies (d % 16
    == 0, aligned), 4-byte copies (d % 4 == 0, 4-byte aligned) and bytes;
    query rows padded by the wrapper (d % 4 != 0) or, at offset 4, 4 bytes
    past a 16-byte boundary."""
    rng = np.random.default_rng(d + offset)
    sq, sc, mask, pb = _int8_edge_case(d, offset, rng)
    q = rng.normal(size=(pb.shape[0] * 8, d)).astype(np.float32)
    q = _t(q if normalize else _unit(q)).cuda()
    if offset == 4:
        q = torch.cat([q.new_zeros(1), q.reshape(-1)])[1:].view(q.shape)
        assert q.data_ptr() % 16 == 4
    got = tivfq.cluster_scan_q(q, sq, sc, mask, pb, normalize=normalize)
    want = tref.ivf_scan_q_ref(q, sq, sc, mask, pb, normalize=normalize)
    _assert_plane(got, want)
    assert bool((got[want == 0] == 0).all())   # the zero-scale row scores 0


def _ops_run(device):
    """Every slice-1 ops entry on ``device``, from the same numpy inputs."""
    repro_torch.set_device(device)
    q, cents, store, mask, sq, sc = _ivf_world(6, 128, 64, 13, seed=77)
    rng = np.random.default_rng(78)
    delta = _unit(rng.normal(size=(9, 64)))
    dq, dsc = quantize_tiles(delta[None])
    return [
        tops.similarity(q, store[0]),
        *tops.ivf_search(q, cents, store, mask, nprobe=3),
        *tops.ivf_search_q(q, cents, sq, sc, mask, nprobe=3),
        *tops.ivf_delta_search(q, cents, store, mask, delta, nprobe=2),
        *tops.ivf_delta_search_q(q, cents, sq, sc, mask, dq[0], dsc[0], nprobe=2),
        *tops.sharded_search(q, store[0], 5, shards=3),
        *tops.sharded_ivf_search(q, cents, store, mask, nprobe=3, shards=4),
        *tops.sharded_ivf_search_q(q, cents, sq, sc, mask, nprobe=3, shards=4),
    ]


@pytest.mark.cuda
def test_ops_auto_launches_kernels_on_cuda_and_matches_cpu(cuda):
    n0 = (tsim.launches, tivf.launches, tivfq.launches)
    got = _ops_run(cuda)
    n1 = (tsim.launches, tivf.launches, tivfq.launches)
    want = _ops_run("cpu")
    assert (tsim.launches, tivf.launches, tivfq.launches) == n1   # CPU: no launch
    # similarity: direct, the fp32 delta scan, 3 shards (the int8 delta scan
    # is numpy on the host, as in the reference); each scan: direct, under
    # its delta search, 3 shards (the 4th of 4 shards of 2 clusters owns none)
    assert (n1[0] - n0[0], n1[1] - n0[1], n1[2] - n0[2]) == (5, 5, 5)
    for g, w in zip(got, want):
        if g.dtype == np.float32:
            _assert_plane(g, w)
        else:
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# flash_attention and rmsnorm
# ---------------------------------------------------------------------------

ATTN_SHAPES = [  # b, sq, sk, h, hk, hd
    (1, 64, 64, 4, 4, 64), (2, 100, 100, 8, 2, 64), (2, 48, 48, 8, 2, 128),
    (1, 33, 33, 2, 1, 128), (2, 77, 77, 4, 2, 16), (2, 37, 53, 4, 2, 32),
    (1, 70, 20, 4, 2, 16),        # Sq > Sk + window: rows no key may see
    (1, 130, 130, 24, 8, 128),    # the llama3.2-3b head layout
    # edges of the bf16 tensor-core kernel (64-row tiles, hd padded to 64/128)
    (2, 100, 100, 4, 2, 20),      # hd 20: rows not 16-byte aligned, scalar loads
    (1, 100, 256, 24, 8, 128),    # prefill-like: one sequence, Sq < Sk
    (4, 512, 512, 24, 8, 128),    # 768 tiles: each persistent block walks several
    (1, 130, 130, 8, 1, 100),     # H/Hk 8; hd 100 padded to 128, scalar loads
    (2, 100, 100, 8, 2, 96),      # hd 96: the second 64-column TMA panel is cut at hd
]
MASKS = [(True, 0), (True, 16), (False, 0), (False, 8)]


def _attn_inputs(b, sq, sk, h, hk, hd, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, sq, h, hd, generator=g)
    k = torch.randn(b, sk, hk, hd, generator=g)
    v = torch.randn(b, sk, hk, hd, generator=g)
    return (t.to("cuda", dtype) for t in (q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ATTN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_attention_kernel_matches_plain(cuda, shape, dtype, causal, window):
    q, k, v = _attn_inputs(*shape, dtype, seed=sum(shape) + window)
    _assert_flash_matches_plain(q, k, v, causal, window)


def _assert_flash_matches_plain(q, k, v, causal, window):
    n0 = tfa.launches
    got = tfa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tfa.launches == n0 + 1 and got.dtype == q.dtype
    want = tref.flash_attention_ref(q, k, v, causal=causal, window=window)
    tol = 1e-5 if q.dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# The backward kernel against the plain version (autograd through the
# contract): f32 within 1e-4 (five products summed in another order, scores
# recomputed); bf16 within BWD_BF16_TOL, the limit chip_smoke.py's phase 19
# sets between the kernel and two gross faults.  In bf16 the plain version
# runs on f32 copies of the same inputs and its gradients are rounded once,
# as the contract rounds each output: autograd through the contract in bf16
# rounds dP and each q-head's dK/dV before the group sum, which at Sk = 1
# (every P 1, so dV sums Sq x H/Hk rows of dO) lies beyond the limit from
# the once-rounded gradient, where the kernel keeps f32 and rounds once.  The kernel rounds P (the contract) and dS (its operand) to
# bf16; the f32 plain version rounds neither.
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
# edges of the bf16 tensor-core backward's tiling (64-row q tiles, 64-key
# tiles, hd padded to 64/128), besides ATTN_SHAPES; under MASKS' windows
# (16, 8: shorter than a tile)
BWD_SHAPES = [  # b, sq, sk, h, hk, hd
    (2, 1, 1, 4, 2, 128),         # Sq = Sk = 1
    (1, 1, 100, 8, 2, 64),        # one q row against two key tiles
    (1, 100, 1, 8, 2, 64),        # one key: under a window most rows see none
    (2, 65, 127, 4, 2, 128),      # Sq != Sk, each one past a tile edge
    (2, 127, 65, 4, 2, 128),
    (1, 100, 100, 4, 4, 100),     # hd 100 with H/Hk 1 (8 is in ATTN_SHAPES)
    (1, 100, 40, 4, 2, 64),       # windowed: q tile 0 holds rows that see keys and rows
                                  # that see none (from Sk + window - 1 on)
    (1, 100, 100, 16, 1, 64),     # H/Hk 16: clusters of 8 blocks, two q-heads a block
]


def _assert_flash_bwd_matches_plain(q, k, v, causal, window, seed=0):
    out, stats = tfa.flash_attention(q, k, v, causal=causal, window=window,
                                     return_stats=True)
    g = torch.Generator().manual_seed(seed)
    dout = torch.randn(q.shape, generator=g).to("cuda", q.dtype)
    n0 = tfa.backward_launches
    got = tfa.flash_attention_bwd(q, k, v, out, dout, causal=causal, window=window,
                                  stats=stats)
    torch.cuda.synchronize()
    assert tfa.backward_launches == n0 + 1
    if q.dtype == torch.bfloat16:
        want = tuple(t.to(q.dtype) for t in tref.flash_attention_bwd_ref(
            q.float(), k.float(), v.float(), out.float(), dout.float(), causal=causal,
            window=window))
    else:
        want = tref.flash_attention_bwd_ref(q, k, v, out, dout, causal=causal, window=window)
    tol = BWD_TOL[q.dtype]
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == b.dtype == q.dtype and a.shape == b.shape, name
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol, msg=name)
    again = tfa.flash_attention_bwd(q, k, v, out, dout, causal=causal, window=window,
                                    stats=stats)
    for a, b in zip(got, again):
        assert torch.equal(a, b)          # no atomics: the same bits


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ATTN_SHAPES + BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_attention_backward_kernel_matches_plain(cuda, shape, dtype, causal, window):
    q, k, v = _attn_inputs(*shape, dtype, seed=sum(shape) + window + 1)
    _assert_flash_bwd_matches_plain(q, k, v, causal, window, seed=sum(shape))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_misaligned_and_through_ops(cuda, dtype):
    b, s, h, hk, hd = 2, 96, 4, 2, 64
    q = _misaligned((b, s, h, hd), dtype, seed=4)
    k = _misaligned((b, s, hk, hd), dtype, seed=5)
    v = _misaligned((b, s, hk, hd), dtype, seed=6)
    _assert_flash_bwd_matches_plain(q, k, v, True, 8)
    # the ops entry differentiates through the kernel pair
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = tops.flash_attention(*leaves, causal=True, window=8)
    dout = torch.randn_like(out)
    n0 = tfa.backward_launches
    got = torch.autograd.grad(out, leaves, dout)
    assert tfa.backward_launches == n0 + 1
    _, stats = tfa.flash_attention(*(t.detach() for t in leaves), causal=True, window=8,
                                   return_stats=True)
    want = tfa.flash_attention_bwd(*(t.detach() for t in leaves), out.detach(), dout,
                                   causal=True, window=8, stats=stats)
    for a, b_ in zip(got, want):
        assert torch.equal(a, b_)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ATTN_SHAPES + BWD_SHAPES)
@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_attention_forward_stats_match_plain(cuda, shape, causal, window):
    """The bf16 forward's saved m and l against ``flash_attention_stats_ref``
    (m within 1e-5 of 1 + |m|: scores summed in another order; l within
    1e-4 relative: 2^x on the special-function unit), the output's bits
    unchanged by saving them, and rows no key may see exactly (NEG_INF, Sk);
    f32 keeps none."""
    q, k, v = _attn_inputs(*shape, torch.bfloat16, seed=sum(shape) + window + 2)
    out, stats = tfa.flash_attention(q, k, v, causal=causal, window=window,
                                     return_stats=True)
    assert torch.equal(out, tfa.flash_attention(q, k, v, causal=causal, window=window))
    m, l = tref.flash_attention_stats_ref(q, k, v, causal=causal, window=window)
    assert stats.shape == (2, *m.shape) and stats.dtype == torch.float32
    assert float(((stats[0] - m).abs() / (1 + m.abs())).max()) <= 1e-5
    torch.testing.assert_close(stats[1], l, rtol=1e-4, atol=0)
    dead = m == tref.NEG_INF
    assert torch.equal(stats[0][dead], m[dead]) and torch.equal(stats[1][dead], l[dead])
    _, none = tfa.flash_attention(q.float(), k.float(), v.float(), causal=causal,
                                  window=window, return_stats=True)
    assert none is None


def _misaligned(shape, dtype, seed):
    """A contiguous CUDA tensor whose data starts one element past an
    allocation: in bf16 its rows are not 16-byte aligned."""
    g = torch.Generator().manual_seed(seed)
    buf = torch.randn(int(np.prod(shape)) + 1, generator=g).to("cuda", dtype)
    return buf[1:].view(shape)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [128, 64])
@pytest.mark.parametrize("offset", ["q", "v", "qkv"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 8)])
def test_flash_attention_misaligned_pointers_match_plain(cuda, hd, offset, dtype,
                                                         causal, window):
    # hd a multiple of 8 would take the 16-byte copies; a pointer that starts
    # mid-allocation must send the bf16 kernel to its scalar loads instead
    b, s, h, hk = 2, 96, 4, 2
    q, k, v = _attn_inputs(b, s, s, h, hk, hd, dtype, seed=hd + window)
    if "q" in offset:
        q = _misaligned(q.shape, dtype, seed=1)
    if "k" in offset:
        k = _misaligned(k.shape, dtype, seed=2)
    if "v" in offset:
        v = _misaligned(v.shape, dtype, seed=3)
    assert any(t.data_ptr() % 16 for t in (q, k, v))
    _assert_flash_matches_plain(q, k, v, causal, window)


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> int:
    """The largest distance, in bf16 units in the last place, between two
    bf16 tensors (bit patterns mapped to a monotonic integer scale)."""
    def key(t):
        bits = t.view(torch.int16).long()
        return torch.where(bits >= 0, bits, -(bits & 0x7FFF))
    return int((key(got) - key(want)).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 64), (3, 5, 128), (130, 256), (7, 3072),
                                   (5, 17), (4, 3, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain(cuda, shape, dtype):
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(shape, generator=g).to("cuda", dtype)
    scale = torch.randn(shape[-1], generator=g).to("cuda")
    n0 = trn.launches
    got = trn.rmsnorm(x, scale, eps=1e-5)
    torch.cuda.synchronize()
    assert trn.launches == n0 + 1 and got.dtype == dtype and got.shape == x.shape
    want = tref.rmsnorm_ref(x, scale, eps=1e-5)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert bf16_ulps(got, want) <= 1


def _assert_rmsnorm_matches_plain(x, scale):
    n0 = trn.launches
    got = trn.rmsnorm(x, scale, eps=1e-5)
    torch.cuda.synchronize()
    assert trn.launches == n0 + 1 and got.dtype == x.dtype and got.shape == x.shape
    want = tref.rmsnorm_ref(x, scale, eps=1e-5)
    if x.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert bf16_ulps(got, want) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (1, 3072),        # one row
    (3001, 3072),     # the oracle's width; rows no multiple of the blocks' share
    (2500, 8192),     # the widest row the registers hold in bf16 (4096 in f32)
    (300, 4096),
    (300, 16384),     # wider: the two-pass fallback
    (50, 17),         # no 16-byte chunks: the scalar fallback
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_paths_match_plain(cuda, shape, dtype):
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(shape, generator=g).to("cuda", dtype)
    scale = torch.randn(shape[-1], generator=g).to("cuda")
    _assert_rmsnorm_matches_plain(x, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_misaligned_rows_match_plain(cuda, dtype):
    x = _misaligned((40, 3072), dtype, seed=4)
    assert x.data_ptr() % 16
    scale = torch.randn(3072, generator=torch.Generator().manual_seed(5)).to("cuda")
    _assert_rmsnorm_matches_plain(x, scale)
    x = torch.randn(40, 3072, generator=torch.Generator().manual_seed(6)).to("cuda", dtype)
    sc = _misaligned((3072,), torch.float32, seed=7)   # scale not 16-byte aligned
    assert x.data_ptr() % 16 == 0 and sc.data_ptr() % 16
    _assert_rmsnorm_matches_plain(x, sc)


@pytest.mark.cuda
def test_model_ops_launch_kernels_on_cuda_and_match_cpu(cuda):
    """``ops.flash_attention`` / ``ops.rmsnorm`` return tensors on the
    inputs' device and launch the kernel there; on the CPU the plain
    version runs and nothing launches."""
    q, k, v = _attn_inputs(2, 40, 40, 4, 2, 16, torch.float32, seed=5)
    x, scale = q.reshape(-1, 16), torch.ones(16, device="cuda", dtype=torch.bfloat16)
    n0 = (tfa.launches, trn.launches)
    a = tops.flash_attention(q, k, v, causal=True, window=8)
    r = tops.rmsnorm(x, scale, eps=1e-6)
    assert a.is_cuda and r.is_cuda and (tfa.launches, trn.launches) == (n0[0] + 1, n0[1] + 1)
    a_cpu = tops.flash_attention(q.cpu(), k.cpu(), v.cpu(), causal=True, window=8)
    r_cpu = tops.rmsnorm(x.cpu(), scale.cpu(), eps=1e-6)
    assert (tfa.launches, trn.launches) == (n0[0] + 1, n0[1] + 1)
    torch.testing.assert_close(a.cpu(), a_cpu, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(r.cpu(), r_cpu, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_self_attention_auto_launches_kernel_on_cuda(cuda):
    """Under the configs' default ``attn_impl="auto"`` the model's
    self-attention launches the kernel for activations on the card; for
    activations on the CPU it keeps the reference's plain rule and launches
    nothing.  Both agree to the f32 attention tolerance."""
    cfg = get_smoke("llama3.2-3b")
    assert cfg.attn_impl == "auto" and cfg.dtype == "float32"
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(tattn.attention_spec(cfg), gen)
    x = torch.randn(2, 40, cfg.d_model, generator=gen, device="cuda")
    n0 = tfa.launches
    out, _ = tattn.self_attention(params, x, cfg=cfg)
    assert out.is_cuda and tfa.launches == n0 + 1
    want, _ = tattn.self_attention({k: t.cpu() for k, t in params.items()}, x.cpu(),
                                   cfg=cfg)
    assert tfa.launches == n0 + 1
    torch.testing.assert_close(out.cpu(), want, rtol=1e-5, atol=1e-5)


DECODE_CASES = [  # b, s, h, hk, hd, window
    (32, 1024, 24, 8, 128, 0),    # the full-width llama3.2-3b decode shape
    (4, 1024, 24, 8, 128, 256),   # sliding window
    (3, 300, 8, 8, 64, 0),        # Hk = H: no GQA
    (3, 77, 8, 2, 64, 0),         # S no multiple of a tile
    (2, 129, 4, 2, 16, 0),
    (3, 300, 4, 1, 16, 40),
    (2, 64, 16, 1, 32, 0),        # 16 q-heads per kv-head: two blocks read it
    (2, 500, 12, 4, 48, 0),       # hd 48: padded to 64 in shared memory
    (2, 50, 4, 2, 17, 7),         # hd 17: no 16-byte loads
]


def _decode_inputs(b, s, h, hk, hd, window, dtype, seed):
    """q, k, v on the card and lens holding 0, S - 1, a value past S and,
    with a window, a row whose window lies past the cache."""
    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(0, s, (b,), generator=g, dtype=torch.int32)
    lens[:3] = torch.tensor([0, s - 1, s + 5], dtype=torch.int32)[:b]
    if window and b > 2:
        lens[2] = s + window + 1
    q = torch.randn(b, 1, h, hd, generator=g)
    k = torch.randn(b, s, hk, hd, generator=g)
    v = torch.randn(b, s, hk, hd, generator=g)
    return (*(t.to("cuda", dtype) for t in (q, k, v)), lens.cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_matches_plain(cuda, case, dtype):
    *shape, window = case
    q, k, v, lens = _decode_inputs(*case, dtype, seed=sum(case))
    n0 = tda.launches
    got = tda.decode_attention(q, k, v, lens, window=window)
    torch.cuda.synchronize()
    assert tda.launches == n0 + 1 and got.dtype == dtype and got.shape == q.shape
    want = tref.decode_attention_ref(q, k, v, lens, window=window)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_decode_attention_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, lens = _decode_inputs(2, 40, 4, 2, 16, 0, torch.float32, seed=1)
    n0 = tda.launches
    with pytest.raises(ValueError, match="lens"):
        tda.decode_attention(q, k, v, lens.long())
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros(2, 40, 2, 256, device="cuda")
        tda.decode_attention(torch.zeros(2, 1, 4, 256, device="cuda"), big, big, lens)
    with pytest.raises(ValueError, match="contiguous"):
        tda.decode_attention(q, k.transpose(1, 2), v.transpose(1, 2), lens)
    with pytest.raises(ValueError, match="bfloat16"):
        tda.decode_attention(q, k.bfloat16(), v, lens)
    assert tda.launches == n0


def _decode_qkv(b, s, h, hk, hd, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(*shape, generator=g).to("cuda", dtype)
            for shape in ((b, 1, h, hd), (b, s, hk, hd), (b, s, hk, hd)))


def _assert_decode_matches_plain(q, k, v, lens, window=0):
    n0 = tda.launches
    got = tda.decode_attention(q, k, v, lens, window=window)
    torch.cuda.synchronize()
    assert tda.launches == n0 + 1 and got.dtype == q.dtype and got.shape == q.shape
    want = tref.decode_attention_ref(q, k, v, lens, window=window)
    tol = 1e-5 if q.dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    return got


def _lens(*values):
    return torch.tensor(values, dtype=torch.int32, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["all 0", "all S - 1", "one long row", "many chunks",
                                     "window at chunk edges"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_work_division_matches_plain(cuda, pattern, dtype):
    """The grid divides each row's keys into chunks; these lens put the
    visited rows [lo, hi] on the division's edges."""
    b, s, h, hk, hd, window = 6, 1024, 24, 8, 128, 0
    if pattern == "many chunks":
        b, s, h, hk = 2, 4096, 8, 2
    q, k, v = _decode_qkv(b, s, h, hk, hd, dtype, seed=len(pattern))
    chunk = tda.chunk_for(b, hk, h, s, tda._sms(q.device))
    if pattern == "all 0":
        lens = _lens(*[0] * b)
    elif pattern == "all S - 1":
        lens = _lens(*[s - 1] * b)
    elif pattern == "one long row":
        lens = _lens(s - 1, 3, 17, 64, 0, chunk)
    elif pattern == "many chunks":
        assert -(-s // chunk) >= 16
        lens = _lens(s - 1, 2500)
    else:
        # lo and hi on either side of a chunk boundary: one chunk exactly,
        # one key past it, the first chunk, one key alone, a chunk and a key
        window = chunk
        lens = _lens(2 * chunk - 1, 2 * chunk, chunk - 1, chunk, 3 * chunk, s + 2)
        _assert_decode_matches_plain(q, k, v, lens, window=1)
    _assert_decode_matches_plain(q, k, v, lens, window=window)


@pytest.mark.cuda
@pytest.mark.parametrize("h,hk", [(4, 4), (24, 8), (8, 1), (16, 1)])   # G 1, 3, 8, 16
@pytest.mark.parametrize("hd", [16, 17, 48, 100, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_heads_and_widths_match_plain(cuda, h, hk, hd, dtype):
    b, s = 3, 700
    q, k, v = _decode_qkv(b, s, h, hk, hd, dtype, seed=h + hd)
    _assert_decode_matches_plain(q, k, v, _lens(699, 255, 401))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", ["k", "v", "kv"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_misaligned_cache_matches_plain(cuda, offset, dtype):
    # hd 128 would take the 16-byte copies; a cache that starts mid-allocation
    # must send the kernel to its scalar loads instead
    b, s, h, hk, hd = 3, 600, 24, 8, 128
    q, k, v = _decode_qkv(b, s, h, hk, hd, dtype, seed=11)
    if "k" in offset:
        k = _misaligned(k.shape, dtype, seed=12)
    if "v" in offset:
        v = _misaligned(v.shape, dtype, seed=13)
    assert any(t.data_ptr() % 16 for t in (k, v))
    _assert_decode_matches_plain(q, k, v, _lens(599, 0, 300), window=0)
    _assert_decode_matches_plain(q, k, v, _lens(599, 0, 300), window=100)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_is_deterministic_and_resets_its_tickets(cuda, dtype):
    """Chunks merge in chunk order, whichever block finishes last, so two
    calls give identical bits; the last block resets its row's ticket, so a
    call after one with other lens is right and the tickets end at 0."""
    b, s, h, hk, hd = 4, 1024, 24, 8, 128
    q, k, v = _decode_qkv(b, s, h, hk, hd, dtype, seed=21)
    assert tda.chunk_for(b, hk, h, s, tda._sms(q.device)) < s   # several chunks a row
    lens = torch.randint(0, s, (b,), generator=torch.Generator().manual_seed(22),
                         dtype=torch.int32).cuda()
    first = _assert_decode_matches_plain(q, k, v, lens)
    again = _assert_decode_matches_plain(q, k, v, lens)
    assert torch.equal(first.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       again.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
    _assert_decode_matches_plain(q, k, v, torch.flip(lens, (0,)))
    _assert_decode_matches_plain(q, k, v, _lens(*[s - 1] * b), window=300)
    _assert_decode_matches_plain(q, k, v, lens)
    assert all(int(t.abs().sum()) == 0 for t in tda._TICKETS.values())


@pytest.mark.cuda
def test_decode_attention_on_two_streams_matches_plain(cuda):
    """Launches on two streams may overlap on the card; each stream merges
    its chunks with tickets of its own."""
    b, s, h, hk, hd = 4, 1024, 24, 8, 128
    q, k, v = _decode_qkv(b, s, h, hk, hd, torch.bfloat16, seed=31)
    assert tda.chunk_for(b, hk, h, s, tda._sms(q.device)) < s   # several chunks a row
    lens = [_lens(1023, 5, 600, 300), _lens(100, 1023, 0, 900)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(8):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(tda.decode_attention(q, k, v, lens[i]))
    torch.cuda.synchronize()
    for ls, got in zip(lens, outs):
        want = tref.decode_attention_ref(q, k, v, ls).float()
        for o in got:
            torch.testing.assert_close(o.float(), want, rtol=2e-2, atol=2e-2)
    assert all(int(t.abs().sum()) == 0 for t in tda._TICKETS.values())


@pytest.mark.cuda
def test_generate_on_cuda_launches_decode_kernel_and_matches_cpu(cuda):
    """The smoke engine (3 layers, f32) under ``attn_impl="auto"``: on the
    card every decode step of every layer launches the kernel, and the
    generations equal the CPU's (the plain path the tests hold against
    JAX)."""
    cfg = get_smoke("llama3.2-3b").with_(vocab_size=TOKENIZER.vocab_size)
    prompts = [f"request {i}: " + "abc " * (3 * i) for i in range(5)]
    gpu = InferenceEngine(cfg, seed=0, max_slots=3, max_seq=128)
    n0 = tda.launches
    got = gpu.generate(prompts, max_new_tokens=8)
    assert tda.launches - n0 >= cfg.num_layers * 7
    assert (tda.launches - n0) % cfg.num_layers == 0
    repro_torch.set_device("cpu")
    cpu = InferenceEngine(cfg, gpu.runner.params, max_slots=3, max_seq=128)
    assert cpu.generate(prompts, max_new_tokens=8) == got
    assert gpu.stats == cpu.stats
