"""The port's kernels on the CPU: every contract in
``repro_torch.kernels.ref`` against its jnp original in ``repro.kernels.ref``,
the port's ``ops`` against the reference's (Pallas bodies in interpret
mode) and the dispatch rules.  The hand-written kernels against their plain
versions, which need a card, are in ``test_torch_kernels_cuda.py``.

Tolerances: retrieval scores are dot products of unit vectors summed in
another order, so they agree to ``rtol=atol=1e-5`` in f32; ``MASKED_SCORE``
lanes, probe blocks and top-k ids must be exactly equal (inputs are
continuous random draws, so there are no ties except the deliberate masked
ones).  Attention: 1e-5 in f32 and 2e-2 in bf16, where the Pallas kernel
rounds its unnormalised probabilities to bf16 and the contract its
normalised ones.  RMSNorm: 1e-6 in f32 and one bf16 unit in the last place
in bf16."""
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.index.backend import MASKED_SCORE
from repro_torch.index.quant import quantize_tiles
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ivf_scan as tivf
from repro_torch.kernels import ivf_scan_q as tivfq
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rmsnorm as trn
from repro_torch.kernels import similarity as tsim

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu():
    repro_torch.set_device("cpu")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))   # a writable copy


def _unit(x):
    """Rows scaled to unit norm: what the kernels' callers pass with
    ``normalize=False``, and what the 1e-5 tolerance is stated for."""
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _assert_plane(got, want):
    """Masked lanes exactly equal, scored lanes allclose."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    masked = want <= MASKED_SCORE / 2
    np.testing.assert_array_equal(got[masked], want[masked])
    assert (got[~masked] > MASKED_SCORE / 2).all()
    np.testing.assert_allclose(got[~masked], want[~masked], **TOL)


def _ivf_world(kc, L, d, nq, seed, *, quantized=False):
    rng = np.random.default_rng(seed)
    store = rng.normal(size=(kc, L, d)).astype(np.float32)
    store /= np.linalg.norm(store, axis=-1, keepdims=True)
    mask = (rng.random((kc, L)) > 0.3).astype(np.float32)
    store[mask == 0] = 0.0
    cents = rng.normal(size=(kc, d)).astype(np.float32)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    if quantized:
        sq, sc = quantize_tiles(store)
        return q, cents, store, mask, sq, sc
    return q, cents, store, mask


# ---------------------------------------------------------------------------
# contracts: torch ref vs jnp ref
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [17, 64, 384])
@pytest.mark.parametrize("nq,nc", [(5, 37), (33, 7), (1, 300)])
@pytest.mark.parametrize("normalize", [True, False])
def test_similarity_ref_matches_jnp(d, nq, nc, normalize):
    rng = np.random.default_rng(d * 1000 + nq)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    c = rng.normal(size=(nc, d)).astype(np.float32)
    if not normalize:
        q, c = _unit(q), _unit(c)
    got = tref.similarity_ref(_t(q), _t(c), normalize=normalize)
    want = jref.similarity_ref(q, c, normalize=normalize)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_unitize_and_pad_queries_match_jnp():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(13, 17)).astype(np.float32)
    q[4] = 0.0                                     # the 1e-18 floor
    np.testing.assert_allclose(_np(tref._unitize(_t(q))),
                               _np(jref._unitize(q)), **TOL)
    for nq, bq in [(1, 8), (8, 8), (13, 8), (13, 4)]:
        tp, tnb = tref.pad_queries(_t(q[:nq]), bq)
        jp, jnb = jref.pad_queries(q[:nq], bq)
        assert tnb == jnb
        np.testing.assert_array_equal(_np(tp), _np(jp))


@pytest.mark.parametrize("d", [17, 64, 384])
def test_ivf_probes_match_jnp_exactly(d):
    q, cents, *_ = _ivf_world(12, 128, d, 16, seed=d)
    qu = jref._unitize(q)
    got = tref.ivf_probes(_t(_np(qu)), _t(cents), 5, 8)
    want = jref.ivf_probes(qu, cents, 5, 8)
    assert got.dtype == torch.int32 and got.shape == (2, 40)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_ivf_probes_break_ties_to_lowest_index():
    q = np.ones((8, 4), np.float32)
    cents = np.ones((6, 4), np.float32)            # every centroid ties
    got = tref.ivf_probes(_t(q), _t(cents), 3, 8)
    np.testing.assert_array_equal(_np(got), _np(jref.ivf_probes(q, cents, 3, 8)))
    np.testing.assert_array_equal(_np(got)[0, :3], [0, 1, 2])


@pytest.mark.parametrize("kc,nb,slots,lo,hi", [
    (6, 3, 16, 0, 6),        # every id in range
    (6, 4, 8, -2, 9),        # ids below 0 and at or past kc: the last list
    (5, 7, 24, 0, 2),        # skew: clusters 2..4 probed by nobody
    (1, 1, 1, 0, 1),
])
def test_probe_lists_invert_probe_blocks(kc, nb, slots, lo, hi):
    """The scan's probe lists against a loop over the (block, slot) pairs:
    each cluster's probers in pair order, ids outside [0, kc) in list kc."""
    pb = np.random.default_rng(kc + nb).integers(lo, hi, size=(nb, slots)).astype(np.int32)
    order, starts = tivf.probe_lists(_t(pb), kc)
    assert order.dtype == torch.int32 and starts.dtype == torch.int32
    assert starts.shape == (kc + 2,) and order.shape == (nb * slots,)
    lists = [[] for _ in range(kc + 1)]
    for pair, p in enumerate(pb.reshape(-1).tolist()):
        lists[p if 0 <= p < kc else kc].append(pair)
    order, starts = _np(order), _np(starts)
    assert starts[0] == 0 and starts[-1] == nb * slots
    for p in range(kc + 1):
        assert order[starts[p]:starts[p + 1]].tolist() == lists[p]


@pytest.mark.parametrize("d", [17, 64, 384])
@pytest.mark.parametrize("normalize", [True, False])
def test_ivf_scan_ref_matches_jnp(d, normalize):
    q, cents, store, mask = _ivf_world(6, 128, d, 16, seed=d + 7)
    pb = np.random.default_rng(d).integers(0, 6, size=(2, 24)).astype(np.int32)
    q = q if normalize else _unit(q)
    got = tref.ivf_scan_ref(_t(q), _t(store), _t(mask), _t(pb),
                            normalize=normalize)
    want = jref.ivf_scan_ref(q, store, mask, pb, normalize=normalize)
    _assert_plane(got, want)


@pytest.mark.parametrize("d", [17, 64, 384])
@pytest.mark.parametrize("nq", [1, 8, 11])
def test_ivf_search_ref_matches_jnp(d, nq):
    q, cents, store, mask = _ivf_world(7, 128, d, nq, seed=nq * d)
    ts, tp = tref.ivf_search_ref(_t(q), _t(cents), _t(store), _t(mask), nprobe=3)
    js, jp = jref.ivf_search_ref(q, cents, store, mask, nprobe=3)
    np.testing.assert_array_equal(_np(tp), _np(jp))
    _assert_plane(ts, js)


def test_ivf_delta_search_ref_matches_jnp():
    q, cents, store, mask = _ivf_world(5, 128, 64, 9, seed=3)
    delta = np.random.default_rng(4).normal(size=(6, 64)).astype(np.float32)
    delta /= np.linalg.norm(delta, axis=1, keepdims=True)
    ts, tp = tref.ivf_delta_search_ref(_t(q), _t(cents), _t(store), _t(mask),
                                       _t(delta), nprobe=2)
    js, jp = jref.ivf_delta_search_ref(q, cents, store, mask, delta, nprobe=2)
    np.testing.assert_array_equal(_np(tp), _np(jp))
    _assert_plane(ts, js)


@pytest.mark.parametrize("d", [17, 64, 384])
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("values", ["quantized", "extremes"])
def test_ivf_scan_q_ref_matches_jnp(d, normalize, values):
    q, cents, store, mask, sq, sc = _ivf_world(6, 128, d, 16, seed=d + 11,
                                               quantized=True)
    pb = np.random.default_rng(d + 1).integers(0, 6, size=(2, 16)).astype(np.int32)
    if values == "extremes":
        # -128 and 127, a valid row of scale 0, masked rows of non-zero bytes
        rng = np.random.default_rng(d + 2)
        sq = rng.integers(-128, 128, size=sq.shape, dtype=np.int8)
        sq[0, :40], sq[0, 40:80] = -128, 127
        sq[1, 3, ::2], sq[1, 3, 1::2] = -128, 127
        mask[0, :80] = mask[1, 3] = mask[2, 5] = 1.0
        sc = (rng.random(sc.shape) / (127 * np.sqrt(d))).astype(np.float32)
        sc[2, 5] = 0.0
        pb[:, 0] = [0, 2]
        pb[:, 1] = 1
    q = q if normalize else _unit(q)
    got = tref.ivf_scan_q_ref(_t(q), _t(sq), _t(sc), _t(mask), _t(pb),
                              normalize=normalize)
    want = jref.ivf_scan_q_ref(q, sq, sc, mask, pb, normalize=normalize)
    _assert_plane(got, want)


@pytest.mark.parametrize("nq", [3, 16])
def test_ivf_search_q_and_delta_ref_match_jnp(nq):
    q, cents, store, mask, sq, sc = _ivf_world(8, 128, 32, nq, seed=nq,
                                               quantized=True)
    ts, tp = tref.ivf_search_q_ref(_t(q), _t(cents), _t(sq), _t(sc), _t(mask),
                                   nprobe=3)
    js, jp = jref.ivf_search_q_ref(q, cents, sq, sc, mask, nprobe=3)
    np.testing.assert_array_equal(_np(tp), _np(jp))
    _assert_plane(ts, js)
    dq, dsc = quantize_tiles(np.random.default_rng(9).normal(
        size=(1, 5, 32)).astype(np.float32))
    dq, dsc = dq[0], dsc[0]
    ts, tp = tref.ivf_delta_search_q_ref(_t(q), _t(cents), _t(sq), _t(sc),
                                         _t(mask), _t(dq), _t(dsc), nprobe=3)
    js, jp = jref.ivf_delta_search_q_ref(q, cents, sq, sc, mask, dq, dsc,
                                         nprobe=3)
    np.testing.assert_array_equal(_np(tp), _np(jp))
    _assert_plane(ts, js)


def test_pad_corpus_shards_and_topk_merge_match_jnp():
    rng = np.random.default_rng(5)
    c = rng.normal(size=(10, 17)).astype(np.float32)
    for n in (1, 3, 4):
        tp, tv, tl = tref.pad_corpus_shards(_t(c), n)
        jp, jv, jl = jref.pad_corpus_shards(c, n)
        assert tl == jl
        np.testing.assert_array_equal(_np(tp), _np(jp))
        np.testing.assert_array_equal(_np(tv), _np(jv))
    # ties resolve to the lowest global index, whatever the arrival order
    s = np.array([[0.5, 0.9, 0.5, MASKED_SCORE, 0.9, MASKED_SCORE]], np.float32)
    i = np.array([[7, 3, 2, 9, 1, 8]])
    for k in (2, 4, 6, 9):
        ts, ti = tref.shard_topk_merge(_t(s), _t(i), k)
        js, ji = jref.shard_topk_merge(s, i, k)
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(ti, ji)


@pytest.mark.parametrize("nc,n_shards,k", [(40, 4, 5), (10, 4, 4), (5, 4, 7)])
@pytest.mark.parametrize("normalize", [True, False])
def test_sharded_search_ref_matches_jnp(nc, n_shards, k, normalize):
    """Includes shards with fewer than k real rows (masked padding ties)."""
    rng = np.random.default_rng(nc + k)
    q = rng.normal(size=(6, 24)).astype(np.float32)
    c = rng.normal(size=(nc, 24)).astype(np.float32)
    if not normalize:
        q, c = _unit(q), _unit(c)
    ts, ti = tref.sharded_search_ref(_t(q), _t(c), k, n_shards, normalize=normalize)
    js, ji = jref.sharded_search_ref(q, c, k, n_shards, normalize=normalize)
    np.testing.assert_array_equal(ti, ji)
    _assert_plane(ts, js)


@pytest.mark.parametrize("n_shards", [1, 3, 4])
def test_sharded_ivf_search_refs_match_jnp(n_shards):
    q, cents, store, mask, sq, sc = _ivf_world(10, 128, 32, 7, seed=n_shards,
                                               quantized=True)
    ts, tp = tref.sharded_ivf_search_ref(_t(q), _t(cents), _t(store), _t(mask),
                                         nprobe=4, n_shards=n_shards)
    js, jp = jref.sharded_ivf_search_ref(q, cents, store, mask, nprobe=4,
                                         n_shards=n_shards)
    np.testing.assert_array_equal(_np(tp), _np(jp))
    _assert_plane(ts, js)
    ts, tp = tref.sharded_ivf_search_q_ref(_t(q), _t(cents), _t(sq), _t(sc),
                                           _t(mask), nprobe=4, n_shards=n_shards)
    js, jp = jref.sharded_ivf_search_q_ref(q, cents, sq, sc, mask, nprobe=4,
                                           n_shards=n_shards)
    np.testing.assert_array_equal(_np(tp), _np(jp))
    _assert_plane(ts, js)


def test_sharded_ivf_search_with_an_empty_shard_equals_unsharded_jnp():
    """6 clusters over 4 shards of 2: the last shard owns none.  The jnp
    sharded contract raises on its empty gather there; the port skips the
    shard, and its plane equals the unsharded one, as the contract states."""
    q, cents, store, mask, sq, sc = _ivf_world(6, 128, 32, 7, seed=5,
                                               quantized=True)
    ts, tp = tref.sharded_ivf_search_ref(_t(q), _t(cents), _t(store), _t(mask),
                                         nprobe=3, n_shards=4)
    js, jp = jref.ivf_search_ref(q, cents, store, mask, nprobe=3)
    np.testing.assert_array_equal(_np(tp), _np(jp))
    _assert_plane(ts, js)
    ts, tp = tref.sharded_ivf_search_q_ref(_t(q), _t(cents), _t(sq), _t(sc),
                                           _t(mask), nprobe=3, n_shards=4)
    js, jp = jref.ivf_search_q_ref(q, cents, sq, sc, mask, nprobe=3)
    np.testing.assert_array_equal(_np(tp), _np(jp))
    _assert_plane(ts, js)


# ---------------------------------------------------------------------------
# ops: the port's entry points vs the reference's (Pallas bodies interpreted)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nq,nc,d", [(16, 16, 32), (37, 53, 17), (9, 70, 384)])
@pytest.mark.parametrize("normalize", [True, False])
def test_ops_similarity_matches_pallas_interpret(nq, nc, d, normalize):
    rng = np.random.default_rng(nq + nc)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    c = rng.normal(size=(nc, d)).astype(np.float32)
    if not normalize:
        q, c = _unit(q), _unit(c)
    got = tops.similarity(q, c, normalize=normalize)
    want = jops.similarity(q, c, normalize=normalize, impl="interpret",
                           block_q=16, block_c=16)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("d", [17, 64])
def test_ops_ivf_search_matches_pallas_interpret(d):
    q, cents, store, mask, sq, sc = _ivf_world(6, 128, d, 13, seed=d,
                                               quantized=True)
    ts, tp = tops.ivf_search(q, cents, store, mask, nprobe=3)
    js, jp = jops.ivf_search(q, cents, store, mask, nprobe=3, impl="interpret")
    np.testing.assert_array_equal(tp, jp)
    _assert_plane(ts, js)
    ts, tp = tops.ivf_search_q(q, cents, sq, sc, mask, nprobe=3)
    js, jp = jops.ivf_search_q(q, cents, sq, sc, mask, nprobe=3,
                               impl="interpret")
    np.testing.assert_array_equal(tp, jp)
    _assert_plane(ts, js)


@pytest.mark.parametrize("impl", ["auto", "ref"])
def test_ops_delta_searches_match_reference(impl):
    q, cents, store, mask, sq, sc = _ivf_world(6, 128, 32, 10, seed=21,
                                               quantized=True)
    rng = np.random.default_rng(22)
    delta = rng.normal(size=(4, 32)).astype(np.float32)
    delta /= np.linalg.norm(delta, axis=1, keepdims=True)
    dq, dsc = quantize_tiles(delta[None])
    ts, tp = tops.ivf_delta_search(q, cents, store, mask, delta, nprobe=2,
                                   impl=impl)
    js, jp = jops.ivf_delta_search(q, cents, store, mask, delta, nprobe=2,
                                   impl="interpret")
    np.testing.assert_array_equal(tp, jp)
    _assert_plane(ts, js)
    ts, tp = tops.ivf_delta_search_q(q, cents, sq, sc, mask, dq[0], dsc[0],
                                     nprobe=2, impl=impl)
    js, jp = jops.ivf_delta_search_q(q, cents, sq, sc, mask, dq[0], dsc[0],
                                     nprobe=2, impl="interpret")
    np.testing.assert_array_equal(tp, jp)
    _assert_plane(ts, js)


def test_ops_sharded_entries_match_reference_contracts():
    q, cents, store, mask, sq, sc = _ivf_world(10, 128, 32, 9, seed=31,
                                               quantized=True)
    corpus = store[mask > 0][:50]
    ts, ti = tops.sharded_search(q, corpus, 6, shards=4)
    js, ji = jref.sharded_search_ref(q, corpus, 6, 4)
    np.testing.assert_array_equal(ti, ji)
    _assert_plane(ts, js)
    ts, tp = tops.sharded_ivf_search(q, cents, store, mask, nprobe=3, shards=4)
    js, jp = jref.sharded_ivf_search_ref(q, cents, store, mask, nprobe=3,
                                         n_shards=4)
    np.testing.assert_array_equal(tp, _np(jp))
    _assert_plane(ts, js)
    ts, tp = tops.sharded_ivf_search_q(q, cents, sq, sc, mask, nprobe=3, shards=4)
    js, jp = jref.sharded_ivf_search_q_ref(q, cents, sq, sc, mask, nprobe=3,
                                           n_shards=4)
    np.testing.assert_array_equal(tp, _np(jp))
    _assert_plane(ts, js)
    assert tops.effective_shards(4) == 4 and tops._n_devices() == 1


# ---------------------------------------------------------------------------
# model-facing kernels: flash_attention and rmsnorm
# ---------------------------------------------------------------------------

# the sweep of tests/test_kernels.py, plus Sq != Sk
ATTN_SHAPES = [  # b, sq, sk, h, hk, hd
    (1, 64, 64, 4, 4, 64), (2, 128, 128, 4, 2, 64), (1, 100, 100, 8, 8, 32),
    (2, 48, 48, 8, 2, 128), (1, 33, 33, 2, 1, 128), (2, 37, 53, 4, 2, 32),
    (1, 52, 37, 4, 1, 16),       # Sq > Sk, every row sees a key at window 16
]
ATTN_DTYPES = [("float32", torch.float32, jnp.float32, 1e-5),
               ("bfloat16", torch.bfloat16, jnp.bfloat16, 2e-2)]


def _attn_inputs(b, sq, sk, h, hk, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, h, hd)).astype(np.float32),
            rng.normal(size=(b, sk, hk, hd)).astype(np.float32),
            rng.normal(size=(b, sk, hk, hd)).astype(np.float32))


@pytest.mark.parametrize("shape", ATTN_SHAPES)
@pytest.mark.parametrize("name,tdt,jdt,tol", ATTN_DTYPES)
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16), (False, 0)])
def test_flash_attention_plain_matches_jax_kernel_and_contract(shape, name, tdt, jdt,
                                                               tol, causal, window):
    """The port's plain version (what ``ops`` runs on the CPU) against the
    Pallas kernel in interpret mode and against the jnp contract, on the
    same inputs rounded the same way to the working type."""
    arrs = _attn_inputs(*shape, seed=sum(shape) + window)
    got = tops.flash_attention(*(_t(a).to(tdt) for a in arrs), causal=causal,
                               window=window)
    b, sq, _, h, _, hd = shape
    assert got.dtype == tdt and tuple(got.shape) == (b, sq, h, hd)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in arrs)
    want_ref = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    want_pal = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                    impl="interpret", block_q=32, block_k=32)
    for want in (want_ref, want_pal):
        np.testing.assert_allclose(_np(got.float()), np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


def test_flash_attention_rows_no_key_may_see_match_the_contract():
    """Sq >= Sk + window leaves rows with every score masked: the contract
    (and the port) give them the uniform softmax over the masked scores.
    The Pallas kernel's padded tail keys share in that average, so only the
    jnp contract is compared here."""
    q, k, v = _attn_inputs(1, 70, 20, 4, 2, 16, seed=9)
    for causal in (True, False):
        got = tops.flash_attention(_t(q), _t(k), _t(v), causal=causal, window=8)
        want = jref.flash_attention_ref(q, k, v, causal=causal, window=8)
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(got)[0, 69], np.repeat(v.mean(1), 2, axis=1)[0],
                               rtol=1e-5, atol=1e-5)


# decode: b, s, h, hk, hd; S 77, 129 and 300 are no multiple of any tile
DECODE_SHAPES = [(4, 64, 4, 2, 16), (3, 77, 8, 2, 64), (4, 129, 4, 4, 32),
                 (3, 300, 8, 2, 16), (3, 96, 24, 8, 128)]


def _decode_inputs(b, s, h, hk, hd, seed):
    """q, k, v and lens holding 0, S - 1 and a value past S (then random)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, s, b).astype(np.int32)
    lens[:3] = [0, s - 1, s + 5]
    return (rng.normal(size=(b, 1, h, hd)).astype(np.float32),
            rng.normal(size=(b, s, hk, hd)).astype(np.float32),
            rng.normal(size=(b, s, hk, hd)).astype(np.float32), lens)


@pytest.mark.parametrize("shape", DECODE_SHAPES)
@pytest.mark.parametrize("name,tdt,jdt,tol", ATTN_DTYPES)
def test_decode_attention_plain_matches_jax_contract_and_kernel(shape, name, tdt, jdt,
                                                                tol):
    """The port's plain version (what ``ops`` runs on the CPU) against the jnp
    contract on every row, and against the Pallas kernel in interpret mode
    (block_k 32) on the rows it computes to the contract: a row with
    lens >= S when S is no multiple of block_k counts the kernel's
    zero-padded keys (ROADMAP, queue 3), so it is held to the contract
    alone."""
    q, k, v, lens = _decode_inputs(*shape, seed=sum(shape))
    got = tops.decode_attention(*(_t(a).to(tdt) for a in (q, k, v)), _t(lens))
    b, s, h, _, hd = shape
    assert got.dtype == tdt and tuple(got.shape) == (b, 1, h, hd)
    got = _np(got.float())
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    want = np.asarray(jref.decode_attention_ref(jq, jk, jv, jnp.asarray(lens)), np.float32)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    pal = np.asarray(jops.decode_attention(jq, jk, jv, lens, impl="interpret",
                                           block_k=32), np.float32)
    rows = (lens < s) | (s % 32 == 0)
    assert rows.sum() >= 2 and rows.all() == (s % 32 == 0)
    np.testing.assert_allclose(got[rows], pal[rows], rtol=tol, atol=tol)


@pytest.mark.parametrize("window", [1, 8, 40])
@pytest.mark.parametrize("name,tdt,jdt,tol", ATTN_DTYPES)
def test_decode_attention_window_matches_the_models_mask(window, name, tdt, jdt, tol):
    """``window > 0`` is the mask of the reference's decode step
    (``models/attention.py``): positions ``lens - window < k_pos <= lens``.
    A row whose window lies past the cache sees no key and gets the
    uniform softmax, in both."""
    from repro.models import attention as jattn
    q, k, v, lens = _decode_inputs(4, 77, 8, 2, 16, seed=window)
    lens[3] = 77 + window + 2                     # no key in its window
    got = tops.decode_attention(*(_t(a).to(tdt) for a in (q, k, v)), _t(lens),
                                window=window)
    k_pos = np.arange(77)
    mask = (k_pos[None] <= lens[:, None]) & (lens[:, None] - k_pos[None] < window)
    assert not mask[3].any() and mask[:2].any(axis=1).all()
    want = jattn.gqa_attend(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                            jnp.asarray(mask[:, None, None, :]))
    np.testing.assert_allclose(_np(got.float()), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    if name == "float32":
        np.testing.assert_allclose(_np(got)[3, 0], np.repeat(v[3].mean(0), 4, axis=0),
                                   rtol=1e-5, atol=1e-5)


def test_decode_attention_entry_and_wrapper_on_cpu_tensors():
    """``ops.decode_attention`` runs the plain version for CPU tensors and
    returns a tensor there; the kernel wrapper refuses them and counts no
    launch; its shape checks raise ``ValueError``."""
    from repro_torch.kernels import decode_attention as tda
    q, k, v, lens = (_t(a) for a in _decode_inputs(3, 40, 4, 2, 16, seed=3))
    n0 = tda.launches
    got = tops.decode_attention(q, k, v, lens, window=5)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    torch.testing.assert_close(got, tref.decode_attention_ref(q, k, v, lens, window=5),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tda.decode_attention(q, k, v, lens)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tops.decode_attention(q, k, v, lens, impl="cuda")
    assert tda.launches == n0
    tda.check_shapes(q, k, v, lens, 0)
    for args, match in [((q[:, :1].expand(3, 2, 4, 16), k, v, lens, 0), "expected"),
                        ((q, k, v[:, :5], lens, 0), "expected"),
                        ((q, k[:2], v[:2], lens, 0), "do not fit"),
                        ((q, k, v, lens[:2], 0), "lens"),
                        ((q[:, :, :3], k, v, lens, 0), "multiple"),
                        ((torch.zeros(3, 1, 2, 256), torch.zeros(3, 4, 2, 256),
                          torch.zeros(3, 4, 2, 256), lens, 0), "head dim"),
                        ((q, k[:, :0], v[:, :0], lens, 0), "at least one"),
                        ((q, k, v, lens, -1), "window")]:
        with pytest.raises(ValueError, match=match):
            tda.check_shapes(*args)


def test_decode_attention_splits_only_where_blocks_leave_sms_idle():
    """The kernel's grid is (kv-head x q-head group, key chunk, batch row);
    the chunk holds 1024 keys and halves, down to 256, only while the grid
    would leave an SM without a block.  It reads shapes alone: the host
    never sees lens."""
    from repro_torch.kernels.decode_attention import CHUNK_KEYS, MIN_CHUNK, chunk_for
    assert (CHUNK_KEYS, MIN_CHUNK) == (1024, 256)
    assert chunk_for(32, 8, 24, 1024, 132) == 1024        # 256 blocks: one chunk a row
    assert chunk_for(32, 8, 24, 4096, 132) == 1024        # 4 chunks a row
    assert chunk_for(8, 8, 24, 1024, 132) == 256          # 64 and 128 < 132 blocks
    assert chunk_for(8, 8, 24, 128, 132) == 256           # paged decode: one chunk a row
    assert chunk_for(1, 1, 4, 200, 132) == 256
    assert chunk_for(2, 1, 16, 4096, 132) == 256          # 2 q-head groups: 16 chunks each
    assert chunk_for(1, 8, 8, 1, 132) == 256              # one chunk, however small
    assert chunk_for(32, 8, 24, 1024, 600) == 256         # more SMs, smaller chunks
    assert chunk_for(3, 8, 24, 700, 132) == 256           # the floor: 3 x 24 < 132 blocks


def _bf16_ulps(got: torch.Tensor, want) -> int:
    """Largest distance in bf16 units in the last place (bit patterns mapped
    to a monotonic integer scale)."""
    w = torch.from_numpy(np.asarray(want).view(np.int16).copy())
    def key(bits):
        bits = bits.long()
        return torch.where(bits >= 0, bits, -(bits & 0x7FFF))
    return int((key(got.view(torch.int16)) - key(w)).abs().max())


@pytest.mark.parametrize("shape", [(8, 64), (3, 5, 128), (130, 256), (5, 17)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_jax_kernel(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=shape).astype(np.float32)
    scale = rng.normal(size=shape[-1:]).astype(np.float32)
    tx = _t(x).to(getattr(torch, dtype))
    got = tops.rmsnorm(tx, _t(scale), eps=1e-5)
    want = jops.rmsnorm(jnp.asarray(x, dtype), jnp.asarray(scale), eps=1e-5,
                        impl="interpret", block_rows=32)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-6)
    else:
        assert _bf16_ulps(got, want) <= 1
    np.testing.assert_array_equal(
        _np(got.float()), _np(tref.rmsnorm_ref(tx, _t(scale)).float()))


# ---------------------------------------------------------------------------
# dispatch rules
# ---------------------------------------------------------------------------


def test_wrappers_take_the_plain_version_only_for_cpu_tensors():
    """``ops`` alone picks the plain version, and only for CPU tensors; the
    kernel wrappers refuse them and count no launch."""
    rng = np.random.default_rng(41)
    q, cents, store, mask, sq, sc = _ivf_world(4, 128, 16, 8, seed=41,
                                               quantized=True)
    pb = _t(rng.integers(0, 4, size=(1, 16)).astype(np.int32))
    before = (tsim.launches, tivf.launches, tivfq.launches)
    np.testing.assert_allclose(
        tops.similarity(_t(q), _t(q)),
        _np(tref.similarity_ref(_t(q), _t(q))), **TOL)
    ts, tp = tops.ivf_search(_t(q), _t(cents), _t(store), _t(mask), nprobe=2)
    rs, rp = tref.ivf_search_ref(_t(q), _t(cents), _t(store), _t(mask), nprobe=2)
    np.testing.assert_array_equal(tp, _np(rp))
    _assert_plane(ts, rs)
    ts, tp = tops.ivf_search_q(_t(q), _t(cents), _t(sq), _t(sc), _t(mask),
                               nprobe=2)
    rs, rp = tref.ivf_search_q_ref(_t(q), _t(cents), _t(sq), _t(sc), _t(mask),
                                   nprobe=2)
    np.testing.assert_array_equal(tp, _np(rp))
    _assert_plane(ts, rs)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tsim.similarity(_t(q), _t(q))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tivf.cluster_scan(_t(q), _t(store), _t(mask), pb)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tivfq.cluster_scan_q(_t(q), _t(sq), _t(sc), _t(mask), pb)
    assert (tsim.launches, tivf.launches, tivfq.launches) == before
    # the model-facing entries: tensors in, tensors out, on the CPU the plain
    # version; the kernel wrappers refuse CPU tensors and count nothing
    qa, ka, va = (_t(a) for a in _attn_inputs(1, 9, 9, 4, 2, 16, seed=42))
    x, scale = qa.reshape(-1, 16), torch.linspace(0.5, 2.0, 16)
    before = (tfa.launches, trn.launches)
    got = tops.flash_attention(qa, ka, va, causal=True, window=4)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    torch.testing.assert_close(got, tref.flash_attention_ref(qa, ka, va, window=4),
                               rtol=0, atol=0)
    got = tops.rmsnorm(x, scale, eps=1e-6)
    torch.testing.assert_close(got, tref.rmsnorm_ref(x, scale, eps=1e-6), rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfa.flash_attention(qa, ka, va)
    with pytest.raises(ValueError, match="CUDA tensor"):
        trn.rmsnorm(x, scale)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tops.flash_attention(qa, ka, va, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tops.rmsnorm(x, scale, impl="cuda")
    assert (tfa.launches, trn.launches) == before


def test_impl_modes_and_device_switch():
    q = np.eye(4, dtype=np.float32)
    np.testing.assert_allclose(np.diag(tops.similarity(q, q, impl="auto")),
                               np.ones(4), atol=1e-6)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tops.similarity(q, q, impl="cuda")
    with pytest.raises(ValueError, match="impl="):
        tops.similarity(q, q, impl="pallas")
    if not torch.cuda.is_available():
        repro_torch.set_device(None)
        try:
            with pytest.raises(RuntimeError, match="set_device"):
                tops.similarity(q, q)
        finally:
            repro_torch.set_device("cpu")


def test_aligned_rows_gives_the_int8_kernel_16_byte_rows():
    """The int8 scan copies query rows 16 bytes at a time: aligned rows of a
    multiple of 4 floats pass as they are, others are copied, zero-padded."""
    q = torch.arange(24, dtype=torch.float32).reshape(3, 8)
    assert tivfq.aligned_rows(q) is q
    for view in (torch.arange(16, dtype=torch.float32)[1:].view(3, 5),
                 torch.arange(25, dtype=torch.float32)[1:].view(3, 8)):
        got = tivfq.aligned_rows(view)
        d = view.shape[1]
        assert got.shape == (3, d + (-d) % 4) and got.data_ptr() % 16 == 0
        torch.testing.assert_close(got[:, :d], view, rtol=0, atol=0)
        assert not got[:, d:].any()


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    """Shape and launch checks run before any CUDA call, so they show here."""
    q = torch.zeros((12, 8))
    store, mask = torch.zeros((3, 128, 8)), torch.zeros((3, 128))
    pb = torch.zeros((2, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="pre-padded"):
        tivf.check_scan_shapes(q, store, mask, pb, 8)
    with pytest.raises(ValueError, match="built for"):
        tivf.check_scan_shapes(torch.zeros((6, 8)), store, mask, pb, 3)
    # a 16 x 4096 query block and 65536 blocks: both scans stream d through
    # their rings and grid by cluster, so they take them
    wide_q, wide_pb = torch.zeros((32, 4096)), torch.zeros((2, 16), dtype=torch.int32)
    tivf.check_scan_shapes(wide_q, torch.zeros((3, 128, 4096)), mask, wide_pb, 16)
    tivfq.check_launch(2, 16, 3, 128)
    tivfq.check_launch(65536, 8, 3, 128)
    # the int8 scan's limits: int32 probe lists, one CTA per (cluster, 128-row
    # chunk) in one launch, the bucket of ids outside the store included
    tivfq.check_launch(65536, 32767, 2**24 - 2, 128 * 128)
    with pytest.raises(ValueError, match="int32 probe lists"):
        tivfq.check_launch(65536, 32768, 3, 128)
    with pytest.raises(ValueError, match="one launch"):
        tivfq.check_launch(1, 8, 2**24 - 1, 128 * 128 + 1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        from repro_torch.kernels import _build
        _build.require(q, "queries", torch.float32, 2)
    qa, ka = torch.zeros((1, 5, 4, 16)), torch.zeros((1, 5, 2, 16))
    tfa.check_shapes(qa, ka, ka, 0)
    with pytest.raises(ValueError, match="multiple"):
        tfa.check_shapes(torch.zeros((1, 5, 3, 16)), ka, ka, 0)
    with pytest.raises(ValueError, match="head dim"):
        tfa.check_shapes(torch.zeros((1, 5, 4, 256)), torch.zeros((1, 5, 2, 256)),
                         torch.zeros((1, 5, 2, 256)), 0)
    with pytest.raises(ValueError, match="one key"):
        tfa.check_shapes(qa, ka[:, :0], ka[:, :0], 0)
    with pytest.raises(ValueError, match="do not fit"):
        tfa.check_shapes(qa, torch.zeros((2, 5, 2, 16)), torch.zeros((2, 5, 2, 16)), 0)


@pytest.mark.parametrize("entry", ["similarity", "rmsnorm"])
def test_launch_counts_survive_concurrent_ops_calls(entry, monkeypatch):
    """The plan executor calls the ops entries from several fragment threads
    at once: no launch count may be lost between a read and a write.  The
    kernel library is a stub that reports success and ops takes the kernel
    route for CPU tensors, so the wrappers' own counting runs here; 8
    threads x 100 calls under a 1 us switch interval.  CPython 3.12 checks
    for a thread switch at no instruction between a bare ``+=``'s load and
    store, so the count alone would pass without the lock there (not in a
    free-threaded build): the test also requires every count to be taken
    under ``_build``'s lock."""

    class Lock:
        def __init__(self):
            self.lock, self.taken = threading.Lock(), 0

        def __enter__(self):
            self.lock.acquire()
            self.taken += 1

        def __exit__(self, *exc):
            self.lock.release()
    lock = Lock()
    monkeypatch.setattr(_build, "_count_lock", lock)
    monkeypatch.setattr(tops, "_resolve", lambda impl, t: "cuda")
    monkeypatch.setattr(_build, "require", lambda *a, **k: None)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(_build, "function", lambda *a: (lambda *args: 0))
    mod = {"similarity": tsim, "rmsnorm": trn}[entry]
    monkeypatch.setattr(mod, "launches", 0)
    q = np.ones((2, 8), np.float32)
    call = {"similarity": lambda: tops.similarity(q, q),
            "rmsnorm": lambda: tops.rmsnorm(_t(q), torch.ones(8))}[entry]
    threads, calls = 8, 100
    start = threading.Barrier(threads)

    def work():
        start.wait(timeout=30)
        for _ in range(calls):
            call()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(threads) as pool:
            futures = [pool.submit(work) for _ in range(threads)]
            for f in futures:
                f.result(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert mod.launches == lock.taken == threads * calls
