"""The port's retrieval layer against ``repro``'s on the same corpora:
``VectorIndex`` and ``IVFIndex`` (fp32 and int8) searched in both packages
must return the same ids, scores within 1e-5 (f32 dot products of unit
vectors, summed in another order) and exactly the same ``last_stats``.
Covers search, ``add()`` with the delta buffer, sync and background
retrain, ``max_pos``, ``nprobe = n_clusters``, sharded layouts, the int8
rerank, ``ivf_from_arrays`` and indexes saved by one package and loaded by
the other.  The reference runs its jnp contracts and, where marked, its
Pallas bodies in interpret mode."""
import numpy as np
import pytest
import torch

import repro_torch
from repro.index import IVFIndex as JIVF
from repro.index import VectorIndex as JVec
from repro.index import load_index as jload
from repro.kernels import ops as jops
from repro_torch.index import IVFIndex, VectorIndex, ivf_from_arrays, load_index
from repro_torch.index.backend import MASKED_SCORE

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu():
    repro_torch.set_device("cpu")


@pytest.fixture(params=["ref", "interpret"])
def jax_impl(request, monkeypatch):
    """The reference index dispatches through ``repro.kernels.ops``; pin its
    implementation for one test (jnp contract or interpreted Pallas body)."""
    monkeypatch.setattr(jops, "DEFAULT_IMPL", request.param)
    return request.param


def _clustered(n, d=32, n_centers=20, noise=0.15, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_centers, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    lab = rng.integers(n_centers, size=n)
    x = centers[lab] + noise * rng.normal(size=(n, d))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return np.asarray(x, np.float32), centers


def _queries(x, n, seed):
    rng = np.random.default_rng(seed)
    return np.asarray(x[rng.integers(len(x), size=n)]
                      + 0.05 * rng.normal(size=(n, x.shape[1])), np.float32)


def _same(port, ref, q, k, **kw):
    """Search both; ids and last_stats exactly equal, scores allclose."""
    ts, ti = port.search(q, k, **kw)
    js, ji = ref.search(q, k, **kw)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, **TOL)
    assert port.last_stats == ref.last_stats
    return ts, ti


# ---------------------------------------------------------------------------
# exact index
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 10])
def test_vector_index_search_add_and_max_pos(k):
    x, _ = _clustered(600, seed=1)
    q = _queries(x, 9, seed=2)
    port, ref = VectorIndex(x[:500]), JVec(x[:500])
    _same(port, ref, q, k)
    port.add(x[500:])
    ref.add(x[500:])
    _same(port, ref, q, k)
    _same(port, ref, q, k, max_pos=550)
    np.testing.assert_allclose(port.pairwise(q), ref.pairwise(q), **TOL)


def test_vector_index_sharded_matches_reference():
    x, _ = _clustered(900, seed=3)
    q = _queries(x, 7, seed=4)
    _same(VectorIndex(x, shards=4), JVec(x, shards=4), q, 8)


# ---------------------------------------------------------------------------
# IVF fp32 and int8
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_ivf_search_matches_reference(quantize, jax_impl):
    x, _ = _clustered(2000, seed=5)
    q = _queries(x, 13, seed=6)
    kw = dict(n_clusters=16, nprobe=3, seed=1, quantize=quantize)
    port, ref = IVFIndex(x, **kw), JIVF(x, **kw)
    np.testing.assert_array_equal(port.assign, ref.assign)
    _, ti = _same(port, ref, q, 10)
    st = port.last_stats
    assert st["quantize"] == quantize and st["scored_vectors"] < 13 * len(x)
    if quantize == "int8":
        assert st["reranked"] > 0
        assert port.store is None and port._dev["store_q"].dtype == torch.int8


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_ivf_full_probe_equals_exact_index(quantize):
    x, _ = _clustered(800, seed=7)
    q = np.asarray(x[::97][:9] + 0.01, np.float32)
    ivf = IVFIndex(x, n_clusters=16, seed=2, quantize=quantize)
    es, ei = VectorIndex(x).search(q, 7)
    vs, vi = _same(ivf, JIVF(x, n_clusters=16, seed=2, quantize=quantize), q, 7,
                   nprobe=ivf.n_clusters)
    np.testing.assert_array_equal(vi, ei)
    np.testing.assert_allclose(vs, es, **TOL)


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_ivf_delta_buffer_and_max_pos_match_reference(quantize, jax_impl):
    x, _ = _clustered(1200, seed=8)
    kw = dict(n_clusters=16, seed=8, retrain="off", quantize=quantize)
    port, ref = IVFIndex(x[:1000], **kw), JIVF(x[:1000], **kw)
    port.add(x[1000:])
    ref.add(x[1000:])
    q = np.asarray(x[990:1010] + 0.01, np.float32)
    _same(port, ref, q, 8)
    assert port.last_stats["delta_rows"] == 200
    _same(port, ref, q, 8, nprobe=4, max_pos=1050)
    _same(port, ref, q, 8, nprobe=port.n_clusters, max_pos=700)


def test_ivf_small_clusters_fill_k_and_empty_queries():
    """Fewer real candidates than k in the probed tiles: the probe floor
    widens the scan in both packages alike; an empty query set returns
    empty results."""
    x, _ = _clustered(200, seed=9)
    port = IVFIndex(x, n_clusters=50, nprobe=1, seed=3)
    ref = JIVF(x, n_clusters=50, nprobe=1, seed=3)
    s, i = _same(port, ref, x[:3], 20)
    assert (s > MASKED_SCORE / 2).all()
    empty = np.zeros((0, 32), np.float32)
    s, i = _same(port, ref, empty, 5)
    assert s.shape == i.shape == (0, 5)


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_ivf_sync_retrain_matches_reference(quantize):
    x, _ = _clustered(3000, seed=10)
    kw = dict(seed=9, retrain="sync", spill_threshold=0.10, quantize=quantize)
    port, ref = IVFIndex(x[:2500], **kw), JIVF(x[:2500], **kw)
    port.add(x[2500:])
    ref.add(x[2500:])
    assert port.retrains == ref.retrains == 1 and port.delta_rows == 0
    np.testing.assert_array_equal(port.centroids, ref.centroids)
    np.testing.assert_array_equal(port.assign, ref.assign)
    _same(port, ref, _queries(x, 8, seed=11), 10)


def test_ivf_background_retrain_swaps_device_store():
    x, _ = _clustered(3000, seed=12)
    port = IVFIndex(x[:2500], seed=6, spill_threshold=0.10)
    before = port._dev
    port.add(x[2500:])
    port.wait_retrain(timeout=60.0)
    assert port.retrains == 1 and port.delta_rows == 0
    assert port._dev is not before
    assert port._dev["store"].shape == port.store.shape
    _same(port, JIVF(x, seed=6), x[:4] + 0.01, 5)


def test_ivf_skewed_clusters_rebalanced_like_reference():
    rng = np.random.default_rng(20)
    dominant = rng.normal(size=32)
    dominant /= np.linalg.norm(dominant)
    x = np.concatenate([dominant + 0.02 * rng.normal(size=(1500, 32)),
                        rng.normal(size=(100, 32))])
    x = np.asarray(x / np.linalg.norm(x, axis=1, keepdims=True), np.float32)
    port, ref = IVFIndex(x, n_clusters=16, seed=6), JIVF(x, n_clusters=16, seed=6)
    np.testing.assert_array_equal(port.cluster_sizes, ref.cluster_sizes)
    assert port.store.shape == ref.store.shape
    _same(port, ref, np.asarray(x[::211][:6] + 0.01, np.float32), 8,
          nprobe=port.n_clusters)


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_ivf_sharded_layout_matches_reference(quantize):
    x, _ = _clustered(2000, seed=13)
    kw = dict(nprobe=5, seed=4, quantize=quantize, shards=4)
    port, ref = IVFIndex(x, **kw), JIVF(x, **kw)
    _same(port, ref, np.asarray(x[::151][:9] + 0.01, np.float32), 6)
    assert port.last_stats["shards"] == 4


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_int8_rerank_scores_are_exact_and_bytes_fewer(quantize):
    x, centers = _clustered(4000, seed=14)
    q = _queries(x, 16, seed=15)
    fp = IVFIndex(x, nprobe=6, seed=5)
    fp.search(q, 10)
    idx = IVFIndex(x, nprobe=6, seed=5, quantize=quantize)
    ts, ti = _same(idx, JIVF(x, nprobe=6, seed=5, quantize=quantize), q, 10)
    exact = (x[ti] @ (q / np.linalg.norm(q, axis=1, keepdims=True))[:, :, None])[..., 0]
    np.testing.assert_allclose(ts, exact, **TOL)
    if quantize == "int8":
        assert idx.last_stats["scanned_bytes"] < fp.last_stats["scanned_bytes"]


# ---------------------------------------------------------------------------
# state crossing from the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_ivf_from_arrays_answers_like_the_reference(quantize):
    x, _ = _clustered(1500, seed=16)
    ref = JIVF(x, n_clusters=12, nprobe=3, seed=7, quantize=quantize)
    port = ivf_from_arrays(x, ref.centroids, ref.assign, n_clusters=12,
                           nprobe=3, seed=7, quantize=quantize)
    _same(port, ref, _queries(x, 10, seed=17), 6)


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_index_saved_by_reference_loads_in_port(tmp_path, quantize):
    x, _ = _clustered(1200, seed=18)
    ref = JIVF(x[:1000], n_clusters=16, seed=11, retrain="off", quantize=quantize)
    ref.add(x[1000:])                       # the saved delta buffer too
    ref.save(str(tmp_path / "ivf"))
    port = load_index(str(tmp_path / "ivf"))
    assert isinstance(port, IVFIndex) and port.delta_rows == 200
    assert port.ids == ref.ids and port.quantize == quantize
    _same(port, ref, _queries(x, 8, seed=19), 6)
    exact = JVec(x, ids=[f"r{i}" for i in range(len(x))])
    exact.save(str(tmp_path / "exact"))
    port = load_index(str(tmp_path / "exact"))
    assert isinstance(port, VectorIndex) and port.ids == exact.ids
    _same(port, exact, _queries(x, 8, seed=20), 6)


def test_index_saved_by_port_loads_in_reference(tmp_path):
    x, _ = _clustered(900, seed=21)
    port = IVFIndex(x, nprobe=4, seed=3, quantize="int8", rerank_factor=3)
    port.save(str(tmp_path / "ivf"))
    ref = jload(str(tmp_path / "ivf"))
    assert ref.rerank_factor == 3
    _same(port, ref, np.asarray(x[::97][:6] + 0.01, np.float32), 5)
