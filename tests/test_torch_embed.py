"""The port's E5 embedder, ``make_session`` and serving CLI against
``repro``'s on the CPU.

``Embedder`` runs on weights drawn by JAX and crossed with
``params_from_numpy`` (f32, 2 layers, d 64): pooled unit vectors agree with
the reference's to 1e-5, under the config's ``attn_impl="auto"`` (the plain
path on the CPU) and under ``"pallas"`` (the reference's Pallas kernel in
interpret mode against the port's non-causal ``flash_attention`` contract),
and ``sem_search`` over them returns identical ids.  ``make_session`` builds
the same roles and configs as the reference's, and ``launch.serve.main()``
serves every session it is given, with the reference's records.
"""
import dataclasses
import json
import sys

import jax
import numpy as np
import pytest

import repro_torch
from repro import common as jcommon
from repro.core.backends import jax_engine
from repro.core.operators import search as jsearch
from repro.embed import encoder as jencoder
from repro.launch import serve as jserve
from repro_torch import common as tcommon
from repro_torch.core.backends import torch_engine
from repro_torch.core.operators import search as tsearch
from repro_torch.embed import encoder as tencoder
from repro_torch.launch import serve as tserve
from repro_torch.obs import parse_exposition

TOL = 1e-5
SMALL = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128)


@pytest.fixture(autouse=True)
def _cpu():
    repro_torch.set_device("cpu")


def _embedders(attn_impl: str = "auto", seed: int = 3):
    jcfg = jencoder.E5_SMALL.with_(attn_impl=attn_impl, **SMALL)
    tcfg = tencoder.E5_SMALL.with_(attn_impl=attn_impl, **SMALL)
    jp = jcommon.init_params(jencoder.param_specs(jcfg), jax.random.PRNGKey(seed))
    flat = {p: np.asarray(v) for p, v in jcommon.flatten(jp).items()}
    tp = tcommon.params_from_numpy(tencoder.param_specs(tcfg), flat)
    return tencoder.Embedder(tcfg, tp), jencoder.Embedder(jcfg, jp)


def _texts(n: int, seed: int) -> list[str]:
    """Texts of 1..300 bytes (some past ``max_len``), so batches pad to
    other widths, over the byte range and a few multi-byte characters."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        m = int(rng.integers(1, 300))
        out.append("".join(chr(int(c)) for c in rng.integers(32, 127, m)) + "ü" * (m % 4))
    return out


def test_e5_small_config_carries_across():
    assert dataclasses.asdict(tencoder.E5_SMALL) == dataclasses.asdict(jencoder.E5_SMALL)
    assert tencoder.param_specs().keys() == jencoder.param_specs().keys()
    for path, spec in tencoder.param_specs().items():
        jspec = jencoder.param_specs()[path]
        assert spec.shape == jspec.shape and spec.axes == jspec.axes, path


@pytest.mark.parametrize("attn_impl", ["auto", "pallas"])
def test_embedder_matches_reference(attn_impl):
    temb, jemb = _embedders(attn_impl)
    texts = _texts(70, seed=1)                   # two batches: 64 + 6
    got, want = temb.embed(texts), jemb.embed(texts)
    assert got.shape == want.shape == (70, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    assert temb.dim == jemb.dim == 64
    assert temb.embed([]).shape == jemb.embed([]).shape == (0, 64)


def test_embedder_from_seed_is_deterministic_and_unit():
    cfg = tencoder.E5_SMALL.with_(**SMALL)
    a = tencoder.Embedder(cfg, seed=5).embed(["alpha", "beta gamma"])
    b = tencoder.Embedder(cfg, seed=5).embed(["alpha", "beta gamma"])
    c = tencoder.Embedder(cfg, seed=6).embed(["alpha", "beta gamma"])
    assert np.array_equal(a, b) and not np.allclose(a, c)
    np.testing.assert_allclose(np.linalg.norm(a, axis=1), 1.0, atol=1e-5)


def test_sem_search_over_embedder_matches_reference():
    temb, jemb = _embedders()
    corpus = _texts(150, seed=2)
    tidx = tsearch.sem_index(corpus, temb, index="exact")
    jidx = jsearch.sem_index(corpus, jemb, index="exact")
    for q in (corpus[7], corpus[90], "a query that is in no document"):
        thits, tst = tsearch.sem_search(tidx, q, temb, k=10)
        jhits, jst = jsearch.sem_search(jidx, q, jemb, k=10)
        assert list(thits) == list(jhits)
        assert tst["scored_vectors"] == jst["scored_vectors"]


def test_make_session_roles_and_configs_match_reference():
    tsess = torch_engine.make_session(max_seq=64, seed=1, sample_size=17)
    jsess = jax_engine.make_session(max_seq=64, seed=1, sample_size=17)
    # the Session wraps each role for accounting; the models sit inside
    for role in ("oracle", "proxy"):
        t, j = getattr(tsess, role), getattr(jsess, role)
        assert t.role == j.role == role
        assert isinstance(t._m, torch_engine.EngineModel)
        assert t._m.max_new_tokens == j._m.max_new_tokens
        assert dataclasses.asdict(t._m.engine.cfg) == dataclasses.asdict(j._m.engine.cfg), role
        assert t._m.engine.runner.max_seq == j._m.engine.runner.max_seq == 64
    temb, jemb = tsess.embedder._e, jsess.embedder._e
    assert isinstance(temb, tencoder.Embedder)
    assert dataclasses.asdict(temb.cfg) == dataclasses.asdict(jemb.cfg)
    assert temb.max_len == jemb.max_len
    assert tsess.sample_size == jsess.sample_size == 17
    passes, scores = tsess.oracle.predicate(["the sky is blue", "2 + 2 = 5"])
    assert passes.shape == (2,) and ((scores > 0) & (scores < 1)).all()
    assert tsess.embedder.embed(["a", "b"]).shape == (2, tsess.embedder.dim)


def _serve(module, argv, monkeypatch, capsys) -> list[str]:
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    module.main()
    return capsys.readouterr().out.splitlines()


def _sessions(lines: list[str]) -> list[dict]:
    return [json.loads(line[len("[serve] "):]) for line in lines
            if line.startswith('[serve] {"sid"')]


def test_serve_cli_sim_matches_reference(monkeypatch, capsys, tmp_path):
    argv = ["--sessions", "4", "--tenants", "2", "--records", "60", "--audit",
            "--metrics-dump", str(tmp_path / "m.txt")]
    tout = _serve(tserve, argv, monkeypatch, capsys)
    jout = _serve(jserve, argv, monkeypatch, capsys)
    assert any(line.startswith("[serve] 4/4 sessions") for line in tout), tout
    tses, jses = _sessions(tout), _sessions(jout)
    assert [(s["tenant"], s["status"], s["rows"]) for s in tses] == \
        [(s["tenant"], s["status"], s["rows"]) for s in jses]
    assert all(s["status"] == "done" for s in tses)
    audit = next(line for line in tout if line.startswith("[serve] audit "))
    report = json.loads(audit[len("[serve] audit "):])
    assert any(c["audited"] > 0 for c in report["cascades"])
    assert parse_exposition((tmp_path / "m.txt").read_text())


def test_serve_cli_engine_serves_every_session(monkeypatch, capsys):
    out = _serve(tserve, ["--backend", "engine", "--sessions", "2", "--records", "6",
                          "--max-seq", "128"], monkeypatch, capsys)
    assert any(line.startswith("[serve] 2/2 sessions") for line in out), out
    assert all(s["status"] == "done" for s in _sessions(out))
