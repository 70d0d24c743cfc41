"""The port's dense model path against ``repro``'s on the CPU: configs, param
specs, the weight bridge (``params_from_numpy``), the layers and
``registry.forward`` under each ``attn_impl``.  JAX draws the weights; they
cross as ``flatten`` -> ``np.asarray`` -> ``params_from_numpy``.

Tolerances: logits of the f32 smoke configs agree to ``atol=1e-4`` (f32
sums in another order through 3 layers); one llama3.2-3b layer at full
width (d 3072, ff 8192, 24/8 heads) to ``atol=5e-4``, for its longer
sums."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro import common as jcommon
from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import registry as jreg
from repro_torch import common as tcommon
from repro_torch import configs as tconfigs
from repro_torch.models import layers as tlayers
from repro_torch.models import registry as treg


@pytest.fixture(autouse=True)
def _cpu():
    repro_torch.set_device("cpu")


def _cfgs(name: str, **kw):
    """The same config from both packages (smoke size, with overrides)."""
    return tconfigs.get_smoke(name).with_(**kw), jconfigs.get_smoke(name).with_(**kw)


def _shared_params(tcfg, jcfg, seed=0):
    """JAX-drawn weights, and the same weights in the port."""
    jp = jreg.init_params(jcfg, jax.random.PRNGKey(seed))
    flat = {p: np.asarray(v) for p, v in jcommon.flatten(jp).items()}
    return tcommon.params_from_numpy(treg.param_specs(tcfg), flat), jp, flat


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# configs and specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(jconfigs.ARCHS))
def test_configs_are_the_references(name):
    t, j = tconfigs.get_config(name), jconfigs.get_config(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(tconfigs.get_smoke(name)) == \
        dataclasses.asdict(jconfigs.get_smoke(name))
    assert t.hd == j.hd and str(t.activation_dtype).split(".")[-1] == j.dtype


@pytest.mark.parametrize("name", ["llama3.2-3b", "qwen1.5-4b", "deepseek-7b", "qwen2-72b"])
def test_dense_param_specs_are_the_references(name):
    tcfg, jcfg = tconfigs.get_config(name), jconfigs.get_config(name)
    ts, js = treg.param_specs(tcfg), jreg.param_specs(jcfg)
    assert sorted(ts) == sorted(js)
    for p in ts:
        assert (ts[p].shape, ts[p].axes, ts[p].init, ts[p].init_scale) == \
            (js[p].shape, js[p].axes, js[p].init, js[p].init_scale), p
        assert str(ts[p].dtype).split(".")[-1] == jnp.dtype(js[p].dtype).name, p
    assert tcfg.param_count() == jcommon.param_count(js)
    assert tcommon.param_bytes(ts) == jcommon.param_bytes(js)


# ---------------------------------------------------------------------------
# the weight bridge and init
# ---------------------------------------------------------------------------


def test_params_from_numpy_round_trips_every_leaf():
    tcfg, jcfg = _cfgs("llama3.2-3b")
    tp, _, flat = _shared_params(tcfg, jcfg)
    tflat = tcommon.flatten(tp)
    assert sorted(tflat) == sorted(flat)
    dtypes = set()
    for path, arr in flat.items():
        t = tflat[path]
        dtypes.add(t.dtype)
        assert tuple(t.shape) == arr.shape and t.device.type == "cpu"
        if t.dtype == torch.bfloat16:           # the bits, not a rounding
            np.testing.assert_array_equal(t.view(torch.int16).numpy(), arr.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), arr)
    assert dtypes == {torch.bfloat16, torch.float32}


def test_params_from_numpy_raises_on_a_mismatch():
    tcfg, jcfg = _cfgs("llama3.2-3b")
    _, _, flat = _shared_params(tcfg, jcfg)
    specs = treg.param_specs(tcfg)
    some = ("layers", "attn", "wq")
    with pytest.raises(KeyError, match="missing"):
        tcommon.params_from_numpy(specs, {p: a for p, a in flat.items() if p != some})
    with pytest.raises(KeyError, match="extra"):
        tcommon.params_from_numpy(specs, {**flat, ("layers", "attn", "bq"): flat[some]})
    with pytest.raises(ValueError, match="shape"):
        tcommon.params_from_numpy(specs, {**flat, some: flat[some][:1]})
    with pytest.raises(ValueError, match="dtype"):
        tcommon.params_from_numpy(specs, {**flat, some: flat[some].astype(np.float32)})


def test_init_params_follows_the_init_rules():
    tcfg = tconfigs.get_smoke("llama3.2-3b").with_(d_model=256, d_ff=512)
    specs = treg.param_specs(tcfg)
    a = treg.init_params(tcfg, torch.Generator().manual_seed(3))
    b = treg.init_params(tcfg, torch.Generator().manual_seed(3))
    fa, fb = tcommon.flatten(a), tcommon.flatten(b)
    for p, spec in specs.items():
        assert fa[p].dtype == spec.dtype and tuple(fa[p].shape) == spec.shape
        assert torch.equal(fa[p], fb[p])
    assert torch.equal(fa[("final_norm", "scale")], torch.ones(256))
    emb = fa[("embed", "embedding")].float()
    assert abs(float(emb.std()) - 0.02) < 0.002
    w = fa[("layers", "ffn", "w_down")].float()          # fan-in 512 (per layer)
    assert abs(float(w.std()) - 1 / np.sqrt(3 * 512)) < 0.002


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_reference(dtype):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 9, 4, 32)).astype(np.float32)
    pos = np.arange(9)[None, :]
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tol = 1e-5 if dtype == "float32" else 1e-2
    got = tlayers.apply_rope(torch.from_numpy(x).to(tdt), torch.from_numpy(pos), 5e5)
    want = jlayers.apply_rope(jnp.asarray(x, jdt), jnp.asarray(pos), 5e5)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    h = rng.normal(size=(2, 9, 64)).astype(np.float32)
    ws = {k: rng.normal(size=s).astype(np.float32) * 0.1
          for k, s in [("w_gate", (64, 96)), ("w_up", (64, 96)), ("w_down", (96, 64))]}
    got = tlayers.swiglu({k: torch.from_numpy(v).to(torch.bfloat16) for k, v in ws.items()},
                         torch.from_numpy(h).to(tdt))
    want = jlayers.swiglu({k: jnp.asarray(v, jnp.bfloat16) for k, v in ws.items()},
                          jnp.asarray(h, jdt))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    scale = rng.normal(size=(64,)).astype(np.float32)
    got = tlayers.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(h).to(tdt))
    want = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(h, jdt))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# registry.forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["full", "chunked", "pallas", "auto"])
@pytest.mark.parametrize("name,kw", [("llama3.2-3b", {}),
                                     ("llama3.2-3b", {"sliding_window": 8}),
                                     ("qwen1.5-4b", {})])
def test_forward_matches_reference(impl, name, kw):
    """Smoke configs (3 layers, d 64, f32), [2, 40] tokens: 40 positions are
    not a multiple of the chunk (16), so the chunked path has a ragged
    tail.  On the CPU the reference's "pallas" runs its jnp contract and
    the port's its plain version."""
    tcfg, jcfg = _cfgs(name, attn_impl=impl, **kw)
    tp, jp, _ = _shared_params(tcfg, jcfg, seed=1)
    toks = _tokens(2, 40, tcfg.vocab_size, seed=2)
    got, aux = treg.forward(tcfg, tp, torch.from_numpy(toks))
    want, _ = jreg.forward(jcfg, jp, jnp.asarray(toks))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 40, tcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_one_full_width_llama_layer_matches_reference():
    """llama3.2-3b at its published widths with one layer: d 3072, 24/8
    heads, hd 128, ff 8192; f32 activations over the bf16 weights, [2, 40]
    tokens.  The vocabulary is the repo's byte tokenizer's (384), as the
    engine uses it."""
    kw = dict(num_layers=1, dtype="float32", attn_impl="pallas", vocab_size=384)
    tcfg = tconfigs.get_config("llama3.2-3b").with_(**kw)
    jcfg = jconfigs.get_config("llama3.2-3b").with_(**kw)
    tp, jp, _ = _shared_params(tcfg, jcfg, seed=5)
    toks = _tokens(2, 40, tcfg.vocab_size, seed=6)
    got, _ = treg.forward(tcfg, tp, torch.from_numpy(toks))
    want, _ = jreg.forward(jcfg, jp, jnp.asarray(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=0)
