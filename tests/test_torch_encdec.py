"""The port's encoder-decoder family (whisper-small, ``audio``) against
``repro``'s on the CPU: LayerNorm and the GELU FFN, the sinusoidal encoder
positions, the encoder, and ``forward`` / ``prefill`` / ``decode_step`` of
the smoke config under ``full`` and ``chunked`` attention; then the engine
with a per-request ``extra["audio_frames"]`` through the runner and the
continuous-batching scheduler.  JAX draws the weights; they cross as
``flatten`` -> ``np.asarray`` -> ``params_from_numpy``.

Tolerances: the layers and positions agree to ``1e-5`` in f32 (to bf16's
rounding in bf16); the encoder and the logits through the smoke config's
2 + 2 layers to ``1e-4``.  Greedy tokens are identical to the reference's
up to the first step whose top-1/top-2 margin (in the reference) is below
``1e-3``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro import common as jcommon
from repro import configs as jconfigs
from repro.engine.runner import ModelRunner as JRunner
from repro.engine.scheduler import ContinuousBatchScheduler as JSched
from repro.engine.scheduler import Request as JRequest
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.models import registry as jreg
from repro_torch import common as tcommon
from repro_torch import configs as tconfigs
from repro_torch.engine.runner import ModelRunner as TRunner
from repro_torch.engine.scheduler import ContinuousBatchScheduler as TSched
from repro_torch.engine.scheduler import Request as TRequest
from repro_torch.models import encdec as tencdec
from repro_torch.models import layers as tlayers
from repro_torch.models import registry as treg

WHISPER = "whisper-small"
ATOL_LAYER = 1e-5
ATOL_MODEL = 1e-4
NEAR_TIE = 1e-3


@pytest.fixture(autouse=True)
def _cpu():
    repro_torch.set_device("cpu")


def _np(x):
    return x.detach().cpu().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _jit(fn, *args, **kw):
    """The reference's ``fn`` with its leading arguments bound, jitted."""
    return jax.jit(functools.partial(fn, *args, **kw))


def _model(seed: int = 0, **kw):
    """The smoke config from both packages and the same JAX-drawn weights in
    each; the f32 biases (zeros at init) drawn too, so that they count."""
    tcfg = tconfigs.get_smoke(WHISPER).with_(**kw)
    jcfg = jconfigs.get_smoke(WHISPER).with_(**kw)
    jp = jreg.init_params(jcfg, jax.random.PRNGKey(seed))
    flat = {p: np.asarray(v) for p, v in jcommon.flatten(jp).items()}
    rng = np.random.default_rng(seed + 100)
    for p in flat:
        if p[-1] in ("bias", "b_in", "b_out", "bq", "bk", "bv"):
            flat[p] = rng.normal(scale=0.1, size=flat[p].shape).astype(np.float32)
    jp = jcommon.unflatten({p: jnp.asarray(v) for p, v in flat.items()})
    return tcfg, jcfg, tcommon.params_from_numpy(treg.param_specs(tcfg), flat), jp


def _frames(cfg, b: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(
        size=(b, cfg.num_audio_frames, cfg.d_model)).astype(np.float32)


def _extras(frames: np.ndarray):
    return {"audio_frames": torch.from_numpy(frames)}, {"audio_frames": jnp.asarray(frames)}


def _assert_caches(tcache, jcache, atol):
    t = {k: _np(v) for k, v in tcommon.flatten(tcache).items()}
    j = {k: _np(v) for k, v in jcommon.flatten(jcache).items()}
    assert t.keys() == j.keys()
    for key in t:
        np.testing.assert_allclose(t[key], j[key], atol=atol, rtol=0, err_msg=str(key))


# ---------------------------------------------------------------------------
# specs, layers, encoder
# ---------------------------------------------------------------------------


def test_whisper_param_and_cache_specs_are_the_references():
    tcfg, jcfg = tconfigs.get_config(WHISPER), jconfigs.get_config(WHISPER)
    ts, js = treg.param_specs(tcfg), jreg.param_specs(jcfg)
    assert sorted(ts) == sorted(js)
    for p in ts:
        assert (ts[p].shape, ts[p].axes, ts[p].init, ts[p].init_scale) == \
            (js[p].shape, js[p].axes, js[p].init, js[p].init_scale), p
        assert str(ts[p].dtype).split(".")[-1] == jnp.dtype(js[p].dtype).name, p
    assert tcfg.param_count() == jcommon.param_count(js)
    assert tcommon.param_bytes(ts) == jcommon.param_bytes(js)
    tc, jc = treg.cache_specs(tcfg, 3, 64), jreg.cache_specs(jcfg, 3, 64)
    assert list(tc) == list(jc)
    for p in tc:
        assert (tc[p].shape, tc[p].axes) == (jc[p].shape, jc[p].axes), p
        assert str(tc[p].dtype).split(".")[-1] == jnp.dtype(jc[p].dtype).name, p


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_and_gelu_ffn_match_reference(dtype):
    """LayerNorm (f32 statistics) and the tanh-approximated GELU FFN at
    d 96, ff 160 on [2, 7, 96] inputs, with drawn scales and biases."""
    rng = np.random.default_rng(1)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    x = jnp.asarray(rng.normal(size=(2, 7, 96)), jdt)
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt)
    ln = {"scale": rng.normal(1.0, 0.2, 96).astype(np.float32),
          "bias": rng.normal(0.0, 0.2, 96).astype(np.float32)}
    ffn = {"w_in": jnp.asarray(rng.normal(0, 0.1, (96, 160)), jnp.bfloat16),
           "b_in": rng.normal(0, 0.1, 160).astype(np.float32),
           "w_out": jnp.asarray(rng.normal(0, 0.1, (160, 96)), jnp.bfloat16),
           "b_out": rng.normal(0, 0.1, 96).astype(np.float32)}
    tol = ATOL_LAYER if dtype == "float32" else 2e-2
    for tfn, jfn, params in ((tlayers.layernorm, jlayers.layernorm, ln),
                             (tlayers.gelu_ffn, jlayers.gelu_ffn, ffn)):
        tp = {k: tcommon._leaf_tensor(np.asarray(v)) for k, v in params.items()}
        got = tfn(tp, tx)
        want = jfn({k: jnp.asarray(v) for k, v in params.items()}, x)
        assert got.dtype == tdt
        np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def test_sinusoidal_positions_match_reference():
    """The encoder's positions in f32 at the smoke config's 24 frames and at
    whisper's 1500 frames by 768 (angles up to 1499 rad, where one ulp of
    the angle moves sin by 1.2e-4)."""
    for t, d in ((24, 64), (1500, 768)):
        np.testing.assert_allclose(_np(tencdec._sinusoidal(t, d)),
                                   np.asarray(jencdec._sinusoidal(t, d)), atol=2.5e-4, rtol=0)
    np.testing.assert_allclose(_np(tencdec._sinusoidal(24, 64)),
                               np.asarray(jencdec._sinusoidal(24, 64)), atol=ATOL_LAYER, rtol=0)


@pytest.mark.parametrize("impl", ["full", "chunked"])
def test_encode_matches_reference(impl):
    """The bidirectional encoder over [2, 24, 64] frames: to 1e-4, and its
    first row moves with the last frame (it is not causal)."""
    tcfg, jcfg, tp, jp = _model(seed=2, attn_impl=impl)
    fr = _frames(tcfg, 2, seed=3)
    got = tencdec.encode(tp, torch.from_numpy(fr), cfg=tcfg)
    want = _jit(jencdec.encode, cfg=jcfg)(jp, jnp.asarray(fr))
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL_MODEL, rtol=0)
    fr2 = fr.copy()
    fr2[:, -1] = _frames(tcfg, 2, seed=4)[:, -1]
    moved = tencdec.encode(tp, torch.from_numpy(fr2), cfg=tcfg)
    assert float((moved[:, 0] - got[:, 0]).abs().max()) > 1e-4


# ---------------------------------------------------------------------------
# forward, prefill and decode_step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar_len", "per_row_len"])
@pytest.mark.parametrize("impl", ["full", "chunked"])
def test_forward_prefill_decode_match_reference(impl, per_row):
    """[2, 24] tokens over [2, 24, 64] frames: forward logits, a prefill of
    23 tokens with both cache entries (the decoder's K/V and the cross K/V),
    and the decode step of the 24th (``cache_len`` a scalar or a [B]
    vector, which reads the learned position of each row), each to the
    reference's; the decode step equals the forward's last row."""
    tcfg, jcfg, tp, jp = _model(seed=4, attn_impl=impl)
    b, s = 2, 24
    toks = np.random.default_rng(5).integers(0, tcfg.vocab_size, (b, s)).astype(np.int32)
    t_extra, j_extra = _extras(_frames(tcfg, b, seed=6))
    tt = torch.from_numpy(toks).long()
    got, aux = treg.forward(tcfg, tp, tt, extra=t_extra)
    want, _ = _jit(jreg.forward, jcfg)(jp, jnp.asarray(toks), extra=j_extra)
    assert aux == {} and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL_MODEL, rtol=0)

    tcache, jcache = treg.init_cache(tcfg, b, s + 4), jreg.init_cache(jcfg, b, s + 4)
    tl, tcache = treg.prefill(tcfg, tp, tt[:, :s - 1], tcache, extra=t_extra)
    jl, jcache = _jit(jreg.prefill, jcfg)(jp, jnp.asarray(toks[:, :s - 1]), jcache,
                                          extra=j_extra)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL_MODEL, rtol=0)
    _assert_caches(tcache, jcache, ATOL_MODEL)

    lens = np.full(b, s - 1, np.int32) if per_row else s - 1
    td, tcache = treg.decode_step(tcfg, tp, tt[:, s - 1:], tcache,
                                  torch.from_numpy(lens) if per_row else lens)
    jd, jcache = _jit(jreg.decode_step, jcfg)(jp, jnp.asarray(toks[:, s - 1:]), jcache,
                                              jnp.asarray(lens, jnp.int32))
    np.testing.assert_allclose(_np(td), _np(jd), atol=ATOL_MODEL, rtol=0)
    np.testing.assert_allclose(_np(td)[:, 0], _np(got)[:, s - 1], atol=ATOL_MODEL, rtol=0)
    _assert_caches(tcache, jcache, ATOL_MODEL)


def test_audio_frames_are_required_and_count():
    tcfg, _, tp, _ = _model(seed=7)
    toks = torch.from_numpy(np.random.default_rng(8).integers(0, 512, (1, 9)))
    a, _ = treg.forward(tcfg, tp, toks, extra=_extras(_frames(tcfg, 1, seed=9))[0])
    b, _ = treg.forward(tcfg, tp, toks, extra=_extras(_frames(tcfg, 1, seed=10))[0])
    assert float((a - b).abs().max()) > 1e-3
    with pytest.raises(ValueError, match="audio_frames"):
        treg.forward(tcfg, tp, toks)
    with pytest.raises(ValueError, match="audio_frames"):
        treg.prefill(tcfg, tp, toks, treg.init_cache(tcfg, 1, 16))


# ---------------------------------------------------------------------------
# the engine: per-request audio through the runner and the scheduler
# ---------------------------------------------------------------------------


def _requests(req_cls, cfg, n: int):
    rng = np.random.default_rng(11)
    out = []
    for i in range(n):
        toks = rng.integers(1, cfg.vocab_size, int(rng.integers(3, 30))).astype(np.int32)
        out.append(req_cls(rid=i, tokens=toks, max_new_tokens=8,
                           extra={"audio_frames": _frames(cfg, 1, seed=20 + i)}))
    return out


def _log_softmax(z: np.ndarray) -> np.ndarray:
    z = z.astype(np.float64)
    m = z.max(-1, keepdims=True)
    return z - m - np.log(np.exp(z - m).sum(-1, keepdims=True))


def _teacher_forced(runner, req) -> np.ndarray:
    """Log-probs of each generated position of ``req`` fed back through
    slot 0 of ``runner`` (the other slots step on, unread)."""
    logits = [runner.prefill_into_slot(req.tokens, 0, req.extra)]
    lens = np.zeros(runner.max_slots, np.int32)
    lens[0] = len(req.tokens)
    nxt = np.zeros(runner.max_slots, np.int32)
    for tok in req.out_tokens[:-1]:
        nxt[0] = tok
        logits.append(runner.decode(nxt, lens)[0])
        lens = lens + 1
    return _log_softmax(np.stack(logits))


def test_scheduler_with_audio_frames_matches_reference():
    """Five requests through three slots of both packages' scheduler, each
    with its own frames as ``Request.extra``, 8 greedy tokens each: the
    port's tokens equal the reference's up to the first near-tie, and the
    reference's tokens teacher-forced through both runners give log-probs
    within 1e-4."""
    tcfg, jcfg, tp, jp = _model(seed=12)
    done = {}
    tfr, jfr = (TRunner(tcfg, tp, max_slots=3, max_seq=64),
                JRunner(jcfg, jp, max_slots=3, max_seq=64))
    for key, runner, sched_cls, req_cls in (("t", tfr, TSched, TRequest),
                                            ("j", jfr, JSched, JRequest)):
        sched = sched_cls(runner)
        for r in _requests(req_cls, tcfg, 5):
            if key == "j":
                r.extra = {"audio_frames": jnp.asarray(r.extra["audio_frames"])}
            sched.submit(r)
        done[key] = sorted(sched.run_to_completion(), key=lambda r: r.rid)
    for tr, jr in zip(done["t"], done["j"]):
        assert tr.done and jr.done and not tr.failed and not jr.failed
        lp_j = _teacher_forced(jfr, jr)
        np.testing.assert_allclose(_teacher_forced(tfr, jr), lp_j, atol=ATOL_MODEL, rtol=0)
        top2 = np.sort(lp_j, -1)[:, -2:]
        ties = np.flatnonzero(top2[:, 1] - top2[:, 0] < NEAR_TIE)
        upto = int(ties[0]) + 1 if len(ties) else len(jr.out_tokens)
        assert tr.out_tokens[:upto] == jr.out_tokens[:upto], (tr.rid, upto)


def test_prefill_into_slot_writes_both_cache_entries():
    """A request prefilled into slot 2 of a 3-slot runner writes its rows of
    the decoder's K/V and of the cross K/V, leaves the other slots' rows as
    they were, and decodes as the same request alone in a one-slot runner."""
    tcfg, _, tp, _ = _model(seed=13)
    reqs = _requests(TRequest, tcfg, 3)
    runner = TRunner(tcfg, tp, max_slots=3, max_seq=48)
    assert set(runner.cache) == {"self", "cross"}
    for slot, r in enumerate(reqs[:2]):
        runner.prefill_into_slot(r.tokens, slot, r.extra)
    before = {k: v.clone() for k, v in tcommon.flatten(runner.cache).items()}
    first = runner.prefill_into_slot(reqs[2].tokens, 2, reqs[2].extra)
    for key, v in tcommon.flatten(runner.cache).items():
        assert torch.equal(v[:, :2], before[key][:, :2]), key
        assert bool(v[:, 2].abs().sum() > 0), key
    alone = TRunner(tcfg, tp, max_slots=1, max_seq=48)
    np.testing.assert_allclose(first, alone.prefill_into_slot(reqs[2].tokens, 0,
                                                              reqs[2].extra), atol=1e-6)
    lens = np.asarray([len(r.tokens) for r in reqs], np.int32)
    rng = np.random.default_rng(14)
    for _ in range(4):
        nxt = rng.integers(1, tcfg.vocab_size, 3).astype(np.int32)
        np.testing.assert_allclose(runner.decode(nxt, lens)[2],
                                   alone.decode(nxt[2:], lens[2:])[0], atol=1e-5, rtol=0)
        lens = lens + 1
