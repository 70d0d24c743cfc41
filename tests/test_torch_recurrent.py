"""The port's recurrent families against ``repro``'s on the CPU: the SSD
primitive (``ssd_chunked``, ``ssd_decode_step``), the Mamba2, mLSTM and
sLSTM mixers, and ``forward`` / ``prefill`` / ``decode_step`` of the
xlstm-125m (``ssm``) and zamba2-7b (``hybrid``) smoke configs under
``full`` and ``chunked`` attention; the runner's true-length prefill, its
slot write, ``EngineModel.predicate`` over a recurrent oracle, and paged
decode's refusal of the families it does not serve.  JAX draws the
weights; they cross as ``flatten`` -> ``np.asarray`` ->
``params_from_numpy``.

Two departures from the reference are held here (ROADMAP §3): the runner
prefills a recurrent family at the prompt's true length (the reference's
bucket padding feeds pad tokens into the state), and an mLSTM prefill
shorter than ``ssm_conv - 1`` tokens keeps its conv history (the
reference's is dropped).  Both are held to the reference's teacher-forced
``forward``, which neither fault touches.

Tolerances: the primitives and mixers agree to ``1e-5`` (f32 sums in
another order); logits and caches through the smoke configs' 4-5 layers to
``1e-4``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro import common as jcommon
from repro import configs as jconfigs
from repro.core.backends.jax_engine import EngineModel as JEngineModel
from repro.engine.engine import InferenceEngine as JEngine
from repro.engine.runner import ModelRunner as JRunner
from repro.models import registry as jreg
from repro.models import ssm as jssm
from repro.models import xlstm as jxlstm
from repro_torch import common as tcommon
from repro_torch import configs as tconfigs
from repro_torch.core.backends.torch_engine import EngineModel as TEngineModel
from repro_torch.data.tokenizer import TOKENIZER
from repro_torch.engine import paged as tpaged
from repro_torch.engine.engine import InferenceEngine as TEngine
from repro_torch.engine.runner import ModelRunner as TRunner
from repro_torch.models import registry as treg
from repro_torch.models import ssm as tssm
from repro_torch.models import xlstm as txlstm

XLSTM, ZAMBA = "xlstm-125m", "zamba2-7b"
ATOL_PRIM = 1e-5
ATOL_MODEL = 1e-4


@pytest.fixture(autouse=True)
def _cpu():
    repro_torch.set_device("cpu")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(a: np.ndarray) -> torch.Tensor:
    """A numpy array (bf16 ones included) as a tensor of its dtype."""
    return tcommon._leaf_tensor(np.asarray(a))


def _model(name: str, seed: int = 0, **kw):
    """The smoke config from both packages and the same JAX-drawn weights in
    each."""
    tcfg = tconfigs.get_smoke(name).with_(**kw)
    jcfg = jconfigs.get_smoke(name).with_(**kw)
    jp = jreg.init_params(jcfg, jax.random.PRNGKey(seed))
    flat = {p: np.asarray(v) for p, v in jcommon.flatten(jp).items()}
    return tcfg, jcfg, tcommon.params_from_numpy(treg.param_specs(tcfg), flat), jp


def _jit(fn, *args, **kw):
    """The reference's ``fn`` with its leading arguments bound, jitted: one
    compilation beats JAX's op-by-op dispatch on the CPU many times over."""
    return jax.jit(functools.partial(fn, *args, **kw))


def _layer0(tree):
    """Layer 0 of a stacked param tree, in numpy (for both packages)."""
    return {k: _layer0(v) if isinstance(v, dict) else np.asarray(v)[0] for k, v in tree.items()}


def _both(tree_np):
    """A numpy tree as (torch tree, jnp tree)."""
    flat = jcommon.flatten(tree_np)
    return (tcommon.unflatten({p: _t(v) for p, v in flat.items()}),
            jcommon.unflatten({p: jnp.asarray(v) for p, v in flat.items()}))


def _assert_trees(t_tree, j_tree, atol):
    t = {k: _np(v) for k, v in tcommon.flatten(t_tree).items()}
    j = {k: _np(v) for k, v in jcommon.flatten(j_tree).items()}
    assert t.keys() == j.keys()
    for key in t:
        np.testing.assert_allclose(t[key], j[key], atol=atol, rtol=0, err_msg=str(key))


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", [XLSTM, ZAMBA])
def test_recurrent_param_specs_are_the_references(name):
    tcfg, jcfg = tconfigs.get_config(name), jconfigs.get_config(name)
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


# ---------------------------------------------------------------------------
# the SSD primitive and the mixers
# ---------------------------------------------------------------------------


def _ssd_inputs(seed, b=2, L=37, H=4, P=8, G=2, N=6):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, L, H, P)).astype(np.float32)
    log_a = -rng.uniform(0.0, 2.0, size=(b, L, H)).astype(np.float32)
    B = rng.normal(size=(b, L, G, N)).astype(np.float32)
    C = rng.normal(size=(b, L, G, N)).astype(np.float32)
    h0 = rng.normal(size=(b, H, P, N)).astype(np.float32)
    return x, log_a, B, C, h0


@pytest.mark.parametrize("L,chunk,with_h0,normalize,G", [
    (37, 16, False, False, 2),    # off the chunk: identity-step padding
    (37, 16, True, True, 2),
    (5, 16, True, False, 4),      # shorter than one chunk
    (32, 8, False, True, 1),      # on the chunk, one group for every head
    (1, 16, True, True, 4),
])
def test_ssd_chunked_matches_reference(L, chunk, with_h0, normalize, G):
    x, log_a, B, C, h0 = _ssd_inputs(L + G, L=L, G=G)
    h0 = h0 if with_h0 else None
    ty, th = tssm.ssd_chunked(_t(x), _t(log_a), _t(B), _t(C), chunk=chunk,
                              h0=None if h0 is None else _t(h0), normalize=normalize)
    jy, jh = _jit(jssm.ssd_chunked, chunk=chunk, normalize=normalize)(
        jnp.asarray(x), jnp.asarray(log_a), jnp.asarray(B), jnp.asarray(C),
        h0=None if h0 is None else jnp.asarray(h0))
    assert ty.shape == (2, L, 4, 8) and th.dtype == torch.float32
    np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=ATOL_PRIM, rtol=0)
    np.testing.assert_allclose(_np(th), np.asarray(jh), atol=ATOL_PRIM, rtol=0)


def test_ssd_chunked_state_passes_the_padding_unchanged():
    """The final state of a length off the chunk is the state after its last
    real step: equal to running the steps one at a time."""
    x, log_a, B, C, h0 = _ssd_inputs(3, L=11)
    _, h = tssm.ssd_chunked(_t(x), _t(log_a), _t(B), _t(C), chunk=8, h0=_t(h0))
    hs = _t(h0)
    for t in range(11):
        hs, _ = tssm.ssd_decode_step(hs, _t(x[:, t]), _t(log_a[:, t]), _t(B[:, t]),
                                     _t(C[:, t]))
    np.testing.assert_allclose(_np(h), _np(hs), atol=ATOL_PRIM, rtol=0)


@pytest.mark.parametrize("G", [1, 4])
def test_ssd_decode_step_matches_reference(G):
    x, log_a, B, C, h0 = _ssd_inputs(7, L=1, G=G)
    th, ty = tssm.ssd_decode_step(_t(h0), _t(x[:, 0]), _t(log_a[:, 0]), _t(B[:, 0]),
                                  _t(C[:, 0]))
    jh, jy = jssm.ssd_decode_step(jnp.asarray(h0), jnp.asarray(x[:, 0]),
                                  jnp.asarray(log_a[:, 0]), jnp.asarray(B[:, 0]),
                                  jnp.asarray(C[:, 0]))
    np.testing.assert_allclose(_np(th), np.asarray(jh), atol=ATOL_PRIM, rtol=0)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=ATOL_PRIM, rtol=0)


_MIXERS = {
    "mamba2": (ZAMBA, "mamba_layers", tssm.mamba2_forward, tssm.mamba2_decode,
               jssm.mamba2_forward, jssm.mamba2_decode),
    "mlstm": (XLSTM, "m_layers", txlstm.mlstm_forward, txlstm.mlstm_decode,
              jxlstm.mlstm_forward, jxlstm.mlstm_decode),
    "slstm": (XLSTM, "s_layers", txlstm.slstm_forward, txlstm.slstm_decode,
              jxlstm.slstm_forward, jxlstm.slstm_decode),
}


@pytest.mark.parametrize("mixer", sorted(_MIXERS))
def test_mixer_matches_reference(mixer):
    """One mixer (layer 0 of the smoke config's weights, with non-zero
    biases and gates): a sequence of 20 from zero state with its final
    state, then 20 more from that state, then 3 decode steps; output and
    state to 1e-5 at every stage."""
    name, stack, tfwd, tdec, jfwd, jdec = _MIXERS[mixer]
    tcfg, jcfg = tconfigs.get_smoke(name), jconfigs.get_smoke(name)
    jp = jreg.init_params(jcfg, jax.random.PRNGKey(4))
    lp = _layer0(jp[stack])["mixer"]
    rng = np.random.default_rng(5)
    for key in ("conv_b", "dt_bias", "b_gates", "b"):
        if key in lp:
            lp[key] = rng.normal(scale=0.5, size=lp[key].shape).astype(np.float32)
    tp, jpl = _both(lp)
    x = rng.normal(size=(2, 43, tcfg.d_model)).astype(np.float32)
    jfwd, jdec = _jit(jfwd, cfg=jcfg, return_state=True), _jit(jdec, cfg=jcfg)
    ty, tst = tfwd(tp, _t(x[:, :20]), cfg=tcfg, return_state=True)
    jy, jst = jfwd(jpl, jnp.asarray(x[:, :20]))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=ATOL_PRIM, rtol=0)
    _assert_trees(tst, jst, ATOL_PRIM)
    ty, tst = tfwd(tp, _t(x[:, 20:40]), cfg=tcfg, state=tst, return_state=True)
    jy, jst = jfwd(jpl, jnp.asarray(x[:, 20:40]), state=jst)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=ATOL_PRIM, rtol=0)
    _assert_trees(tst, jst, ATOL_PRIM)
    for t in range(40, 43):
        tst, ty = tdec(tp, tst, _t(x[:, t:t + 1]), cfg=tcfg)
        jst, jy = jdec(jpl, jst, jnp.asarray(x[:, t:t + 1]))
        np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=ATOL_PRIM, rtol=0)
        _assert_trees(tst, jst, ATOL_PRIM)
    # the whole sequence at once ends where the pieces did
    whole = tfwd(tp, _t(x[:, :43]), cfg=tcfg)
    np.testing.assert_allclose(_np(whole)[:, -1], _np(ty)[:, 0], atol=ATOL_PRIM, rtol=0)


def test_short_mlstm_prefill_keeps_its_conv_history():
    """A 1- and a 2-token mLSTM prefill (``ssm_conv`` 4) keeps its conv
    inputs, zeros first, where the reference drops them (``None``); the
    decode step continues the sequence as the whole sequence does."""
    tcfg, jcfg = tconfigs.get_smoke(XLSTM), jconfigs.get_smoke(XLSTM)
    lp = _layer0(jreg.init_params(jcfg, jax.random.PRNGKey(6))["m_layers"])["mixer"]
    tp, jpl = _both(lp)
    x = np.random.default_rng(7).normal(size=(2, 3, tcfg.d_model)).astype(np.float32)
    jfwd = _jit(jxlstm.mlstm_forward, cfg=jcfg)
    for n in (1, 2):
        _, tst = txlstm.mlstm_forward(tp, _t(x[:, :n]), cfg=tcfg, return_state=True)
        _, jst = _jit(jxlstm.mlstm_forward, cfg=jcfg, return_state=True)(
            jpl, jnp.asarray(x[:, :n]))
        assert jst["conv"] is None and tuple(tst["conv"].shape) == (2, 3, 2 * tcfg.d_model)
        assert float(tst["conv"][:, :3 - n].abs().max()) == 0.0
        _, y = txlstm.mlstm_decode(tp, tst, _t(x[:, n:n + 1]), cfg=tcfg)
        whole = jfwd(jpl, jnp.asarray(x[:, :n + 1]))
        np.testing.assert_allclose(_np(y)[:, 0], np.asarray(whole)[:, -1], atol=ATOL_PRIM,
                                   rtol=0)


# ---------------------------------------------------------------------------
# forward, prefill and decode_step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar_len", "per_row_len"])
@pytest.mark.parametrize("impl", ["full", "chunked"])
@pytest.mark.parametrize("name", [XLSTM, ZAMBA])
def test_forward_prefill_decode_match_reference(name, impl, per_row):
    """[2, 24] tokens: forward logits, a prefill of 23 tokens with every
    cache entry, and the decode step of the 24th (``cache_len`` a scalar or
    a [B] vector), each to the reference's; the decode step equals the
    forward's last row."""
    tcfg, jcfg, tp, jp = _model(name, seed=1, attn_impl=impl)
    b, s = 2, 24
    toks = np.random.default_rng(2).integers(0, tcfg.vocab_size, (b, s)).astype(np.int32)
    tt = torch.from_numpy(toks).long()
    got, aux = treg.forward(tcfg, tp, tt)
    want, _ = _jit(jreg.forward, jcfg)(jp, jnp.asarray(toks))
    assert aux == {} and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL_MODEL, rtol=0)

    tcache, jcache = treg.init_cache(tcfg, b, s + 4), jreg.init_cache(jcfg, b, s + 4)
    tl, tcache = treg.prefill(tcfg, tp, tt[:, :s - 1], tcache)
    jl, jcache = _jit(jreg.prefill, jcfg)(jp, jnp.asarray(toks[:, :s - 1]), jcache)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL_MODEL, rtol=0)
    _assert_trees(tcache, jcache, ATOL_MODEL)

    lens = np.full(b, s - 1, np.int32) if per_row else s - 1
    td, tcache = treg.decode_step(tcfg, tp, tt[:, s - 1:], tcache,
                                  torch.from_numpy(lens) if per_row else lens)
    jd, jcache = _jit(jreg.decode_step, jcfg)(jp, jnp.asarray(toks[:, s - 1:]), jcache,
                                              jnp.asarray(lens, jnp.int32))
    np.testing.assert_allclose(_np(td), np.asarray(jd), atol=ATOL_MODEL, rtol=0)
    np.testing.assert_allclose(_np(td)[:, 0], _np(got)[:, s - 1], atol=ATOL_MODEL, rtol=0)
    _assert_trees(tcache, jcache, ATOL_MODEL)


# ---------------------------------------------------------------------------
# the engine: true-length prefill, the slot write, the oracle, paged decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 5, 16, 37])
@pytest.mark.parametrize("name", [XLSTM, ZAMBA])
def test_true_length_prefill_matches_teacher_forced(name, n):
    """A prompt of ``n`` tokens prefilled into slot 1 of a 3-slot runner,
    then two decode steps: the prefill's logits and both steps' equal the
    reference's teacher-forced ``forward`` over the prompt and the fed
    tokens (the reference's runner pads to bucket 16 or 64)."""
    tcfg, jcfg, tp, jp = _model(name, seed=8)
    rng = np.random.default_rng(9 + n)
    seq = rng.integers(1, tcfg.vocab_size, n + 2).astype(np.int32)
    want = np.asarray(_jit(jreg.forward, jcfg)(jp, jnp.asarray(seq[None]))[0])[0]
    runner = TRunner(tcfg, tp, max_slots=3, max_seq=64)
    got = [runner.prefill_into_slot(seq[:n], 1)]
    lens = np.asarray([5, n, 9], np.int32)
    for t in range(2):
        nxt = np.asarray([3, seq[n + t], 4], np.int32)
        got.append(runner.decode(nxt, lens)[1])
        lens = lens + 1
    np.testing.assert_allclose(np.stack(got), want[n - 1:n + 2], atol=ATOL_MODEL, rtol=0)


@pytest.mark.parametrize("name", [XLSTM, ZAMBA])
def test_reference_runner_pads_pad_tokens_into_the_state(name):
    """The fault the true-length prefill repairs, shown in the reference: its
    runner's first decode step after a 5-token prompt (bucket 16) is far
    from its own teacher-forced ``forward``, whose last logits its prefill
    still matches."""
    tcfg, jcfg, tp, jp = _model(name, seed=8)
    seq = np.random.default_rng(14).integers(1, tcfg.vocab_size, 6).astype(np.int32)
    want = np.asarray(_jit(jreg.forward, jcfg)(jp, jnp.asarray(seq[None]))[0])[0]
    runner = JRunner(jcfg, jp, max_slots=1, max_seq=64)
    first = runner.prefill_into_slot(seq[:5], 0)
    step = runner.decode(seq[5:6], np.asarray([5], np.int32))[0]
    np.testing.assert_allclose(first, want[4], atol=ATOL_MODEL, rtol=0)
    assert float(np.abs(step - want[5]).max()) > 0.1
    alone = TRunner(tcfg, tp, max_slots=1, max_seq=64)
    alone.prefill_into_slot(seq[:5], 0)
    np.testing.assert_allclose(alone.decode(seq[5:6], np.asarray([5], np.int32))[0],
                               want[5], atol=ATOL_MODEL, rtol=0)


@pytest.mark.parametrize("name", [XLSTM, ZAMBA])
def test_recurrent_slot_write_leaves_other_slots_bit_identical(name):
    """Prefilling slot 2 of a 4-slot runner writes that slot's row of every
    cache entry, leaves the other rows bit-identical, and decodes as the
    same request alone in a one-slot runner."""
    tcfg, _, tp, _ = _model(name, seed=10)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, tcfg.vocab_size, int(rng.integers(1, 30))).astype(np.int32)
               for _ in range(4)]
    runner = TRunner(tcfg, tp, max_slots=4, max_seq=48)
    assert set(runner.cache) == ({"m", "s"} if name == XLSTM else {"mamba", "tail", "attn"})
    for slot in (0, 1, 3):
        runner.prefill_into_slot(prompts[slot], slot)
    before = {k: v.clone() for k, v in tcommon.flatten(runner.cache).items()}
    first = runner.prefill_into_slot(prompts[2], 2)
    for key, v in tcommon.flatten(runner.cache).items():
        for other in (0, 1, 3):
            assert torch.equal(v[:, other], before[key][:, other]), (key, other)
        assert bool(v[:, 2].abs().sum() > 0), key
    alone = TRunner(tcfg, tp, max_slots=1, max_seq=48)
    np.testing.assert_allclose(first, alone.prefill_into_slot(prompts[2], 0), atol=1e-6)
    lens = np.asarray([len(p) for p in prompts], np.int32)
    for _ in range(4):
        nxt = rng.integers(1, tcfg.vocab_size, 4).astype(np.int32)
        np.testing.assert_allclose(runner.decode(nxt, lens)[2],
                                   alone.decode(nxt[2:3], lens[2:3])[0], atol=1e-5, rtol=0)
        lens = lens + 1


@pytest.mark.parametrize("name", [XLSTM, ZAMBA])
def test_engine_model_predicate_matches_reference(name):
    """``EngineModel.predicate`` over a recurrent oracle (the smoke config at
    the tokenizer's vocabulary): 32 prompts of 3..120 bytes (one batch),
    scores to 1e-4, decisions equal wherever the score is not a tie, and
    the same ``EngineStats``."""
    tcfg, jcfg, tp, jp = _model(name, seed=12, vocab_size=TOKENIZER.vocab_size)
    te, je = TEngine(tcfg, tp, max_seq=128), JEngine(jcfg, jp, max_seq=128)
    rng = np.random.default_rng(13)
    prompts = ["".join(chr(int(c)) for c in rng.integers(32, 127, int(rng.integers(3, 120))))
               for _ in range(32)]
    tb, ts = TEngineModel(te).predicate(prompts)
    jb, js = JEngineModel(je).predicate(prompts)
    np.testing.assert_allclose(ts, js, atol=ATOL_MODEL, rtol=0)
    margin = np.abs(np.asarray(js) - 0.5) > 1e-4
    assert margin.sum() >= 24
    np.testing.assert_array_equal(tb[margin], np.asarray(jb)[margin])
    assert vars(te.stats) == vars(je.stats)


def test_paged_decode_refuses_the_non_transformer_families():
    """Paged decode serves the transformer's dense and moe layouts; the
    audio, ssm and hybrid families are refused by name (``layer_layout``
    would call each of them dense)."""
    for name in ("whisper-small", XLSTM, ZAMBA):
        cfg = tconfigs.get_smoke(name)
        params = treg.init_params(cfg, torch.Generator().manual_seed(0))
        pages = tpaged.init_pages(cfg, 4, 4)
        with pytest.raises(ValueError, match=f"not the {cfg.family} family"):
            tpaged.paged_decode_step(cfg, params, np.zeros((1, 1)), pages,
                                     np.zeros((1, 4), np.int32), np.zeros(1))
