"""The port's MoE and VLM layouts of the transformer against ``repro``'s on
the CPU: ``forward`` (logits and the MoE aux losses), ``prefill`` and
``decode_step`` for the mixtral-8x22b (``moe``), llama4-maverick
(``moe_interleave``, with the shared expert) and llama-3.2-vision
(``vlm``) smoke configs under ``full`` and ``chunked`` attention; cross
attention alone; the engine with a per-request ``extra`` (the VLM's image
embeddings) through the runner and the continuous-batching scheduler; the
runner's slot write over every cache entry; and paged MoE decode.  JAX
draws the weights; they cross as ``flatten`` -> ``np.asarray`` ->
``params_from_numpy``.  The VLM's cross gates are zeros at init (tanh(0)
makes every cross block the identity), so the shared numpy weights set
them to 0.5 for the image path to count.

Tolerances: logits and caches through the smoke configs' 2-4 layers agree
to ``1e-4`` (f32 sums in another order), the aux losses to ``1e-5``, one
cross-attention layer to ``1e-5``.  Greedy tokens are identical to the
reference's up to the first step whose top-1/top-2 margin (in the
reference) is below ``1e-3``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro import common as jcommon
from repro import configs as jconfigs
from repro.engine import paged as jpaged
from repro.engine.runner import ModelRunner as JRunner
from repro.engine.scheduler import ContinuousBatchScheduler as JSched
from repro.engine.scheduler import Request as JRequest
from repro.models import attention as jattn
from repro.models import registry as jreg
from repro_torch import common as tcommon
from repro_torch import configs as tconfigs
from repro_torch.engine import paged as tpaged
from repro_torch.engine.runner import ModelRunner as TRunner
from repro_torch.engine.scheduler import ContinuousBatchScheduler as TSched
from repro_torch.engine.scheduler import Request as TRequest
from repro_torch.models import attention as tattn
from repro_torch.models import registry as treg

MIXTRAL, MAVERICK, VISION = "mixtral-8x22b", "llama4-maverick-400b-a17b", "llama-3.2-vision-11b"
ATOL_MODEL = 1e-4
ATOL_AUX = 1e-5
NEAR_TIE = 1e-3


@pytest.fixture(autouse=True)
def _cpu():
    repro_torch.set_device("cpu")


def _model(name: str, seed: int = 0, **kw):
    """The smoke config from both packages and the same JAX-drawn weights in
    each; the VLM's cross gates set to 0.5."""
    tcfg = tconfigs.get_smoke(name).with_(**kw)
    jcfg = jconfigs.get_smoke(name).with_(**kw)
    jp = jreg.init_params(jcfg, jax.random.PRNGKey(seed))
    flat = {p: np.asarray(v) for p, v in jcommon.flatten(jp).items()}
    for p in flat:
        if p[-1] in ("attn_gate", "ffn_gate"):
            flat[p] = np.full_like(flat[p], 0.5)
    jp = jcommon.unflatten({p: jnp.asarray(v) for p, v in flat.items()})
    return tcfg, jcfg, tcommon.params_from_numpy(treg.param_specs(tcfg), flat), jp


def _images(cfg, b: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(
        size=(b, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)


def _extras(cfg, b: int, seed: int):
    """(the port's extra, the reference's extra) for ``b`` rows, or Nones."""
    if cfg.family != "vlm":
        return None, None
    img = _images(cfg, b, seed)
    return {"image_embeds": torch.from_numpy(img)}, {"image_embeds": jnp.asarray(img)}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_caches(tcache, jcache, atol):
    t = {k: _np(v) for k, v in tcommon.flatten(tcache).items()}
    j = {k: _np(v) for k, v in jcommon.flatten(jcache).items()}
    assert t.keys() == j.keys()
    for key in t:
        np.testing.assert_allclose(t[key], j[key], atol=atol, rtol=0, err_msg=str(key))


# ---------------------------------------------------------------------------
# forward, prefill and decode_step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["full", "chunked"])
@pytest.mark.parametrize("name", [MIXTRAL, MAVERICK, VISION])
def test_forward_prefill_decode_match_reference(name, impl):
    """``tests/test_arch_smoke.py::test_forward_and_decode_consistency``
    held against the reference: [2, 24] tokens (MoE at
    ``capacity_factor=8``, so no choice drops and the decode step equals
    the forward's last row), forward logits and aux, a prefill of 23
    tokens with every cache entry, and the decode step of the 24th.  The
    default capacity (which drops) is held to the reference's too."""
    kw = dict(attn_impl=impl)
    tcfg, jcfg, tp, jp = _model(name, seed=1, **kw)
    if tcfg.is_moe:
        tcfg, jcfg = tcfg.with_(capacity_factor=8.0), jcfg.with_(capacity_factor=8.0)
    b, s = 2, 24
    toks = np.random.default_rng(2).integers(0, tcfg.vocab_size, (b, s)).astype(np.int32)
    t_extra, j_extra = _extras(tcfg, b, seed=3)
    tt = torch.from_numpy(toks).long()

    got, t_aux = treg.forward(tcfg, tp, tt, extra=t_extra)
    want, j_aux = jreg.forward(jcfg, jp, jnp.asarray(toks), extra=j_extra)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, s, tcfg.vocab_size)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL_MODEL, rtol=0)
    assert sorted(t_aux) == sorted(j_aux) == (["moe_lb", "moe_z"] if tcfg.is_moe else [])
    for key in j_aux:
        np.testing.assert_allclose(float(t_aux[key]), float(j_aux[key]), atol=ATOL_AUX, rtol=0)
    if tcfg.is_moe:   # the default capacity factor drops choices at 24 tokens
        d_got, _ = treg.forward(tcfg.with_(capacity_factor=1.0), tp, tt)
        d_want, _ = jreg.forward(jcfg.with_(capacity_factor=1.0), jp, jnp.asarray(toks))
        np.testing.assert_allclose(_np(d_got), np.asarray(d_want), atol=ATOL_MODEL, rtol=0)

    tcache, jcache = treg.init_cache(tcfg, b, s + 4), jreg.init_cache(jcfg, b, s + 4)
    tl, tcache = treg.prefill(tcfg, tp, tt[:, :s - 1], tcache, extra=t_extra)
    jl, jcache = jreg.prefill(jcfg, jp, jnp.asarray(toks[:, :s - 1]), jcache, extra=j_extra)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL_MODEL, rtol=0)
    np.testing.assert_allclose(_np(tl), _np(got)[:, :s - 1], atol=1e-3, rtol=0)
    _assert_caches(tcache, jcache, ATOL_MODEL)

    td, tcache = treg.decode_step(tcfg, tp, tt[:, s - 1:], tcache, s - 1, extra=t_extra)
    jd, jcache = jreg.decode_step(jcfg, jp, jnp.asarray(toks[:, s - 1:]), jcache,
                                  jnp.int32(s - 1), extra=j_extra)
    np.testing.assert_allclose(_np(td), np.asarray(jd), atol=ATOL_MODEL, rtol=0)
    np.testing.assert_allclose(_np(td)[:, 0], _np(got)[:, s - 1], atol=1e-3, rtol=0)
    _assert_caches(tcache, jcache, ATOL_MODEL)


def test_vlm_image_changes_the_logits_and_is_required():
    tcfg, _, tp, _ = _model(VISION)
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, 512, (1, 9)))
    a, _ = treg.forward(tcfg, tp, toks, extra={"image_embeds": torch.from_numpy(
        _images(tcfg, 1, seed=5))})
    b, _ = treg.forward(tcfg, tp, toks, extra={"image_embeds": torch.from_numpy(
        _images(tcfg, 1, seed=6))})
    assert float((a - b).abs().max()) > 1e-3
    with pytest.raises(ValueError, match="image_embeds"):
        treg.forward(tcfg, tp, toks)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_matches_reference(dtype):
    """One cross-attention layer (the VLM smoke's widths: d 64, 4/2 heads,
    no biases) over a sequence of 7 against 16 memory rows, and the decode
    form against the precomputed memory K/V, which equals the sequence
    form's first row: to 1e-5 in f32, to bf16's rounding in bf16."""
    tcfg, jcfg, tp, jp = _model(VISION, seed=7, dtype=dtype)
    tol = 1e-5 if dtype == "float32" else 2e-2
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tx = {k: v[0] for k, v in tp["cross_layers"]["xattn"].items()}
    jx = {k: v[0] for k, v in jp["cross_layers"]["xattn"].items()}
    assert "bq" not in tx and set(tx) == set(jx)
    rng = np.random.default_rng(8)
    xj = jnp.asarray(rng.normal(size=(2, 7, tcfg.d_model)), jdt)
    memj = jnp.asarray(rng.normal(size=(2, 16, tcfg.d_model)), jdt)
    x, mem = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt) for a in (xj, memj))
    got = tattn.cross_attention(tx, x, mem, cfg=tcfg)
    want = jattn.cross_attention(jx, xj, memj, cfg=jcfg)
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got.float()), np.asarray(want, np.float32), atol=tol,
                               rtol=tol)
    kj = jnp.einsum("bsd,dhk->bshk", memj, jx["wk"])
    vj = jnp.einsum("bsd,dhk->bshk", memj, jx["wv"])
    k, v = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt) for a in (kj, vj))
    got = tattn.decode_cross_attention(tx, x[:, :1], k, v, cfg=tcfg)
    want = jattn.decode_cross_attention(jx, xj[:, :1], kj, vj, cfg=jcfg)
    np.testing.assert_allclose(_np(got.float()), np.asarray(want, np.float32), atol=tol,
                               rtol=tol)
    seq = tattn.cross_attention(tx, x[:, :1], mem, cfg=tcfg)
    np.testing.assert_allclose(_np(got.float()), _np(seq.float()), atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# the engine: per-request extra, the slot write, paged MoE decode
# ---------------------------------------------------------------------------


def _requests(req_cls, cfg, n: int, with_extra: bool):
    rng = np.random.default_rng(9)
    out = []
    for i in range(n):
        toks = rng.integers(1, cfg.vocab_size, int(rng.integers(3, 30))).astype(np.int32)
        extra = {"image_embeds": _images(cfg, 1, seed=20 + i)} if with_extra else None
        out.append(req_cls(rid=i, tokens=toks, max_new_tokens=8, extra=extra))
    return out


def _log_softmax(z: np.ndarray) -> np.ndarray:
    z = z.astype(np.float64)
    m = z.max(-1, keepdims=True)
    return z - m - np.log(np.exp(z - m).sum(-1, keepdims=True))


def _teacher_forced(runner, req) -> np.ndarray:
    """Log-probs of each generated position of ``req`` fed back through
    slot 0 of ``runner``."""
    logits = [runner.prefill_into_slot(req.tokens, 0, req.extra)]
    lens = np.zeros(runner.max_slots, np.int32)
    lens[0] = len(req.tokens)
    nxt = np.zeros(runner.max_slots, np.int32)
    for tok in req.out_tokens[:-1]:
        nxt[0] = tok
        logits.append(runner.decode(nxt, lens)[0])
        lens = lens + 1
    return _log_softmax(np.stack(logits))


@pytest.mark.parametrize("name", [MIXTRAL, MAVERICK, VISION])
def test_scheduler_with_extra_matches_reference(name):
    """Five requests through three slots of both packages' scheduler (the
    VLM's each with its own image, passed as ``Request.extra``), 8 greedy
    tokens each: the port's tokens equal the reference's up to the first
    near-tie, and the reference's tokens teacher-forced through both
    runners give log-probs within 1e-4."""
    tcfg, jcfg, tp, jp = _model(name, seed=10)
    vlm = tcfg.family == "vlm"
    done = {}
    for key, runner, sched_cls, req_cls in (
            ("t", TRunner(tcfg, tp, max_slots=3, max_seq=64), TSched, TRequest),
            ("j", JRunner(jcfg, jp, max_slots=3, max_seq=64), JSched, JRequest)):
        sched = sched_cls(runner)
        for r in _requests(req_cls, tcfg, 5, vlm):
            if key == "j" and vlm:
                r.extra = {"image_embeds": jnp.asarray(r.extra["image_embeds"])}
            sched.submit(r)
        done[key] = sorted(sched.run_to_completion(), key=lambda r: r.rid)
    tfr = TRunner(tcfg, tp, max_slots=1, max_seq=64)
    jfr = JRunner(jcfg, jp, max_slots=1, max_seq=64)
    for tr, jr in zip(done["t"], done["j"]):
        assert tr.done and jr.done and not tr.failed and not jr.failed
        lp_j = _teacher_forced(jfr, jr)
        np.testing.assert_allclose(_teacher_forced(tfr, jr), lp_j, atol=ATOL_MODEL, rtol=0)
        top2 = np.sort(lp_j, -1)[:, -2:]
        ties = np.flatnonzero(top2[:, 1] - top2[:, 0] < NEAR_TIE)
        upto = int(ties[0]) + 1 if len(ties) else len(jr.out_tokens)
        assert tr.out_tokens[:upto] == jr.out_tokens[:upto], (tr.rid, upto)
    if vlm:   # the image counts: one prompt, two images, two first logits
        r0 = _requests(TRequest, tcfg, 1, True)[0]
        a = tfr.prefill_into_slot(r0.tokens, 0, r0.extra)
        b = tfr.prefill_into_slot(r0.tokens, 0, {"image_embeds": _images(tcfg, 1, seed=99)})
        assert float(np.abs(a - b).max()) > 1e-3


@pytest.mark.parametrize("name", [MAVERICK, VISION])
def test_prefill_into_slot_writes_every_cache_entry(name):
    """A request prefilled into slot 3 of a 4-slot runner writes its rows of
    every cache entry (``dense``/``moe`` for the interleaved MoE layout,
    ``self``/``cross`` for the VLM), leaves the other slots' rows as they
    were, and decodes as the same request alone in a one-slot runner."""
    tcfg, _, tp, _ = _model(name, seed=11)
    vlm = tcfg.family == "vlm"
    reqs = _requests(TRequest, tcfg, 4, vlm)
    runner = TRunner(tcfg, tp, max_slots=4, max_seq=48)
    assert set(runner.cache) == ({"self", "cross"} if vlm else {"dense", "moe"})
    for slot, r in enumerate(reqs[:3]):
        runner.prefill_into_slot(r.tokens, slot, r.extra)
    before = {k: v.clone() for k, v in tcommon.flatten(runner.cache).items()}
    first = runner.prefill_into_slot(reqs[3].tokens, 3, reqs[3].extra)
    for key, v in tcommon.flatten(runner.cache).items():
        assert torch.equal(v[:, :3], before[key][:, :3]), key
        assert bool(v[:, 3].abs().sum() > 0), key
    alone = TRunner(tcfg, tp, max_slots=1, max_seq=48)
    np.testing.assert_allclose(first, alone.prefill_into_slot(reqs[3].tokens, 0,
                                                              reqs[3].extra), atol=1e-6)
    lens = np.asarray([len(r.tokens) for r in reqs], np.int32)
    rng = np.random.default_rng(12)
    for _ in range(5):
        nxt = rng.integers(1, tcfg.vocab_size, 4).astype(np.int32)
        got = runner.decode(nxt, lens)[3]
        want = alone.decode(nxt[3:], lens[3:])[0]
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        lens = lens + 1


def test_paged_moe_decode_matches_contiguous_and_reference():
    """Paged decode of the mixtral smoke (8-position window, 4 experts, top
    2): against the reference's paged decode at every step (1e-4), and
    against the port's contiguous decode while every position is inside
    the window; the paged mask has no window (the reference's), so the two
    part once a row passes it."""
    tcfg, jcfg, tp, jp = _model(MIXTRAL, seed=13)
    assert tcfg.sliding_window == 8
    b, steps = 2, 12
    toks = np.random.default_rng(14).integers(0, tcfg.vocab_size, (b, steps)).astype(np.int32)
    cache = treg.init_cache(tcfg, b, 32)
    contiguous = []
    for t in range(steps):
        lg, cache = treg.decode_step(tcfg, tp, torch.from_numpy(toks[:, t:t + 1]).long(),
                                     cache, t)
        contiguous.append(_np(lg))
    paged = {}
    for key, mod, cfg, params in (("t", tpaged, tcfg, tp), ("j", jpaged, jcfg, jp)):
        alloc = mod.PageAllocator(num_pages=16, page_size=4, max_slots=b,
                                  max_pages_per_slot=8)
        pages = mod.init_pages(cfg, 16, 4)
        lens = np.zeros(b, np.int32)
        paged[key] = []
        for t in range(steps):
            for s in range(b):
                alloc.ensure(s, t + 1)
            args = (toks[:, t:t + 1], pages, alloc.table, lens)
            if key == "j":
                args = tuple(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args)
            lg, pages = mod.paged_decode_step(cfg, params, *args)
            paged[key].append(_np(lg))
            lens = lens + 1
    for t in range(steps):
        np.testing.assert_allclose(paged["t"][t], paged["j"][t], atol=ATOL_MODEL, rtol=0,
                                   err_msg=f"step {t}")
        if t < tcfg.sliding_window:
            np.testing.assert_allclose(paged["t"][t], contiguous[t], atol=ATOL_MODEL, rtol=0)
    assert float(np.abs(paged["t"][-1] - contiguous[-1]).max()) > 1e-3
