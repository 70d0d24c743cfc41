"""The port's generate path against ``repro``'s on the CPU: the decode step
against a KV cache, ``prefill`` / ``decode_step``, the model runner's slot
cache, the continuous-batching scheduler and ``InferenceEngine.generate``,
the paged cache, the sampler, and the operators that generate
(``sem_map``, ``sem_map_fused``, ``sem_extract``, ``sem_agg_*``).  JAX
draws the weights; they cross as ``flatten`` -> ``np.asarray`` ->
``params_from_numpy``.  The mirror of every test of ``tests/test_engine.py``
is here too, on the port's classes.

Tolerances: the decode step's output and caches agree to ``1e-5`` (one
layer, f32); logits through 3 layers to ``1e-4`` (f32 sums in another
order).  Greedy generations of two frameworks can part at a near-tie of
the top two logits, after which the sequences differ: so the reference's
tokens are teacher-forced through both packages and their log-probs held
to ``1e-4`` at every step, and the port's own greedy tokens must equal the
reference's up to the first step whose top-1/top-2 margin (in the
reference) is below ``1e-3``.  The semantic operators over the simulated
backend must match exactly: outputs and accounting."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro import common as jcommon
from repro.configs import get_smoke as jget_smoke
from repro.core.backends import jax_engine
from repro.core.backends import synth as jsynth
from repro.core.backends.base import CountedModel as JCounted
from repro.core.operators import agg as jagg
from repro.core.operators import mapex as jmapex
from repro.engine import paged as jpaged
from repro.engine import sampler as jsampler
from repro.engine.engine import InferenceEngine as JEngine
from repro.engine.runner import ModelRunner as JRunner
from repro.engine.runner import _bucket as jbucket
from repro.engine.scheduler import ContinuousBatchScheduler as JSched
from repro.engine.scheduler import Request as JRequest
from repro.models import attention as jattn
from repro.models import registry as jreg
from repro_torch import common as tcommon
from repro_torch.configs import get_smoke as tget_smoke
from repro_torch.core.backends import synth as tsynth
from repro_torch.core.backends import torch_engine
from repro_torch.core.backends.base import CountedModel as TCounted
from repro_torch.core.operators import agg as tagg
from repro_torch.core.operators import mapex as tmapex
from repro_torch.data.tokenizer import TOKENIZER
from repro_torch.engine import paged as tpaged
from repro_torch.engine import sampler as tsampler
from repro_torch.engine.engine import InferenceEngine as TEngine
from repro_torch.engine.runner import ModelRunner as TRunner
from repro_torch.engine.runner import _bucket as tbucket
from repro_torch.engine.scheduler import ContinuousBatchScheduler as TSched
from repro_torch.engine.scheduler import Request as TRequest
from repro_torch.kernels._build import KernelError
from repro_torch.models import attention as tattn
from repro_torch.models import registry as treg

ATOL_LAYER = 1e-5     # one decode-attention layer, f32
ATOL_MODEL = 1e-4     # logits / log-probs through 3 layers, f32
NEAR_TIE = 1e-3       # top-1 minus top-2 logit below which greedy may part


@pytest.fixture(autouse=True)
def _cpu():
    repro_torch.set_device("cpu")


def _cfgs(**kw):
    kw = dict(vocab_size=TOKENIZER.vocab_size, **kw)
    return tget_smoke("llama3.2-3b").with_(**kw), jget_smoke("llama3.2-3b").with_(**kw)


def _cross(tspecs, jtree):
    """The JAX-drawn ``jtree`` as the port's params over ``tspecs``."""
    flat = {p: np.asarray(v) for p, v in jcommon.flatten(jtree).items()}
    return tcommon.params_from_numpy(tspecs, flat)


def _model(seed: int = 0, **kw):
    tcfg, jcfg = _cfgs(**kw)
    jp = jreg.init_params(jcfg, jax.random.PRNGKey(seed))
    return tcfg, jcfg, _cross(treg.param_specs(tcfg), jp), jp


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cache_np(cache):
    return {k: _np(v) for k, v in jcommon.flatten(cache).items()}


def _assert_caches(tcache, jcache, atol):
    t, j = _cache_np(tcache), _cache_np(jcache)
    assert t.keys() == j.keys()
    for key in t:
        np.testing.assert_allclose(t[key], j[key], atol=atol, rtol=0, err_msg=str(key))


def _prompts(n: int, seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    return ["".join(chr(int(c)) for c in rng.integers(32, 127, int(rng.integers(3, 60))))
            for _ in range(n)]


# ---------------------------------------------------------------------------
# the decode step, prefill and decode_step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("cache_len", [9, "vector"])
def test_decode_self_attention_matches_reference(window, cache_len):
    """One layer's decode step against a filled cache: the output and the
    caches after the write.  The vector holds 0, Smax - 1 and Smax (whose
    write is dropped, as the reference's ``mode="drop"``)."""
    tcfg, jcfg = _cfgs(sliding_window=window)
    jp = jcommon.init_params(jattn.attention_spec(jcfg), jax.random.PRNGKey(3))
    tp = _cross(tattn.attention_spec(tcfg), jp)
    b, smax = 4, 24
    rng = np.random.default_rng(window + 1)
    x = rng.normal(size=(b, 1, tcfg.d_model)).astype(np.float32)
    kc, vc = (rng.normal(size=(b, smax, tcfg.num_kv_heads, tcfg.hd)).astype(np.float32)
              for _ in range(2))
    if cache_len == "vector":
        lens = np.asarray([0, smax - 1, smax, 13], np.int32)
        tl, jl = torch.from_numpy(lens), jnp.asarray(lens)
    else:
        tl, jl = cache_len, cache_len
    tout, tk, tv = tattn.decode_self_attention(tp, torch.from_numpy(x), torch.tensor(kc),
                                               torch.tensor(vc), tl, cfg=tcfg)
    jout, jk, jv = jattn.decode_self_attention(jp, jnp.asarray(x), jnp.asarray(kc),
                                               jnp.asarray(vc), jl, cfg=jcfg)
    np.testing.assert_allclose(_np(tout), np.asarray(jout), atol=ATOL_LAYER, rtol=0)
    np.testing.assert_allclose(_np(tk), np.asarray(jk), atol=ATOL_LAYER, rtol=0)
    np.testing.assert_allclose(_np(tv), np.asarray(jv), atol=ATOL_LAYER, rtol=0)
    if cache_len == "vector":
        np.testing.assert_array_equal(_np(tk)[2], kc[2])     # the dropped write


def test_decode_self_attention_refuses_context_parallel_decode():
    tcfg, _ = _cfgs(decode_cp=True)
    tp = tcommon.init_params(tattn.attention_spec(tcfg), torch.Generator().manual_seed(0))
    z = torch.zeros(1, 4, tcfg.num_kv_heads, tcfg.hd)
    with pytest.raises(NotImplementedError, match="decode_cp"):
        tattn.decode_self_attention(tp, torch.zeros(1, 1, tcfg.d_model), z, z.clone(), 0,
                                    cfg=tcfg)


@pytest.mark.parametrize("window", [0, 8])
def test_prefill_and_decode_steps_match_reference(window):
    """prefill over a [2, 10] batch, then 12 decode steps teacher-forced
    with random tokens: the logits of every step and the caches."""
    tcfg, jcfg, tp, jp = _model(seed=1, sliding_window=window)
    rng = np.random.default_rng(2)
    b, t0, smax = 2, 10, 32
    toks = rng.integers(0, 256, (b, t0 + 12)).astype(np.int32)
    tcache = treg.init_cache(tcfg, b, smax)
    jcache = jreg.init_cache(jcfg, b, smax)
    assert set(tcommon.flatten(tcache)) == set(jcommon.flatten(jcache))
    tl, tcache = treg.prefill(tcfg, tp, torch.from_numpy(toks[:, :t0]).long(), tcache)
    jl, jcache = jreg.prefill(jcfg, jp, jnp.asarray(toks[:, :t0]), jcache)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL_MODEL, rtol=0)
    _assert_caches(tcache, jcache, ATOL_MODEL)
    last, _ = treg.prefill(tcfg, tp, torch.from_numpy(toks[:, :t0]).long(),
                           treg.init_cache(tcfg, b, smax), last_only=True)
    np.testing.assert_allclose(_np(last), _np(tl)[:, -1:], atol=1e-6, rtol=0)
    for i in range(12):
        t = t0 + i
        tl, tcache = treg.decode_step(tcfg, tp, torch.from_numpy(toks[:, t:t + 1]).long(),
                                      tcache, t)
        jl, jcache = jreg.decode_step(jcfg, jp, jnp.asarray(toks[:, t:t + 1]), jcache,
                                      jnp.int32(t))
        assert tuple(tl.shape) == (b, 1, tcfg.vocab_size)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL_MODEL, rtol=0,
                                   err_msg=f"step {i}")
    _assert_caches(tcache, jcache, ATOL_MODEL)


def test_runner_slots_match_reference_runner():
    """``prefill_into_slot`` into slots out of order (over a slot that held
    an earlier, longer prompt) and per-slot ``decode`` lengths: logits and
    the whole slot cache, against the reference's runner."""
    tcfg, jcfg, tp, jp = _model(seed=4)
    assert [tbucket(n) for n in range(300)] == [jbucket(n) for n in range(300)]
    tr = TRunner(tcfg, tp, max_slots=3, max_seq=64)
    jr = JRunner(jcfg, jp, max_slots=3, max_seq=64)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (40, 5, 17, 23)]
    for slot, p in zip((0, 2, 1, 0), prompts):
        np.testing.assert_allclose(tr.prefill_into_slot(p, slot),
                                   jr.prefill_into_slot(p, slot),
                                   atol=ATOL_MODEL, rtol=0)
    lens = np.asarray([23, 17, 5], np.int32)
    for _ in range(6):
        nxt = rng.integers(0, 256, 3).astype(np.int32)
        np.testing.assert_allclose(tr.decode(nxt, lens), jr.decode(nxt, lens.copy()),
                                   atol=ATOL_MODEL, rtol=0)
        lens = lens + 1
    _assert_caches(tr.cache, jr.cache, ATOL_MODEL)


# ---------------------------------------------------------------------------
# generate: the scheduler and the engine
# ---------------------------------------------------------------------------


def _schedule(sched_cls, req_cls, runner, prompts, max_new, **kw):
    """What ``InferenceEngine.generate`` submits, through the scheduler."""
    sched = sched_cls(runner, **kw)
    for i, p in enumerate(prompts):
        toks = np.asarray(TOKENIZER.encode(p)[: runner.max_seq - max_new - 1], np.int32)
        sched.submit(req_cls(rid=i, tokens=toks, max_new_tokens=max_new,
                             stop_id=TOKENIZER.eos_id))
    done = {r.rid: r for r in sched.run_to_completion()}
    return sched, [done[i] for i in range(len(prompts))]


def _teacher_forced(runner, prompt: np.ndarray, out: list[int]) -> np.ndarray:
    """Log-probs [len(out), V] of each generated position when ``out`` is
    fed back, through ``prefill_into_slot`` and ``decode`` of slot 0."""
    logits = [runner.prefill_into_slot(prompt, 0)]
    lens = np.zeros(runner.max_slots, np.int32)
    lens[0] = len(prompt)
    nxt = np.zeros(runner.max_slots, np.int32)
    for tok in out[:-1]:
        nxt[0] = tok
        logits.append(runner.decode(nxt, lens)[0])
        lens = lens + 1
    z = np.stack(logits).astype(np.float64)
    return z - np.log(np.exp(z - z.max(-1, keepdims=True)).sum(-1, keepdims=True)) \
        - z.max(-1, keepdims=True)


def test_generate_greedy_matches_reference_up_to_near_ties():
    """Five prompts through three slots (so slots are reused), 12 greedy
    tokens each.  The reference's tokens, teacher-forced through both
    runners, give log-probs within 1e-4 at every step; the port's own
    tokens equal the reference's up to the first near-tie; where every
    token is equal, so are the texts, ``EngineStats`` and the scheduler's
    step counts."""
    tcfg, jcfg, tp, jp = _model(seed=6)
    te = TEngine(tcfg, tp, max_slots=3, max_seq=128)
    je = JEngine(jcfg, jp, max_slots=3, max_seq=128)
    prompts = _prompts(5, seed=7)
    n = 12
    js, jdone = _schedule(JSched, JRequest, je.runner, prompts, n)
    ts, tdone = _schedule(TSched, TRequest, te.runner, prompts, n)
    tfr = TRunner(tcfg, tp, max_slots=1, max_seq=128)
    jfr = JRunner(jcfg, jp, max_slots=1, max_seq=128)
    all_same = True
    for jr, tr in zip(jdone, tdone):
        assert jr.done and tr.done and not jr.failed and not tr.failed
        lp_t = _teacher_forced(tfr, jr.tokens, jr.out_tokens)
        lp_j = _teacher_forced(jfr, jr.tokens, jr.out_tokens)
        np.testing.assert_allclose(lp_t, lp_j, atol=ATOL_MODEL, rtol=0)
        assert (np.argmax(lp_j, -1) == jr.out_tokens).all()   # greedy along its own path
        top2 = np.sort(lp_j, -1)[:, -2:]
        ties = np.flatnonzero(top2[:, 1] - top2[:, 0] < NEAR_TIE)
        upto = int(ties[0]) if len(ties) else len(jr.out_tokens)
        assert tr.out_tokens[:upto] == jr.out_tokens[:upto]
        all_same &= tr.out_tokens == jr.out_tokens
    if all_same:
        assert (ts.prefill_steps, ts.decode_steps) == (js.prefill_steps, js.decode_steps)
        assert te.generate(prompts, max_new_tokens=n) == je.generate(prompts, max_new_tokens=n)
        assert dataclasses.asdict(te.stats) == dataclasses.asdict(je.stats)


def test_kernel_error_propagates_out_of_generate():
    """The scheduler re-queues a request on ``RuntimeError`` and in the end
    returns ``""`` for it; a ``KernelError`` (a kernel that failed to
    build or launch) is not one, so it ends ``generate`` instead."""
    assert not issubclass(KernelError, RuntimeError)
    tcfg, _, tp, _ = _model()
    te = TEngine(tcfg, tp, max_slots=2, max_seq=64)

    def broken(*_a, **_k):
        raise KernelError("decode_attention kernel: CUDA error 1 (invalid argument)")

    te.runner.decode = broken
    with pytest.raises(KernelError):
        te.generate(["abc", "de"], max_new_tokens=4)

    def lost(*_a, **_k):
        raise RuntimeError("worker lost")

    te.runner.decode = lost
    assert te.generate(["abc", "de"], max_new_tokens=4) == ["", ""]


@pytest.mark.parametrize("step", ["prefill", "decode_step"])
@pytest.mark.parametrize("make_err", [
    lambda: RuntimeError("CUDA error: an illegal memory access was encountered"),
    lambda: torch.AcceleratorError("CUDA error: an illegal memory access was encountered"),
], ids=["cuda_error_message", "accelerator_error"])
def test_device_fault_inside_a_step_propagates_out_of_generate(monkeypatch, step, make_err):
    """A kernel that faults while it runs shows up as torch's own
    ``RuntimeError`` at the step's copy to the host, not at its launch.
    The runner re-raises it as ``KernelError``, so the scheduler's fault
    path neither re-queues it nor turns it into ``""``."""
    from repro_torch.engine import runner as trunner
    tcfg, _, tp, _ = _model()
    te = TEngine(tcfg, tp, max_slots=2, max_seq=64)
    real, calls = getattr(trunner.registry, step), []

    def faulty(*a, **k):
        calls.append(1)
        real(*a, **k)
        raise make_err()

    monkeypatch.setattr(trunner.registry, step, faulty)
    with pytest.raises(KernelError, match="illegal memory access") as info:
        te.generate(["abc", "de"], max_new_tokens=4)
    assert isinstance(info.value.__cause__, RuntimeError)
    assert len(calls) == 1      # raised at once, never retried


def test_build_failures_raise_kernel_error(monkeypatch, tmp_path):
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(KernelError, match="nvcc not found"):
        _build.nvcc()


def test_sem_map_through_engine_model_bills_as_reference():
    """``sem_map`` and ``sem_agg_hierarchical`` through ``EngineModel`` on
    the smoke engines: the bills (accounting details), the call and prompt
    counts are identical; the texts wherever the greedy tokens are."""
    tcfg, jcfg, tp, jp = _model(seed=8)
    te = TEngine(tcfg, tp, max_slots=4, max_seq=256)
    je = JEngine(jcfg, jp, max_slots=4, max_seq=256)
    recs, *_ = jsynth.make_topic_world(6, 2, seed=3)
    out = {}
    for key, eng, counted, mapex, agg, em in (
            ("t", te, TCounted, tmapex, tagg, torch_engine.EngineModel),
            ("j", je, JCounted, jmapex, jagg, jax_engine.EngineModel)):
        model = counted(em(eng, max_new_tokens=6), "oracle")
        texts, st = mapex.sem_map(recs, "a short note on {paper}", model)
        summary, st2 = agg.sem_agg_hierarchical(recs, "summarize {paper}", model, fanout=4)
        out[key] = (texts, summary, [{k: v for k, v in s.items() if k != "wall_s"}
                                     for s in (st, st2)], dataclasses.asdict(eng.stats))
    (tt, tsum, tbill, tstats), (jt, jsum, jbill, jstats) = out["t"], out["j"]
    assert tbill == jbill and tbill[0]["generate_calls"] == 6
    assert len(tt) == len(jt) == 6 and all(isinstance(t, str) for t in tt)
    assert (tstats["lm_calls"], tstats["prompt_tokens"]) == \
        (jstats["lm_calls"], jstats["prompt_tokens"])
    if tt == jt and tsum == jsum:
        assert tstats == jstats


# ---------------------------------------------------------------------------
# the mirror of tests/test_engine.py, on the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_engine():
    repro_torch.set_device("cpu")
    cfg = tget_smoke("llama3.2-3b").with_(vocab_size=TOKENIZER.vocab_size)
    return TEngine(cfg, max_slots=3, max_seq=128)


def _seq_generate(cfg, params, prompt_tokens, n, max_seq=128):
    r = TRunner(cfg, params, max_slots=1, max_seq=max_seq)
    logits = r.prefill_into_slot(prompt_tokens, 0)
    out = [int(np.argmax(logits))]
    lens = np.asarray([len(prompt_tokens)], np.int32)
    for _ in range(n - 1):
        logits = r.decode(np.asarray([out[-1]], np.int32), lens)
        out.append(int(np.argmax(logits[0])))
        lens = lens + 1
    return out


def test_continuous_batching_matches_sequential(small_engine):
    eng = small_engine
    prompts = [f"request number {i} about topic {i % 3}" for i in range(5)]
    refs = []
    for p in prompts:
        toks = np.asarray(TOKENIZER.encode(p), np.int32)
        refs.append(_seq_generate(eng.cfg, eng.runner.params, toks, 6))
    sched = TSched(eng.runner)
    for i, p in enumerate(prompts):
        sched.submit(TRequest(rid=i, tokens=np.asarray(TOKENIZER.encode(p), np.int32),
                              max_new_tokens=6))
    done = {r.rid: r.out_tokens for r in sched.run_to_completion()}
    for i in range(5):
        assert done[i][:6] == refs[i][:6], f"request {i} diverged"


def test_scheduler_fault_injection_requeues(small_engine):
    eng = small_engine
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] in (2, 5):     # two injected worker failures
            raise RuntimeError("injected worker fault")

    sched = TSched(eng.runner, fault_hook=flaky, max_retries=3)
    for i in range(4):
        sched.submit(TRequest(rid=i, tokens=np.asarray(TOKENIZER.encode(f"p{i}"), np.int32),
                              max_new_tokens=4))
    done = sched.run_to_completion()
    assert len(done) == 4
    assert all(r.done and not r.failed for r in done)
    assert any(r.retries > 0 for r in done)  # at least one recovered


def test_predicate_and_compare_shapes(small_engine):
    eng = small_engine
    passed, score = eng.predicate(["is water wet?"] * 4)
    assert passed.shape == (4,) and score.shape == (4,)
    assert np.all((score >= 0) & (score <= 1))
    pref = eng.compare(["A or B?"] * 3)
    assert pref.shape == (3,)


def test_paged_decode_matches_contiguous_and_reference():
    """The port's paged decode against its contiguous decode (1e-4), and
    against the reference's paged decode on the same weights (1e-4)."""
    tcfg, jcfg, tp, jp = _model(seed=1)
    B, T = 2, 12
    toks = np.random.default_rng(0).integers(0, 256, (B, T)).astype(np.int32)
    cache = treg.init_cache(tcfg, B, 32)
    for t in range(T):
        logits_ref, cache = treg.decode_step(tcfg, tp, torch.from_numpy(toks[:, t:t + 1]).long(),
                                             cache, t)
    paged = {}
    for key, mod in (("t", tpaged), ("j", jpaged)):
        alloc = mod.PageAllocator(num_pages=16, page_size=4, max_slots=B,
                                  max_pages_per_slot=8)
        pages = mod.init_pages(tcfg if key == "t" else jcfg, 16, 4)
        lens = np.zeros(B, np.int32)
        for t in range(T):
            for s in range(B):
                alloc.ensure(s, t + 1)
            if key == "t":
                logits, pages = mod.paged_decode_step(tcfg, tp, toks[:, t:t + 1], pages,
                                                      alloc.table, lens)
            else:
                logits, pages = mod.paged_decode_step(jcfg, jp, jnp.asarray(toks[:, t:t + 1]),
                                                      pages, jnp.asarray(alloc.table),
                                                      jnp.asarray(lens))
            lens = lens + 1
        paged[key] = _np(logits)
    np.testing.assert_allclose(paged["t"], _np(logits_ref), atol=1e-4)
    np.testing.assert_allclose(paged["t"], paged["j"], atol=ATOL_MODEL, rtol=0)


def test_paged_decode_refuses_moe():
    """Paged decode serves the layouts with one ``self`` cache (dense and
    moe, as the reference's assert allows; ``tests/test_torch_families.py``
    holds the moe one to the reference); the interleaved MoE layout and the
    VLM are refused."""
    for name in ("llama4-maverick-400b-a17b", "llama-3.2-vision-11b"):
        cfg = tget_smoke(name)
        params = treg.init_params(cfg, torch.Generator().manual_seed(0))
        pages = tpaged.init_pages(cfg, 4, 4)
        with pytest.raises(ValueError, match="dense and moe layouts"):
            tpaged.paged_decode_step(cfg, params, np.zeros((1, 1)), pages,
                                     np.zeros((1, 4), np.int32), np.zeros(1))


def test_page_allocator_release_reuse():
    alloc = tpaged.PageAllocator(num_pages=4, page_size=8, max_slots=2,
                                 max_pages_per_slot=4)
    alloc.ensure(0, 30)      # 4 pages
    with pytest.raises(MemoryError):
        alloc.ensure(1, 1)
    alloc.release(0)
    alloc.ensure(1, 8)       # reuse freed pages
    assert len(alloc.free) == 3


def test_sampler_modes():
    logits = np.asarray([[0.0, 5.0, 1.0]])
    assert tsampler.Sampler(temperature=0.0)(logits)[0] == 1
    s = tsampler.Sampler(temperature=1.0, top_k=2, seed=0)
    draws = {int(s(logits)[0]) for _ in range(20)}
    assert draws <= {1, 2}  # top-2 only


def test_sampler_draws_the_references_tokens():
    """The same logits and seed give the same tokens in both packages, at
    ``temperature=1.0, top_k=2`` and greedy."""
    logits = np.random.default_rng(9).normal(size=(6, 384)) * 3
    for kw in (dict(temperature=1.0, top_k=2, seed=5), dict(temperature=0.7, seed=1),
               dict(temperature=0.0)):
        ts, js = tsampler.Sampler(**kw), jsampler.Sampler(**kw)
        for _ in range(5):
            np.testing.assert_array_equal(ts(logits), js(logits))
    np.testing.assert_array_equal(tsampler.logprobs_of(logits, [3, 7]),
                                  jsampler.logprobs_of(logits, [3, 7]))


# ---------------------------------------------------------------------------
# the generating operators over the simulated backend
# ---------------------------------------------------------------------------


def _strip(st: dict) -> dict:
    return {k: v for k, v in st.items() if k != "wall_s"}


@pytest.mark.parametrize("fanout", [2, 8])
def test_mapex_and_agg_operators_match_reference(fanout):
    """Outputs and accounting details of ``sem_map``, ``sem_map_fused``,
    ``sem_extract``, ``sem_agg_hierarchical`` (with and without a
    partitioner) and ``sem_agg_fold``, each package over its own
    simulated world from one seed."""
    got = {}
    for key, synth, counted, mapex, agg in (("t", tsynth, TCounted, tmapex, tagg),
                                            ("j", jsynth, JCounted, jmapex, jagg)):
        recs, _, model, _ = synth.make_topic_world(40, 3, seed=10)
        model = counted(model, "oracle")
        runs = [mapex.sem_map(recs, "a short note on {paper}", model),
                mapex.sem_map_fused(recs, ["classify {paper}", "a title for {paper}"], model),
                mapex.sem_extract(recs, "find the paper id in {paper}", model,
                                  source_field="paper"),
                agg.sem_agg_hierarchical(recs, "summarize {paper}", model, fanout=fanout),
                agg.sem_agg_hierarchical(recs, "the category label of {paper}", model,
                                         fanout=fanout,
                                         partitioner=lambda xs: [xs[::2], xs[1::2]]),
                agg.sem_agg_fold(recs[:7], "summarize {paper}", model)]
        got[key] = [(out, _strip(st)) for out, st in runs]
    assert got["t"] == got["j"]
    assert got["t"][0][1]["generate_calls"] == 40
    assert got["t"][5][1]["generate_calls"] == 6
