"""The port's scoring oracle against ``repro``'s on the CPU:
``InferenceEngine.predicate`` / ``compare`` / ``choose`` over the same
weights (drawn by JAX, crossed with ``params_from_numpy``), and
``sem_search``'s LLM rerank through ``EngineModel`` in both packages.

Tolerances: in f32 the last-token log-probs agree to ``1e-4`` and every
decision whose margin exceeds ``1e-3`` is identical; in bf16 (weights and
activations rounded at other points by the two frameworks) ``5e-2`` and a
margin of ``0.05``.  ``EngineStats`` must be identical."""
import dataclasses

import jax
import numpy as np
import pytest

import repro_torch
from repro import common as jcommon
from repro.configs import get_smoke as jget_smoke
from repro.core.backends import jax_engine
from repro.core.backends import synth as jsynth
from repro.core.operators import search as jsearch
from repro.engine.engine import InferenceEngine as JEngine
from repro.models import registry as jreg
from repro_torch import common as tcommon
from repro_torch.configs import get_smoke as tget_smoke
from repro_torch.core.backends import synth as tsynth
from repro_torch.core.backends import torch_engine
from repro_torch.core.operators import search as tsearch
from repro_torch.data.tokenizer import TOKENIZER
from repro_torch.engine.engine import InferenceEngine as TEngine
from repro_torch.models import registry as treg

TOLS = {"float32": (1e-4, 1e-3), "bfloat16": (5e-2, 0.05)}   # (atol, margin)


@pytest.fixture(autouse=True)
def _cpu():
    repro_torch.set_device("cpu")


def _engines(dtype: str, attn_impl: str = "pallas", seed: int = 0, max_seq: int = 256):
    kw = dict(vocab_size=TOKENIZER.vocab_size, dtype=dtype, attn_impl=attn_impl)
    tcfg = tget_smoke("llama3.2-3b").with_(**kw)
    jcfg = jget_smoke("llama3.2-3b").with_(**kw)
    jp = jreg.init_params(jcfg, jax.random.PRNGKey(seed))
    flat = {p: np.asarray(v) for p, v in jcommon.flatten(jp).items()}
    tp = tcommon.params_from_numpy(treg.param_specs(tcfg), flat)
    return TEngine(tcfg, tp, max_seq=max_seq), JEngine(jcfg, jp, max_seq=max_seq)


def _prompts(n: int, seed: int) -> list[str]:
    """Prompts of 3..300 bytes (some past max_seq, so truncated), over the
    byte range and a few multi-byte characters."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        m = int(rng.integers(3, 300))
        out.append("".join(chr(int(c)) for c in rng.integers(32, 127, m)) + "é" * (m % 3))
    return out


def _assert_same_where_clear(got, want, clear):
    clear = np.asarray(clear)
    assert clear.sum() >= 5            # the check is not vacuous
    np.testing.assert_array_equal(np.asarray(got)[clear], np.asarray(want)[clear])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attn_impl", ["pallas", "full"])
def test_predicate_compare_choose_match_reference(dtype, attn_impl):
    atol, margin = TOLS[dtype]
    te, je = _engines(dtype, attn_impl)
    prompts = _prompts(45, seed=len(dtype) + len(attn_impl))   # two batches: 32 + 13

    tlog, jlog = te._last_logits(prompts), je._last_logits(prompts)
    np.testing.assert_allclose(tlog, jlog, atol=atol, rtol=0)

    tb, ts = te.predicate(prompts)
    jb, js = je.predicate(prompts)
    assert tb.dtype == bool and ts.dtype == np.float32 and ts.shape == (45,)
    np.testing.assert_allclose(ts, js, atol=atol, rtol=0)
    lt, lf = jlog[:, TOKENIZER.true_id], jlog[:, TOKENIZER.false_id]
    _assert_same_where_clear(tb, jb, np.abs(lt - lf) > margin)

    la, lb = jlog[:, TOKENIZER.a_id], jlog[:, TOKENIZER.b_id]
    _assert_same_where_clear(te.compare(prompts), je.compare(prompts),
                             np.abs(la - lb) > margin)

    for n in (2, 4, 12):
        # options past 9 share the digit "9": exact ties in both packages,
        # broken to the first; the margin is between distinct labels
        ids = sorted({TOKENIZER.encode(str(min(i, 9)), bos=False)[0] for i in range(n)})
        top2 = np.sort(jlog[:, ids], axis=1)[:, -2:]
        _assert_same_where_clear(te.choose(prompts, n), je.choose(prompts, n),
                                 top2[:, 1] - top2[:, 0] > margin)

    assert dataclasses.asdict(te.stats) == dataclasses.asdict(je.stats)
    assert te.stats.lm_calls == 45 * 6     # _last_logits, predicate, compare, 3 x choose


def test_empty_prompt_lists_and_seeded_random_weights():
    cfg = tget_smoke("llama3.2-3b").with_(vocab_size=TOKENIZER.vocab_size)
    a, b = TEngine(cfg, seed=3), TEngine(cfg, seed=3)
    passes, scores = a.predicate([])
    assert passes.shape == scores.shape == (0,) and a.compare([]).shape == (0,)
    assert a.stats.lm_calls == 0
    prompts = _prompts(5, seed=1)
    np.testing.assert_array_equal(a.predicate(prompts)[1], b.predicate(prompts)[1])
    assert a.runner.device.type == "cpu"


@pytest.mark.parametrize("kind,kw", [("exact", {}),
                                     ("ivf", {"n_clusters": 8, "nprobe": 2})])
@pytest.mark.parametrize("k,n_rerank", [(8, 4), (6, 6), (5, 9)])
def test_sem_search_llm_rerank_matches_reference(kind, kw, k, n_rerank):
    """The paper's search-then-rerank: embedding top-k, then the LLM's
    quickselect over pairwise comparisons of the hits down to n_rerank."""
    te, je = _engines("float32")
    tout, jout = [], []
    for synth, search, model, out in (
            (tsynth, tsearch, torch_engine.EngineModel(te), tout),
            (jsynth, jsearch, jax_engine.EngineModel(je), jout)):
        recs, _, _, _, emb = synth.make_filter_world(150, seed=8)
        idx = search.sem_index([r["claim"] for r in recs], emb, index=kind, **kw)
        for qi in (3, 70):
            hits, st = search.sem_search(idx, recs[qi]["claim"], emb, k=k,
                                         n_rerank=n_rerank, rerank_model=model,
                                         records=recs, rerank_langex="{claim}")
            out.append((hits, {key: v for key, v in st.items() if key != "wall_s"}))
    assert tout == jout
    assert all(st["reranked"] == min(n_rerank, k) for _, st in tout)
    assert all(len(h) == min(n_rerank, k) for h, _ in tout)
    assert dataclasses.asdict(te.stats) == dataclasses.asdict(je.stats)
    assert te.stats.lm_calls > 0
