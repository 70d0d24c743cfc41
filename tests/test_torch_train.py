"""The port's training substrate (``repro_torch.train``) against ``repro``'s
on the CPU: the six cases of ``test_train.py`` rewired to the port, then
parity with the reference on shared inputs: the schedule, clipping, AdamW
(f32 and bf16 state, with and without master weights), the int8 payloads,
``loss_fn``'s value and gradients (one and two microbatches; remat on equal
to remat off) and a 5-step ``loop.run`` trajectory.  Weights cross as numpy
arrays (``common.params_from_numpy``).

Tolerances:
- the schedule and the bias corrections: ``rtol=1e-6`` (f32 ``cos`` and
  ``pow`` of two libraries);
- AdamW: f32 leaves ``rtol=1e-5, atol=1e-7`` (the global norm is summed in
  another order, so the clip scale may differ in its last bit); bf16 state
  within one bf16 unit in the last place of its magnitude (``rtol=2**-7``);
- int8 compression: payloads, scales, error buffers and dequantized grads
  bit for bit (IEEE division, round half to even in both);
- ``loss_fn`` with f32 params: loss ``rtol=1e-5``, each gradient leaf within
  ``1e-5`` of its largest magnitude (f32 sums in another order through 3
  layers: 9.5e-7 measured); with the config's bf16 params (bf16 gradients)
  within one bf16 unit (2**-8) of the leaf's largest magnitude (9.8e-4
  measured);
- remat on and off: identical gradients (the same ops run again);
- the 5-step trajectory: losses ``rtol=1e-4``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro import common as jcommon
from repro import configs as jconfigs
from repro.checkpoint import checkpoint as jckpt
from repro.models import registry as jreg
from repro.train import grad_compress as jgc
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro.train import trainstep as jts
from repro_torch import common as tcommon
from repro_torch import configs as tconfigs
from repro_torch.data.tokenizer import TOKENIZER
from repro_torch.models import registry as treg
from repro_torch.train import grad_compress, optimizer as opt
from repro_torch.train import trainstep as tts
from repro_torch.train.loop import LoopConfig, run


@pytest.fixture(autouse=True)
def _cpu():
    repro_torch.set_device("cpu")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(jnp.asarray(x, jnp.float32) if jnp.asarray(x).dtype == jnp.bfloat16
                      else x)


# ---------------------------------------------------------------------------
# the six cases of test_train.py, on the port
# ---------------------------------------------------------------------------


def test_adamw_matches_reference_math():
    cfg = opt.OptimizerConfig(learning_rate=0.1, warmup_steps=0, total_steps=10,
                              weight_decay=0.0, clip_norm=1e9, min_lr_ratio=1.0)
    params = {"w": torch.tensor([1.0, -2.0])}
    w0 = params["w"].clone()
    state = opt.init_state(params, cfg)
    g = {"w": torch.tensor([0.5, -0.1])}
    p2, s2, m = opt.apply_updates(cfg, params, state, g)
    # step 1: mhat = g, vhat = g^2 -> delta = g / (|g| + eps)
    want = w0 - 0.1 * torch.sign(g["w"]) * (g["w"].abs() / (g["w"].abs() + cfg.eps))
    np.testing.assert_allclose(p2["w"].numpy(), want.numpy(), rtol=1e-5)


def test_grad_clip():
    g = {"a": torch.full((10,), 10.0)}
    clipped, norm = opt.clip_by_global_norm(g, 1.0)
    assert float(norm) > 1.0
    np.testing.assert_allclose(float(opt.global_norm(clipped)), 1.0, rtol=1e-5)


def test_lr_schedule_shape():
    cfg = opt.OptimizerConfig(learning_rate=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(opt.lr_at(cfg, s)) for s in (0, 5, 10, 55, 100)]
    assert lrs[0] == 0.0
    assert lrs[1] < lrs[2]
    assert lrs[2] >= lrs[3] >= lrs[4]
    assert lrs[4] >= cfg.learning_rate * cfg.min_lr_ratio * 0.99


def test_loss_decreases_and_resume(tmp_path):
    cfg = tconfigs.get_smoke("llama3.2-3b").with_(vocab_size=TOKENIZER.vocab_size)
    d = str(tmp_path)
    lc = LoopConfig(steps=8, batch=4, seq_len=64, ckpt_dir=d, ckpt_every=4, log_every=100)
    ocfg = opt.OptimizerConfig(learning_rate=1e-3, total_steps=12, warmup_steps=1)
    m1 = run(cfg, ocfg, lc, log=lambda s: None)
    assert m1["last_step"] == 8
    # resume continues from the checkpoint, not from scratch
    lc2 = LoopConfig(steps=12, batch=4, seq_len=64, ckpt_dir=d, ckpt_every=4, log_every=100)
    m2 = run(cfg, ocfg, lc2, log=lambda s: None)
    assert m2["last_step"] == 12
    assert m2["loss"] < 6.5  # byte-vocab CE starts ~ln(384)=5.95+margin; sane


def test_error_feedback_compression_roundtrip():
    rng = np.random.default_rng(0)
    err = grad_compress.init_error_buffer({"w": torch.zeros(64, 64)})
    # telescoping: accumulated dequantized grads converge to accumulated true
    acc_true = np.zeros((64, 64))
    acc_deq = np.zeros((64, 64))
    for _ in range(20):
        gt = {"w": torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32))}
        deq, err = grad_compress.compress_tree(gt, err)
        acc_true += gt["w"].numpy()
        acc_deq += deq["w"].numpy()
    # residual stays bounded by one quantization step, does not accumulate
    assert np.abs(acc_true - acc_deq).max() < 0.25


def test_bf16_optimizer_state_variant():
    cfg = opt.OptimizerConfig(state_dtype="bfloat16", use_master=False)
    params = {"w": torch.zeros(4, dtype=torch.bfloat16)}
    state = opt.init_state(params, cfg)
    assert "master" not in state
    assert state["m"]["w"].dtype == torch.bfloat16
    p2, _, _ = opt.apply_updates(cfg, params, state, {"w": torch.ones(4, dtype=torch.bfloat16)})
    assert p2["w"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the optimizer and compression against the reference
# ---------------------------------------------------------------------------


def _tree(rng, dtype: str) -> dict:
    """A nested tree of random leaves (scalar, vector, matrix, 3-d stack)."""
    shapes = {"a": {"w": (7, 5), "b": (5,)}, "c": (3, 4, 6), "d": ()}
    out = {}
    for k, s in shapes.items():
        if isinstance(s, dict):
            out[k] = {kk: rng.normal(size=ss).astype(np.float32) for kk, ss in s.items()}
        else:
            out[k] = np.asarray(rng.normal(size=s), np.float32)
    return jax.tree.map(lambda a: a if dtype == "float32" else
                        np.asarray(jnp.asarray(a, jnp.bfloat16)), out)


def _to_torch(tree) -> dict:
    return tcommon.unflatten({p: tcommon._leaf_tensor(np.asarray(v))
                              for p, v in jcommon.flatten(tree).items()})


def _to_jax(tree) -> dict:
    return jax.tree.map(jnp.asarray, tree)


def _assert_tree_close(got, want, what=""):
    gf = tcommon.flatten(got)
    wf = jcommon.flatten(want)
    assert sorted(gf) == sorted(wf), what
    for p in wf:
        g, w = gf[p], wf[p]
        assert str(g.dtype).split(".")[-1] == jnp.asarray(w).dtype.name, (what, p)
        if g.dtype == torch.bfloat16:
            np.testing.assert_allclose(_np(g), _np(w), rtol=2 ** -7, atol=1e-30,
                                       err_msg=f"{what} {p}")
        elif g.dtype == torch.float32:
            np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5, atol=1e-7,
                                       err_msg=f"{what} {p}")
        else:
            np.testing.assert_array_equal(_np(g), _np(w), err_msg=f"{what} {p}")


@pytest.mark.parametrize("warmup,total,min_ratio", [(10, 100, 0.1), (0, 7, 0.5), (3, 3, 0.0)])
def test_lr_at_matches_reference(warmup, total, min_ratio):
    kw = dict(learning_rate=3e-4, warmup_steps=warmup, total_steps=total, min_lr_ratio=min_ratio)
    tc, jc = opt.OptimizerConfig(**kw), jopt.OptimizerConfig(**kw)
    for s in range(0, total + 5):
        got, want = opt.lr_at(tc, s), jopt.lr_at(jc, s)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, err_msg=str(s))
        np.testing.assert_allclose(float(opt.lr_at(tc, torch.tensor(s, dtype=torch.int32))),
                                   float(want), rtol=1e-6)


@pytest.mark.parametrize("max_norm", [1.0, 1e6])
def test_clip_by_global_norm_matches_reference(max_norm):
    tree = _tree(np.random.default_rng(1), "float32")
    got, gn = opt.clip_by_global_norm(_to_torch(tree), max_norm)
    want, wn = jopt.clip_by_global_norm(_to_jax(tree), max_norm)
    np.testing.assert_allclose(float(gn), float(wn), rtol=1e-6)
    _assert_tree_close(got, want, "clipped")


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("state_dtype,use_master", [("float32", True), ("float32", False),
                                                    ("bfloat16", True), ("bfloat16", False)])
def test_apply_updates_matches_reference(param_dtype, state_dtype, use_master):
    rng = np.random.default_rng(2)
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=6, clip_norm=1.0,
              state_dtype=state_dtype, use_master=use_master)
    tc, jc = opt.OptimizerConfig(**kw), jopt.OptimizerConfig(**kw)
    params = _tree(rng, param_dtype)
    tp, jp = _to_torch(params), _to_jax(params)
    ts, js = opt.init_state(tp, tc), jopt.init_state(jp, jc)
    _assert_tree_close(ts, js, "init")
    for step in range(4):
        grads = _tree(rng, param_dtype)
        if step == 1:   # a small gradient: under the clip norm
            grads = jax.tree.map(lambda g: g * 1e-3, grads)
        tp, ts, tm = opt.apply_updates(tc, tp, ts, _to_torch(grads))
        jp, js, jm = jopt.apply_updates(jc, jp, js, _to_jax(grads))
        _assert_tree_close(tp, jp, f"params after step {step + 1}")
        _assert_tree_close(ts, js, f"state after step {step + 1}")
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)


def test_state_specs_match_reference():
    tcfg, jcfg = tconfigs.get_smoke("mixtral-8x22b"), jconfigs.get_smoke("mixtral-8x22b")
    for kw in ({}, {"state_dtype": "bfloat16", "use_master": False}):
        ts = opt.state_specs(treg.param_specs(tcfg), opt.OptimizerConfig(**kw))
        js = jopt.state_specs(jreg.param_specs(jcfg), jopt.OptimizerConfig(**kw))
        assert sorted(ts) == sorted(js)
        for p in ts:
            assert (ts[p].shape, ts[p].axes) == (js[p].shape, js[p].axes), p
            assert str(ts[p].dtype).split(".")[-1] == jnp.dtype(js[p].dtype).name, p


def test_compress_tree_identical_payloads_and_scales():
    rng = np.random.default_rng(3)
    tree = _tree(rng, "float32")
    terr = grad_compress.init_error_buffer(_to_torch(tree))
    jerr = jgc.init_error_buffer(_to_jax(tree))
    for _ in range(4):
        g = _tree(rng, "bfloat16")   # bf16 grads, as a train step gives them
        gf, ef = tcommon.flatten(_to_torch(g)), tcommon.flatten(terr)
        for p, leaf in jcommon.flatten(g).items():
            tq, tsc, te, td = grad_compress.compress_leaf(gf[p], ef[p])
            jq, jsc, je, jd = jgc.compress_leaf(jnp.asarray(leaf), jnp.asarray(_np(ef[p])))
            assert tq.dtype == torch.int8
            np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
            assert np.float32(tsc) == np.asarray(jsc)
            np.testing.assert_array_equal(te.numpy(), np.asarray(je))
            np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        tdeq, terr = grad_compress.compress_tree(_to_torch(g), terr)
        jdeq, jerr = jgc.compress_tree(_to_jax(g), jerr)
        for got, want in ((tdeq, jdeq), (terr, jerr)):
            gf = tcommon.flatten(got)
            for p, w in jcommon.flatten(want).items():
                np.testing.assert_array_equal(gf[p].numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# loss, gradients, remat, the loop
# ---------------------------------------------------------------------------


def _model(name="llama3.2-3b", seed=0, f32_params=False, **kw):
    """Both packages' smoke config and the same JAX-drawn weights (cast to f32
    when asked: the test then sees f32 gradients)."""
    tcfg = tconfigs.get_smoke(name).with_(**kw)
    jcfg = jconfigs.get_smoke(name).with_(**kw)
    jp = jreg.init_params(jcfg, jax.random.PRNGKey(seed))
    flat = {p: np.asarray(v) for p, v in jcommon.flatten(jp).items()}
    tp = tcommon.params_from_numpy(treg.param_specs(tcfg), flat)
    if f32_params:
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        tp = opt._map(lambda t: t.float(), tp)
    return tcfg, jcfg, tp, jp


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[0, :3] = TOKENIZER.pad_id          # PAD labels carry no loss
    return toks, labels


def _ref_value_and_grads(jcfg, jp, toks, labels, microbatches):
    """The reference's loss and gradient: ``jax.value_and_grad`` of its
    ``loss_fn`` per microbatch, accumulated in f32 and averaged as its
    ``make_train_step`` does."""
    fn = jax.jit(jax.value_and_grad(functools.partial(jts.loss_fn, jcfg), has_aux=True))
    mb = toks.shape[0] // microbatches
    loss, gacc = 0.0, None
    for j in range(microbatches):
        (l, metrics), g = fn(jp, jnp.asarray(toks[j * mb:(j + 1) * mb]),
                             jnp.asarray(labels[j * mb:(j + 1) * mb]))
        g = jax.tree.map(lambda x: x.astype(jnp.float32), g)
        gacc = g if gacc is None else jax.tree.map(jnp.add, gacc, g)
        loss = loss + l
    if microbatches > 1:
        gacc = jax.tree.map(lambda x: x / microbatches, gacc)
        loss = loss / microbatches
    return float(loss), metrics, gacc


def _assert_grads_close(got, want, rel):
    gf = tcommon.flatten(got)
    for p, w in jcommon.flatten(want).items():
        g, w = _np(gf[p]), np.asarray(w, np.float32)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= rel * scale, (p, err, scale)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_loss_and_grads_match_reference_f32(microbatches):
    tcfg, jcfg, tp, jp = _model(f32_params=True)
    toks, labels = _batch(tcfg, 4, 24, seed=5)
    loss, metrics, grads = tts.grads_and_loss(tcfg, tp, torch.from_numpy(toks),
                                              torch.from_numpy(labels),
                                              microbatches=microbatches)
    wl, wm, wg = _ref_value_and_grads(jcfg, jp, toks, labels, microbatches)
    np.testing.assert_allclose(float(loss), wl, rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce"]), float(wm["ce"]), rtol=1e-5)
    _assert_grads_close(grads, wg, 1e-5)
    # the gradient of every leaf is non-zero: attention's weights included
    for p, g in tcommon.flatten(grads).items():
        assert float(g.abs().max()) > 0, p


def test_loss_fn_value_matches_reference_with_bf16_params():
    tcfg, jcfg, tp, jp = _model()
    toks, labels = _batch(tcfg, 2, 24, seed=6)
    tl, tm = tts.loss_fn(tcfg, tp, torch.from_numpy(toks), torch.from_numpy(labels))
    jl, jm = jts.loss_fn(jcfg, jp, jnp.asarray(toks), jnp.asarray(labels))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _, _, grads = tts.grads_and_loss(tcfg, tp, torch.from_numpy(toks), torch.from_numpy(labels))
    _, _, wg = _ref_value_and_grads(jcfg, jp, toks, labels, 1)
    # bf16 gradients: each rounded once from f32 sums taken in another order
    _assert_grads_close(grads, wg, 2 ** -8)


def test_moe_aux_losses_enter_the_loss():
    tcfg, jcfg, tp, jp = _model("mixtral-8x22b", f32_params=True)
    toks, labels = _batch(tcfg, 2, 16, seed=7)
    tl, tm = tts.loss_fn(tcfg, tp, torch.from_numpy(toks), torch.from_numpy(labels))
    jl, jm = jts.loss_fn(jcfg, jp, jnp.asarray(toks), jnp.asarray(labels))
    assert sorted(tm) == sorted(jm) == ["ce", "moe_lb", "moe_z"]
    for k in tm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tl), float(tm["ce"] + tm["moe_lb"] + tm["moe_z"]),
                               rtol=1e-6)


@pytest.mark.parametrize("name", ["llama3.2-3b", "whisper-small", "xlstm-125m", "zamba2-7b"])
def test_remat_on_equals_remat_off(name):
    tcfg, _, tp, _ = _model(name, f32_params=True)
    assert tcfg.remat
    toks, labels = _batch(tcfg, 2, 16, seed=8)
    extra = None
    if tcfg.family == "audio":
        extra = {"audio_frames": torch.from_numpy(np.random.default_rng(9).normal(
            size=(2, tcfg.num_audio_frames, tcfg.d_model)).astype(np.float32))}
    out = {}
    for remat in (True, False):
        tree, leaves, _ = tts._grad_leaves(tcfg, tp)
        loss, _ = tts.loss_fn(tcfg.with_(remat=remat), tree, torch.from_numpy(toks),
                              torch.from_numpy(labels), extra)
        out[remat] = (loss.detach(), torch.autograd.grad(loss, leaves, allow_unused=True))
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(out[True][1], out[False][1]):
        assert (a is None and b is None) or torch.equal(a, b)


def test_remat_wraps_blocks_only_when_recording():
    tcfg, _, tp, _ = _model()
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    from repro_torch.models import transformer
    toks = torch.zeros((1, 8), dtype=torch.long)
    saved = transformer.checkpoint
    transformer.checkpoint = spy
    try:
        with torch.no_grad():
            treg.forward(tcfg, tp, toks, remat=True)
        assert not calls                       # no autograd: nothing to rematerialize
        tree, leaves, _ = tts._grad_leaves(tcfg, tp)
        treg.forward(tcfg, tree, toks, remat=True)
        assert len(calls) == tcfg.num_layers   # one per decoder layer
        calls.clear()
        treg.forward(tcfg.with_(remat=False), tree, toks, remat=True)
        assert not calls                       # the config's remat=False wins
    finally:
        transformer.checkpoint = saved


def test_loop_trajectory_matches_reference(tmp_path):
    """Both loops resume from one step-0 checkpoint the reference wrote (its
    weights), then run 5 steps one at a time, resuming each time: the loss
    of every step agrees."""
    jcfg = jconfigs.get_smoke("llama3.2-3b").with_(vocab_size=TOKENIZER.vocab_size)
    tcfg = tconfigs.get_smoke("llama3.2-3b").with_(vocab_size=TOKENIZER.vocab_size)
    kw = dict(learning_rate=1e-3, total_steps=5, warmup_steps=1)
    jo, to = jopt.OptimizerConfig(**kw), opt.OptimizerConfig(**kw)
    jp = jreg.init_params(jcfg, jax.random.PRNGKey(4))
    trees = {"params": jp, "opt_state": jopt.init_state(jp, jo)}
    jdir, tdir = str(tmp_path / "ref"), str(tmp_path / "port")
    jckpt.save(jdir, 0, trees)
    jckpt.save(tdir, 0, trees)
    got, want = [], []
    for steps in range(1, 6):
        lc = dict(steps=steps, batch=4, seq_len=32, microbatches=2, ckpt_every=1,
                  log_every=100, seed=3)
        want.append(jloop.run(jcfg, jo, jloop.LoopConfig(ckpt_dir=jdir, **lc),
                              log=lambda s: None))
        got.append(run(tcfg, to, LoopConfig(ckpt_dir=tdir, **lc), log=lambda s: None))
    assert [m["last_step"] for m in got] == [m["last_step"] for m in want] == [1, 2, 3, 4, 5]
    np.testing.assert_allclose([m["loss"] for m in got], [m["loss"] for m in want], rtol=1e-4)
    np.testing.assert_allclose([m["grad_norm"] for m in got], [m["grad_norm"] for m in want],
                               rtol=1e-3)
    assert got[-1]["loss"] < got[0]["loss"]


def test_launch_train_smoke_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train as launch_train
    m = launch_train.main(["--smoke", "--device", "cpu", "--steps", "3", "--batch", "2",
                           "--seq-len", "32", "--microbatches", "2", "--compress-grads",
                           "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    assert m["last_step"] == 3 and np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000002", "step_00000003"]
    assert "[train] final:" in capsys.readouterr().out


def test_launch_train_refuses_more_than_one_process(tmp_path):
    from repro_torch.launch import train as launch_train
    with pytest.raises(SystemExit) as err:
        launch_train.main(["--smoke", "--device", "cpu", "--num-processes", "2",
                           "--ckpt-dir", str(tmp_path)])
    assert err.value.code == 2
    assert not any(tmp_path.iterdir())
