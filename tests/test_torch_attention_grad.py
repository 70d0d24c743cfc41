"""The gradient of attention on the CPU.

``ref.flash_attention_bwd_ref`` (torch autograd through the port's contract)
against ``jax.vjp`` of the reference's jnp contract
(``repro.kernels.ref.flash_attention_ref``) on the same numpy inputs, in
f32: GQA, causal or not, windows, rows that no key may see, Sq != Sk, head
dims 16-128, within ``rtol=atol=1e-5`` (f32 sums in another order).  The
CUDA backward kernel is held against this plain version on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py`` phase 19).

``ref.flash_attention_stats_ref`` (each row's softmax max m and sum l, which
the bf16 forward kernel saves for its backward) is held against m and l
taken with ``jnp`` from the scores inside the reference's
``flash_attention_ref``, within ``rtol=atol=1e-6`` in f32 (the scores are
summed in another order; the absolute floor covers maxima near 0).

``FlashAttention`` (the autograd binding of the two kernels) is exercised
here with its two kernels replaced by their plain versions: the model's
weights get the gradients the plain path gives them, each backward
launches once, and in bf16 the backward receives the forward's statistics
(asked for only when a gradient will be)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro import common as jcommon
from repro import configs as jconfigs
from repro.kernels import ref as jref
from repro.models import registry as jreg
from repro_torch import common as tcommon
from repro_torch import configs as tconfigs
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import registry as treg
from repro_torch.train import trainstep as tts

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu():
    repro_torch.set_device("cpu")


def _inputs(b, sq, sk, h, hk, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, sk, hk, hd)).astype(np.float32)
    v = rng.normal(size=(b, sk, hk, hd)).astype(np.float32)
    dout = rng.normal(size=(b, sq, h, hd)).astype(np.float32)
    return q, k, v, dout


CASES = [  # (b, sq, sk, h, hk, hd), causal, window
    ((2, 40, 40, 4, 2, 32), True, 0),         # GQA, causal
    ((1, 33, 33, 8, 1, 16), True, 0),         # H/Hk 8
    ((2, 24, 24, 4, 4, 64), False, 0),        # no mask at all
    ((2, 48, 48, 6, 2, 32), True, 8),         # sliding window
    ((1, 30, 30, 4, 2, 16), False, 5),        # window without causality
    ((2, 20, 50, 4, 2, 32), True, 0),         # Sq < Sk
    ((2, 50, 20, 4, 2, 32), True, 0),         # Sq > Sk
    ((2, 64, 20, 4, 2, 16), True, 6),         # rows >= Sk + window - 1: no key may see them
    ((1, 40, 12, 2, 1, 128), False, 4),       # the same without causality, hd 128
    ((1, 17, 17, 3, 3, 100), True, 0),        # hd 100, odd lengths
]


@pytest.mark.parametrize("shape,causal,window", CASES)
def test_backward_plain_version_matches_jax_vjp(shape, causal, window):
    q, k, v, dout = _inputs(*shape, seed=sum(shape) + window)
    out, vjp = jax.vjp(lambda q, k, v: jref.flash_attention_ref(q, k, v, causal=causal,
                                                                window=window),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tout = tref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(tout.numpy(), np.asarray(out), **TOL)
    got = tref.flash_attention_bwd_ref(tq, tk, tv, tout, torch.from_numpy(dout),
                                       causal=causal, window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)


def test_backward_contract_details():
    """A row no key may see sends its uniform P into dv only; dk and dv sum
    over the group's q-heads."""
    b, sq, sk, h, hk, hd, w = 1, 12, 4, 4, 2, 8, 2
    q, k, v, dout = (torch.from_numpy(a) for a in _inputs(b, sq, sk, h, hk, hd, seed=3))
    out = tref.flash_attention_ref(q, k, v, causal=True, window=w)
    dq, dk, dv = tref.flash_attention_bwd_ref(q, k, v, out, dout, causal=True, window=w)
    dead = sk + w - 1                                     # rows 5.. see no key
    assert float(dq[:, dead:].abs().max()) == 0.0
    _, dk_live, dv_live = tref.flash_attention_bwd_ref(
        q[:, :dead], k, v, out[:, :dead], dout[:, :dead], causal=True, window=w)
    torch.testing.assert_close(dk, dk_live, rtol=1e-6, atol=1e-6)   # dead rows: no dk
    uniform = dout[:, dead:].sum(1) / sk                  # [b, h, hd]: each key gets 1/Sk
    grouped = uniform.view(b, hk, h // hk, hd).sum(2)
    torch.testing.assert_close(dv - dv_live, grouped[:, None].expand(b, sk, hk, hd),
                               rtol=1e-5, atol=1e-5)
    # the group sum: kv-head 0's gradient is the sum over q-heads 0 and 1
    one = [tref.flash_attention_bwd_ref(q[:, :, j:j + 1], k[:, :, :1], v[:, :, :1],
                                        out[:, :, j:j + 1], dout[:, :, j:j + 1],
                                        causal=True, window=w) for j in (0, 1)]
    torch.testing.assert_close(dk[:, :, :1], one[0][1] + one[1][1], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dv[:, :, :1], one[0][2] + one[1][2], rtol=1e-5, atol=1e-6)


@pytest.fixture
def plain_kernels(monkeypatch):
    """``FlashAttention`` with its two kernels replaced by their plain
    versions, counting as the kernels do and keeping the statistics as the
    kernels do (bf16 only); the ops entry takes the kernel path for these
    CPU tensors.  Yields the list of (return_stats, stats passed back)."""
    calls = []

    def fwd(q, k, v, *, causal, window, return_stats=False):
        tfa.launches += 1
        out = tref.flash_attention_ref(q, k, v, causal=causal, window=window)
        if not return_stats:
            calls.append(("fwd", False))
            return out
        stats = None
        if q.dtype == torch.bfloat16:
            stats = torch.stack(tref.flash_attention_stats_ref(q, k, v, causal=causal,
                                                               window=window))
        calls.append(("fwd", True))
        return out, stats

    def bwd(q, k, v, out, dout, *, causal, window, stats=None):
        tfa.backward_launches += 1
        assert (stats is not None) == (q.dtype == torch.bfloat16)
        if stats is not None:
            want = torch.stack(tref.flash_attention_stats_ref(q, k, v, causal=causal,
                                                              window=window))
            assert torch.equal(stats, want)
        calls.append(("bwd", stats is not None))
        return tref.flash_attention_bwd_ref(q, k, v, out, dout, causal=causal, window=window)

    monkeypatch.setattr(tfa, "flash_attention", fwd)
    monkeypatch.setattr(tfa, "flash_attention_bwd", bwd)
    monkeypatch.setattr(tops, "_resolve", lambda impl, t: "cuda")
    tfa.launches = tfa.backward_launches = 0
    yield calls
    tfa.launches = tfa.backward_launches = 0


STATS_CASES = [  # (b, sq, sk, h, hk, hd), causal, window
    ((2, 40, 40, 4, 2, 32), True, 0),         # GQA, causal
    ((1, 33, 33, 8, 1, 16), True, 0),         # H/Hk 8
    ((2, 24, 24, 4, 4, 64), False, 0),        # no mask at all
    ((2, 48, 48, 6, 2, 32), True, 8),         # sliding window
    ((1, 30, 30, 4, 2, 16), False, 5),        # window without causality
    ((2, 20, 50, 4, 2, 32), True, 0),         # Sq < Sk
    ((2, 64, 20, 4, 2, 16), True, 6),         # rows >= Sk + window - 1: no key may see them
    ((1, 40, 12, 2, 1, 128), False, 4),       # the same without causality, hd 128
]


@pytest.mark.parametrize("shape,causal,window", STATS_CASES)
def test_stats_plain_version_matches_jax_scores(shape, causal, window, monkeypatch):
    """m and l against jnp's max and sum over the scores the reference's
    ``flash_attention_ref`` hands to its softmax; rows no key may see have
    m = NEG_INF and l = Sk exactly."""
    q, k, v, _ = _inputs(*shape, seed=sum(shape) + window + 7)
    seen = []
    softmax = jax.nn.softmax

    def capture(s, axis=-1):
        seen.append(s)
        return softmax(s, axis=axis)

    monkeypatch.setattr(jax.nn, "softmax", capture)
    jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                             window=window)
    (s,) = seen
    m_want = jnp.max(s, axis=-1)
    l_want = jnp.sum(jnp.exp(s - m_want[..., None]), axis=-1)
    m, l = tref.flash_attention_stats_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                          causal=causal, window=window)
    assert m.shape == l.shape == (shape[0], shape[3], shape[1])
    assert m.dtype == l.dtype == torch.float32
    np.testing.assert_allclose(m.numpy(), np.asarray(m_want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(l.numpy(), np.asarray(l_want), rtol=1e-6, atol=1e-6)
    sq, sk = shape[1], shape[2]
    if window and sq >= sk + window - 1:
        dead = slice(sk + window - 1, None)
        assert bool((m[:, :, dead] == tref.NEG_INF).all())
        assert bool((l[:, :, dead] == sk).all())


def test_autograd_binding_gives_the_plain_gradients(plain_kernels):
    q, k, v, dout = (torch.from_numpy(a).requires_grad_(i < 3)
                     for i, a in enumerate(_inputs(2, 40, 40, 4, 2, 32, seed=4)))
    out = tops.flash_attention(q, k, v, causal=True, window=16)
    assert out.grad_fn is not None and type(out.grad_fn).__name__.startswith("FlashAttention")
    got = torch.autograd.grad(out, (q, k, v), dout)
    want = tref.flash_attention_bwd_ref(q, k, v, out, dout, causal=True, window=16)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (tfa.launches, tfa.backward_launches) == (1, 1)


def test_train_step_through_the_kernel_pair_under_remat(plain_kernels):
    """The smoke llama's gradients with ``attn_impl="pallas"`` (the binding)
    equal the plain path's (``"full"``) to 1e-5 of each leaf's magnitude, and
    ``wq``/``wk``/``wv`` get theirs; under remat each layer launches the
    forward twice (the recompute) and the backward once."""
    jcfg = jconfigs.get_smoke("llama3.2-3b")
    jp = jreg.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = tconfigs.get_smoke("llama3.2-3b").with_(attn_impl="pallas")
    flat = {p: np.asarray(v) for p, v in jcommon.flatten(jp).items()}
    params = tcommon.params_from_numpy(treg.param_specs(cfg), flat)
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (4, 24)).astype(np.int32))
    labels = torch.from_numpy(rng.integers(1, cfg.vocab_size, (4, 24)).astype(np.int32))
    assert cfg.remat
    loss, _, grads = tts.grads_and_loss(cfg, params, toks, labels, microbatches=2)
    assert (tfa.launches, tfa.backward_launches) == (2 * 2 * cfg.num_layers,
                                                     2 * cfg.num_layers)
    wl, _, wg = tts.grads_and_loss(cfg.with_(attn_impl="full"), params, toks, labels,
                                   microbatches=2)
    np.testing.assert_allclose(float(loss), float(wl), rtol=1e-6)
    gf = tcommon.flatten(grads)
    for p, w in tcommon.flatten(wg).items():
        err = float((gf[p] - w).abs().max())
        assert err <= 1e-5 * float(w.abs().max()), (p, err)
    for name in ("wq", "wk", "wv"):
        assert float(grads["layers"]["attn"][name].abs().max()) > 0, name


def test_autograd_binding_passes_the_forward_stats_in_bf16(plain_kernels):
    """In bf16 the forward keeps its row statistics and the backward gets
    them (the fixture holds them to ``flash_attention_stats_ref``); the
    gradients are the plain version's.  Inputs that need no gradient (the
    engine's inference) launch without statistics."""
    q, k, v, dout = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_(i < 3)
                     for i, a in enumerate(_inputs(2, 70, 70, 4, 2, 32, seed=9)))
    out = tops.flash_attention(q, k, v, causal=True, window=24)
    got = torch.autograd.grad(out, (q, k, v), dout)
    want = tref.flash_attention_bwd_ref(q, k, v, out, dout, causal=True, window=24)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and torch.equal(g, w)
    assert plain_kernels == [("fwd", True), ("bwd", True)]
    plain_kernels.clear()
    with torch.no_grad():
        plain = tops.flash_attention(q.detach(), k.detach(), v.detach(), causal=True)
    assert plain_kernels == [("fwd", False)]
    assert torch.equal(plain, tref.flash_attention_ref(q, k, v, causal=True))
    assert (tfa.launches, tfa.backward_launches) == (2, 1)
