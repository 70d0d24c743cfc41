"""The port's MoE FFN (``models/moe.py``) against ``repro``'s on the CPU,
and the param specs of the three families this module serves.

``moe_ffn`` runs on JAX-drawn weights crossed with ``params_from_numpy``:
the output and the aux losses agree to ``1e-5`` (f32), and the routing
(expert ids, each choice's slot in its expert, the dropped choices) is
identical to the reference's, whose routing the test recomputes from
``repro.models.moe._moe_ffn``'s own steps.  Cases: a capacity that drops
choices, ``capacity_factor=8`` (no drops), and an all-zero router (uniform
probabilities: every tie goes to the lowest expert index, as
``jax.lax.top_k`` breaks it), each at top-1 and top-2."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro import common as jcommon
from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro.models import registry as jreg
from repro_torch import common as tcommon
from repro_torch import configs as tconfigs
from repro_torch.models import moe as tmoe
from repro_torch.models import registry as treg

FULL = ["mixtral-8x22b", "llama4-maverick-400b-a17b", "llama-3.2-vision-11b"]


@pytest.fixture(autouse=True)
def _cpu():
    repro_torch.set_device("cpu")


def _jroute(params, x, cfg):
    """The reference's routing, step for step as ``repro.models.moe._moe_ffn``."""
    b, s, _ = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = jmoe.capacity(cfg, s)
    logits = jnp.einsum("bsd,de->bse", x.astype(jnp.float32), params["router"])
    gate_vals, expert_idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    flat = jax.nn.one_hot(expert_idx, e, dtype=jnp.int32).reshape(b, s * k, e)
    pos = jnp.sum((jnp.cumsum(flat, axis=1) - 1) * flat, axis=-1).reshape(b, s, k)
    dropped = pos >= cap
    return np.asarray(expert_idx), np.asarray(jnp.where(dropped, cap, pos)), np.asarray(dropped)


def _moe_case(k: int, case: str):
    """A mixtral-style smoke MoE layer (d 64, ff 128, 4 experts) in f32, its
    weights drawn by JAX, and x [3, 40, 64]."""
    cf = {"drops": 1.0, "no_drops": 8.0, "zero_router": 1.25}[case]
    kw = dict(experts_per_token=k, capacity_factor=cf, dtype="float32")
    tcfg = tconfigs.get_smoke("mixtral-8x22b").with_(**kw)
    jcfg = jconfigs.get_smoke("mixtral-8x22b").with_(**kw)
    jp = jcommon.init_params(jmoe.moe_spec(jcfg), jax.random.PRNGKey(k))
    flat = {p: np.asarray(v) for p, v in jcommon.flatten(jp).items()}
    if case == "zero_router":
        flat[("router",)] = np.zeros_like(flat[("router",)])
    x = np.random.default_rng(k).normal(size=(3, 40, tcfg.d_model)).astype(np.float32)
    tp = tcommon.params_from_numpy(tmoe.moe_spec(tcfg), flat)
    jp = {p[0]: jnp.asarray(v) for p, v in flat.items()}
    return tcfg, jcfg, tp, jp, x


@pytest.mark.parametrize("case", ["drops", "no_drops", "zero_router"])
@pytest.mark.parametrize("k", [1, 2])
def test_moe_ffn_matches_reference(k, case):
    tcfg, jcfg, tp, jp, x = _moe_case(k, case)
    xt = torch.from_numpy(x)
    _, _, _, t_idx, t_slot, t_drop = tmoe.route(tp, xt, cfg=tcfg)
    j_idx, j_slot, j_drop = _jroute(jp, jnp.asarray(x), jcfg)
    np.testing.assert_array_equal(t_idx.numpy(), j_idx)
    np.testing.assert_array_equal(t_slot.numpy(), j_slot)
    np.testing.assert_array_equal(t_drop.numpy(), j_drop)
    n_drop = int(j_drop.sum())
    if case == "no_drops":
        assert n_drop == 0
    elif case == "drops":
        assert 0 < n_drop < j_drop.size              # some choices dropped, not all
    else:                                           # uniform: the lowest k experts win
        np.testing.assert_array_equal(j_idx, np.broadcast_to(np.arange(k), j_idx.shape))
        assert n_drop > 0                           # 40 x k choices for 4 x capacity slots

    got, t_aux = tmoe.moe_ffn(tp, xt, cfg=tcfg)
    want, j_aux = jmoe.moe_ffn(jp, jnp.asarray(x), cfg=jcfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert sorted(t_aux) == sorted(j_aux) == ["moe_lb", "moe_z"]
    for name in j_aux:
        np.testing.assert_allclose(float(t_aux[name]), float(j_aux[name]), atol=1e-5, rtol=0)


def test_moe_ffn_in_bf16_routes_as_the_reference():
    """bf16 activations: the router runs in f32 on the bf16 inputs, so the
    routing is identical; the output agrees to bf16's rounding."""
    tcfg, jcfg, tp, jp, x = _moe_case(2, "drops")
    tcfg, jcfg = tcfg.with_(dtype="bfloat16"), jcfg.with_(dtype="bfloat16")
    xb = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)
    t_idx, t_slot = tmoe.route(tp, xt, cfg=tcfg)[3:5]
    j_idx, j_slot, _ = _jroute(jp, xb, jcfg)
    np.testing.assert_array_equal(t_idx.numpy(), j_idx)
    np.testing.assert_array_equal(t_slot.numpy(), j_slot)
    got, _ = tmoe.moe_ffn(tp, xt, cfg=tcfg)
    want, _ = jmoe.moe_ffn(jp, xb, cfg=jcfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=2e-2, rtol=2e-2)


def test_capacity_matches_reference():
    for name in FULL[:2]:
        for cf in (1.0, 1.25, 8.0):
            tcfg = tconfigs.get_config(name).with_(capacity_factor=cf)
            jcfg = jconfigs.get_config(name).with_(capacity_factor=cf)
            assert [tmoe.capacity(tcfg, s) for s in range(1, 9000, 7)] == \
                [jmoe.capacity(jcfg, s) for s in range(1, 9000, 7)]


@pytest.mark.parametrize("name", FULL)
def test_param_specs_are_the_references(name):
    """Shapes, axes, init, dtype and the param count of the published
    configs (mixtral-8x22b: moe; llama4-maverick: moe_interleave with the
    shared expert; llama-3.2-vision: vlm with its cross blocks)."""
    tcfg, jcfg = tconfigs.get_config(name), jconfigs.get_config(name)
    ts, js = treg.param_specs(tcfg), jreg.param_specs(jcfg)
    assert sorted(ts) == sorted(js)
    for p in ts:
        assert (ts[p].shape, ts[p].axes, ts[p].init, ts[p].init_scale) == \
            (js[p].shape, js[p].axes, js[p].init, js[p].init_scale), p
        assert str(ts[p].dtype).split(".")[-1] == jnp.dtype(js[p].dtype).name, p
    assert tcfg.param_count() == jcommon.param_count(js)
    assert tcommon.param_bytes(ts) == jcommon.param_bytes(js)
    tc, jc = treg.cache_specs(tcfg, 2, 64), jreg.cache_specs(jcfg, 2, 64)
    assert {p: (s.shape, s.axes) for p, s in tc.items()} == \
        {p: (s.shape, s.axes) for p, s in jc.items()}
