"""The port's distribution layer (``repro_torch.dist``, ``launch/mesh``,
``models/moe_sharded``, ``checkpoint.restore_sharded``) against the
reference, on the CPU.

Rule resolution needs no devices and runs in this process.  The
multi-process paths run in one gloo world of 8 ranks
(``tests/torch_dist_world.py``, a subprocess of its own), which builds each
mesh it needs over the same ranks; the reference's sharded MoE runs on 8
forced CPU devices in a JAX subprocess beside it.  Inputs are drawn with
JAX and cross as a checkpoint in the reference's format.  The checks:

- the six cases of ``test_dist.py`` rewired to the port; the reference's
  context-parallel test fails on this jax (ROADMAP §3), so, as there, the
  port's context-parallel decode is held to the single-device
  ``decode_self_attention`` (out 3e-5, caches 1e-5, the reference test's
  bounds), at (2, 4) under the default rules, windowed, and at batch 1,
  where ``kv_seq`` takes ("data", "model");
- ``resolve_pspec`` equal to the reference's for every leaf of every catalog
  config's param and optimizer-state specs, on (2, 4), (16, 16) and
  (2, 16, 16), under both rule tables;
- ``moe_ffn_sharded`` against the reference's at (2, 4), (4, 2) and (1, 8)
  (tensor parallel: 4 experts on 8 model ranks): y and the aux losses
  within 1e-6 (f32 products over the same rows; one SUM over ``model`` in
  another order);
- ``pp_forward``/``make_pp_loss`` at (2, 4) ("pod", "data") against
  ``registry.forward`` and ``loss_fn``: logits 1e-4, loss 1e-4, gradients
  5e-4 (the reference test's bounds);
- ``restore_sharded`` of a reference-written checkpoint: each rank's shards
  bit for bit;
- the sharded train step against the reference's single-device step: loss
  1e-3, params 5e-3 (the reference test's bounds);
- on (2, 2, 2) ("pod", "data", "model"), where the default rules cut every
  layer stack over pod: the sharded train step of llama3.2-3b at 4 layers
  and of mixtral's smoke config under the same bounds, with a planted
  fault (each layer gathered from the other pod) beyond the grad-norm
  bound; and llama4's context-parallel ``decode_step`` over cache stacks
  cut over pod, data and model, logits within 1e-5 of the reference's
  single-device ``decode_step``.
"""
import functools
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro import common as jcommon
from repro.checkpoint import checkpoint as jckpt
from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.data.tokenizer import TOKENIZER as JTOKENIZER
from repro.dist import sharding as jshd
from repro.models import attention as JA
from repro.models import moe as JM
from repro.models import registry as jreg
from repro.train import optimizer as jopt
from repro.train.trainstep import loss_fn as jloss_fn
from repro.train.trainstep import make_train_step as jmake_train_step
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_config, get_smoke
from repro_torch.dist import sharding as shd
from repro_torch.models import registry
from repro_torch.train import optimizer as opt

repro_torch.set_device("cpu")

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
TIMEOUT = 180
MESHES = [((2, 4), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
CP_CASES = {"default": ({}, 4, [3, 33, 63, 0]), "window": ({"sliding_window": 16}, 4,
                                                           [3, 33, 63, 0]),
            "batch1": ({}, 1, [40])}
TRAIN_CFGS = {"llama3.2-3b": dict(vocab_size=384, d_model=64, d_ff=128),
              "mixtral-8x22b": dict(vocab_size=384)}
# the (2, 2, 2) ("pod", "data", "model") mesh: stacks that split over pod
POD_TRAIN_CFGS = {"llama3.2-3b": dict(TRAIN_CFGS["llama3.2-3b"], num_layers=4),
                  "mixtral-8x22b": TRAIN_CFGS["mixtral-8x22b"]}
POD_MESH = ((2, 2, 2), ("pod", "data", "model"))
POD_DECODE_ARCH = "llama4-maverick-400b-a17b"
POD_DECODE_LENS = [3, 31, 32, 63, 0, 17, 45, 33]     # on and across the sequence shards' edge
POD_DECODE_SEQ = 64

_MOE_REF = """
    import sys
    import jax
    from repro.checkpoint import checkpoint as ckpt
    from repro.configs import get_smoke
    from repro.launch.mesh import make_test_mesh
    from repro.models.moe_sharded import moe_ffn_sharded
    root = sys.argv[1]
    cfg = get_smoke("mixtral-8x22b")
    _, inp = ckpt.load(root + "/in")
    p, x = inp["moe"]["params"], inp["moe"]["x"]
    out = {}
    for shape in [(2, 4), (4, 2), (1, 8)]:
        mesh = make_test_mesh(shape, ("data", "model"))
        y, aux = jax.jit(lambda p, x: moe_ffn_sharded(p, x, cfg=cfg, mesh=mesh))(p, x)
        out["moe_%dx%d" % shape] = {"y": y, "lb": aux["moe_lb"], "z": aux["moe_z"]}
    ckpt.save(root + "/moe_ref", 0, out)
"""


def _np(t) -> np.ndarray:
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _key(i):
    return jax.random.PRNGKey(i)


def _inputs() -> tuple[dict, dict]:
    """(the inputs every rank reads, the reference's single-device results)."""
    inp, ref = {}, {}
    for name, (over, b, lens) in CP_CASES.items():
        cfg = jget_smoke("llama3.2-3b").with_(**over)
        params = jcommon.init_params(JA.attention_spec(cfg), _key(0))
        s = 64
        kc = jax.random.normal(_key(1), (b, s, cfg.num_kv_heads, cfg.hd))
        vc = jax.random.normal(_key(2), (b, s, cfg.num_kv_heads, cfg.hd))
        x = jax.random.normal(_key(3), (b, 1, cfg.d_model))
        lens = jnp.asarray(lens, jnp.int32)
        out, k2, v2 = jax.jit(functools.partial(JA.decode_self_attention, cfg=cfg))(
            params, x, kc, vc, lens)
        inp[f"cp_{name}"] = {"params": params, "kc": kc, "vc": vc, "x": x, "lens": lens}
        ref[f"cp_{name}"] = {"out": out, "k": k2, "v": v2}

    mcfg = jget_smoke("mixtral-8x22b")
    inp["moe"] = {"params": jcommon.init_params(JM.moe_spec(mcfg), _key(4)),
                  "x": jax.random.normal(_key(5), (8, 16, mcfg.d_model))}

    pcfg = jget_smoke("llama3.2-3b").with_(vocab_size=JTOKENIZER.vocab_size, num_layers=4)
    pp = jreg.init_params(pcfg, _key(0))
    tokens = jax.random.randint(_key(1), (16, 32), 0, 200)
    labels = jax.random.randint(_key(2), (16, 32), 0, 200)
    logits, _ = jax.jit(functools.partial(jreg.forward, pcfg))(pp, tokens)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, t, y: jloss_fn(pcfg, p, t, y), has_aux=True))(pp, tokens, labels)
    inp["pp"] = {"params": pp, "tokens": tokens, "labels": labels}
    ref["pp"] = {"logits": logits, "loss": loss, "grads": grads}

    for key, cfgs in (("train", TRAIN_CFGS), ("pod_train", POD_TRAIN_CFGS)):
        for name, over in cfgs.items():
            inp[f"{key}_{name}"], ref[f"{key}_{name}"] = _train_inputs(name, over)

    dcfg = jget_smoke(POD_DECODE_ARCH)
    dp = jreg.init_params(dcfg, _key(6))
    b = len(POD_DECODE_LENS)
    cache = {}
    for i, (path, sp) in enumerate(sorted(jreg.cache_specs(dcfg, b, POD_DECODE_SEQ).items())):
        cache[path] = jax.random.normal(_key(10 + i), sp.shape, jnp.float32)
    cache = jcommon.unflatten(cache)
    tokens = jax.random.randint(_key(7), (b, 1), 0, dcfg.vocab_size)
    lens = jnp.asarray(POD_DECODE_LENS, jnp.int32)
    inp["pod_decode"] = {"params": dp, "cache": cache, "tokens": tokens, "lens": lens}
    logits, c2 = jax.jit(functools.partial(jreg.decode_step, dcfg))(dp, tokens, cache, lens)
    ref["pod_decode"] = {"logits": logits, "cache": c2}
    return inp, ref


def _train_inputs(name: str, over: dict) -> tuple[dict, dict]:
    """A smoke config's params, AdamW state and batch, and the reference's
    single-device step on them."""
    tcfg = jget_smoke(name).with_(**over)
    tp = jreg.init_params(tcfg, _key(0))
    ocfg = jopt.OptimizerConfig(total_steps=2, warmup_steps=0)
    state = jopt.init_state(tp, ocfg)
    batch = {"tokens": jax.random.randint(_key(1), (8, 32), 0, 384),
             "labels": jax.random.randint(_key(2), (8, 32), 0, 384)}
    p2, _, m = jax.jit(jmake_train_step(tcfg, ocfg))(tp, state, batch)
    return ({"params": tp, "state": state, **batch},
            {"params": p2, "loss": m["loss"], "grad_norm": m["grad_norm"]})


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Run the world and the reference's sharded MoE once; -> (the reference's
    results, the MoE reference, each rank's results)."""
    d = tmp_path_factory.mktemp("dist_world")
    inp, ref = _inputs()
    jckpt.save(str(d / "in"), 0, inp)
    rng = np.random.default_rng(0)
    saved = {"w": jnp.arange(64.0).reshape(8, 8),
             "b": jnp.asarray(rng.standard_normal((2, 16)), jnp.bfloat16)}
    jckpt.save(str(d / "ref_ckpt"), 1, {"params": saved})
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    jax_env = {**env, "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
               "JAX_PLATFORMS": "cpu"}
    procs = [subprocess.Popen([sys.executable, "-c", textwrap.dedent(_MOE_REF), str(d)],
                              env=jax_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True),
             subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_dist_world.py"),
                               str(d), str(WORLD)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)]
    for p in procs:
        try:
            out, _ = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, out[-6000:]
    _, moe_ref = ckpt.load(str(d / "moe_ref"))
    ranks = [ckpt.load(str(d / f"out_{r}"))[1] for r in range(WORLD)]
    return {"ref": ref, "saved": saved, "moe": moe_ref, "ranks": ranks}


# ---------------------------------------------------------------------------
# rule resolution (no devices needed): test_dist.py's two cases, rewired
# ---------------------------------------------------------------------------


def test_resolve_pspec_divisibility_fallbacks():
    from repro_torch.dist.sharding import P, RULE_TABLES, abstract_mesh, resolve_pspec
    mesh = abstract_mesh((2, 4), ("data", "model"))
    rules = RULE_TABLES["serve_replicated"]
    assert resolve_pspec((512, 8, 128), ("embed_in", "kv_heads", "qkv"), mesh, rules) \
        == P(None, "model", None)
    assert resolve_pspec((512, 6, 128), ("embed_in", "kv_heads", "qkv"), mesh, rules) \
        == P(None, None, None)


def test_resolve_pspec_axis_used_once():
    from repro_torch.dist.sharding import P, RULE_TABLES, abstract_mesh, resolve_pspec
    mesh = abstract_mesh((2, 4), ("data", "model"))
    rules = RULE_TABLES["default"]
    spec = resolve_pspec((8, 64, 8, 128), ("batch", "kv_seq", "kv_heads", "qkv"), mesh, rules)
    assert spec == P("data", "model", None, None)
    spec = resolve_pspec((1, 64, 8, 128), ("batch", "kv_seq", "kv_heads", "qkv"), mesh, rules)
    assert spec == P(None, ("data", "model"), None, None)


def test_shard_coordinate_inverts_the_shard_index():
    mesh = shd.abstract_mesh((2, 4, 3), ("pod", "data", "model"))
    for axes in (("pod",), ("pod", "data"), ("data", "pod", "model"), ()):
        n = int(np.prod([shd.mesh_sizes(mesh)[a] for a in axes]))
        seen = set()
        for idx in range(n):
            c = shd.shard_coordinate(mesh, axes, idx)
            back = 0
            for a in axes:
                back = back * shd.mesh_sizes(mesh)[a] + c[a]
            assert back == idx and set(c) == set(axes)
            seen.add(tuple(sorted(c.items())))
        assert len(seen) == n


def test_cache_layer_is_the_stack_view_unless_its_layers_are_cut():
    """The single-mesh decode loops read ``stack[i]`` as before; only a
    ``DTensor`` stack whose layer dimension is sharded becomes a
    ``StackLayer``."""
    from torch.distributed.tensor.placement_types import Replicate, Shard

    from repro_torch.dist.context_parallel import StackLayer
    from repro_torch.models.attention import cache_layer
    stack = torch.arange(24.0).reshape(2, 3, 4)
    got = cache_layer(stack, 1)
    assert got.data_ptr() == stack[1].data_ptr() and torch.equal(got, stack[1])

    class Stub:             # a DTensor's placements, without a process group
        def __init__(self, placements):
            self.placements = placements

        def __getitem__(self, i):
            return ("view", i)

    assert cache_layer(Stub((Shard(1), Shard(2))), 3) == ("view", 3)
    assert cache_layer(Stub((Replicate(), Shard(1))), 0) == ("view", 0)
    cut = Stub((Shard(0), Shard(1), Shard(2)))
    assert cache_layer(cut, 5) == StackLayer(cut, 5)


@pytest.mark.parametrize("name", sorted(JARCHS))
def test_resolve_pspec_matches_reference_on_every_catalog_spec(name):
    """Every leaf of the config's param and AdamW-state specs, on three
    meshes under both rule tables: the same spec as the reference's."""
    jcfg, cfg = jget_config(name), get_config(name)
    jspecs, specs = jreg.param_specs(jcfg), registry.param_specs(cfg)
    trees = [(jspecs, specs), (jopt.state_specs(jspecs), opt.state_specs(specs))]
    n = 0
    for jtree, tree in trees:
        assert sorted(jtree) == sorted(tree)
        for shape, axes in MESHES:
            jmesh, mesh = jshd.abstract_mesh(shape, axes), shd.abstract_mesh(shape, axes)
            for rules in ("default", "serve_replicated"):
                for path, s in tree.items():
                    js = jtree[path]
                    assert (tuple(js.shape), tuple(js.axes)) == (s.shape, s.axes), path
                    got = shd.resolve_pspec(s.shape, s.axes, mesh, rules)
                    want = jshd.resolve_pspec(js.shape, js.axes, jmesh, rules)
                    assert tuple(got) == tuple(want), (path, shape, rules, got, want)
                    n += 1
    assert n > 0


# ---------------------------------------------------------------------------
# the gloo world
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(CP_CASES))
def test_context_parallel_decode_matches_reference(world, case):
    ref = world["ref"][f"cp_{case}"]
    b = CP_CASES[case][1]
    for r, res in enumerate(world["ranks"]):
        got = res["cp"][case]
        np.testing.assert_allclose(_np(got["out"]), np.asarray(ref["out"]), atol=3e-5, rtol=0,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(_np(got["k"]), np.asarray(ref["k"]), atol=1e-5, rtol=0)
        np.testing.assert_allclose(_np(got["v"]), np.asarray(ref["v"]), atol=1e-5, rtol=0)
        # batch 4: batch over data, the sequence over model; batch 1: the
        # sequence over (data, model)
        seq_axes = 2 if b == 1 else 1
        assert int(got["spec_seq"]) == seq_axes
        local = tuple(int(v) for v in got["local_shape"])
        assert local == (b if b == 1 else b // 2, 64 // (8 if b == 1 else 4), 2, 16), local


@pytest.mark.parametrize("mesh", ["2x4", "4x2", "1x8"])
def test_moe_ffn_sharded_matches_reference(world, mesh):
    want = world["moe"][f"moe_{mesh}"]
    for r, res in enumerate(world["ranks"]):
        got = res[f"moe_{mesh}"]
        np.testing.assert_allclose(_np(got["y"]), _np(want["y"]), atol=1e-6, rtol=0,
                                   err_msg=f"rank {r}")
        for k in ("lb", "z"):
            np.testing.assert_allclose(_np(got[k]), _np(want[k]), atol=1e-6, rtol=0)


def test_pipeline_parallel_matches_reference(world):
    ref = world["ref"]["pp"]
    for r, res in enumerate(world["ranks"]):
        got = res["pp"]
        np.testing.assert_allclose(_np(got["logits"]), np.asarray(ref["logits"]), atol=1e-4,
                                   rtol=0, err_msg=f"rank {r}")
        assert abs(float(got["loss"]) - float(ref["loss"])) < 1e-4
        stage = r // 4          # ("pod", "data") = (2, 4): the pod coordinate
        rows = slice(2 * stage, 2 * stage + 2)
        gref = jcommon.flatten(ref["grads"])
        for path, g in jcommon.flatten(got["grads"]).items():
            want = np.asarray(gref[path].astype(jnp.float32))
            g = _np(g)
            if path[0] == "layers":
                np.testing.assert_array_equal(np.delete(g, rows, axis=0), 0.0)
                g, want = g[rows], want[rows]
            err = float(np.max(np.abs(g - want)))
            assert err < 5e-4, (r, path, err)


def test_elastic_checkpoint_reshard(world):
    """A reference checkpoint restored onto (2, 4): each rank holds its
    shard, bit for bit."""
    w = np.arange(64.0).reshape(8, 8)
    b = np.asarray(world["saved"]["b"])
    for r, res in enumerate(world["ranks"]):
        got = res["restore"]
        d, m = divmod(r, 4)
        assert int(got["step"]) == 1
        np.testing.assert_array_equal(_np(got["w"]), w[4 * d:4 * d + 4, 2 * m:2 * m + 2])
        assert got["b"].dtype == torch.bfloat16
        np.testing.assert_array_equal(got["b"].view(torch.int16).numpy(),
                                      b.view(np.int16)[:, 2 * r:2 * r + 2])


@pytest.mark.parametrize("name", sorted(TRAIN_CFGS))
def test_gspmd_train_step_with_rules(world, name):
    """The sharded step on a (2, 4) mesh: finite metrics, params within
    5e-3 of the single-device step, each rank holding only its shards.
    AdamW's first step moves a weight by about lr whatever its gradient's
    size, so the gradient is held by its global norm, within 1e-4
    relative as ``test_torch_train_archs.py`` holds the single-device step's
    (bf16 gradients of two batch halves summed against one of the whole:
    2.8e-5 read for mixtral; the MoE entry's gradient summed over no ranks
    reads 4.8e-3).  mixtral's MoE layers go through
    ``moe_ffn_sharded`` (one expert a ``model`` rank), so their gradients
    cross its reductions."""
    ref = world["ref"][f"train_{name}"]
    jp = jcommon.flatten(ref["params"])
    specs = registry.param_specs(get_smoke(name).with_(**TRAIN_CFGS[name]))
    mesh = shd.abstract_mesh((2, 4), ("data", "model"))
    for r, res in enumerate(world["ranks"]):
        got = res[f"train_{name}"]
        assert np.isfinite(float(got["loss"]))
        assert abs(float(got["loss"]) - float(ref["loss"])) < 1e-3
        gn = float(ref["grad_norm"])
        assert abs(float(got["grad_norm"]) - gn) <= 1e-4 * gn, (r, float(got["grad_norm"]), gn)
        err = max(float(np.max(np.abs(_np(t) - np.asarray(jp[p].astype(jnp.float32)))))
                  for p, t in jcommon.flatten(got["params"]).items())
        assert err < 5e-3, (r, err)
        for path, t in jcommon.flatten(got["local"]).items():
            s = specs[path]
            sh = shd.NamedSharding(mesh, shd.resolve_pspec(s.shape, s.axes, mesh, "default"))
            assert tuple(t.shape) == sh.shard_shape(s.shape), path


@pytest.mark.parametrize("name", sorted(TRAIN_CFGS))
def test_gspmd_train_step_bound_sees_unsummed_gradients(world, name):
    """A planted fault: the same step with each gradient left unsummed over
    "data" (each rank's own half of the batch) lands beyond the grad-norm
    bound of ``test_gspmd_train_step_with_rules`` on every rank, so that
    bound can fail."""
    gn = float(world["ref"][f"train_{name}"]["grad_norm"])
    for r, res in enumerate(world["ranks"]):
        got = float(res[f"unsummed_{name}"]["grad_norm"])
        assert np.isfinite(got)
        assert abs(got - gn) > 1e-4 * gn, (r, got, gn)


# ---------------------------------------------------------------------------
# the (2, 2, 2) ("pod", "data", "model") mesh: stacks cut over pod
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(POD_TRAIN_CFGS))
def test_pod_sharded_train_step_matches_reference(world, name):
    """The sharded step on (2, 2, 2) under the default rules, which cut
    every layer stack over pod (each pod holds half the layers): the
    bounds of ``test_gspmd_train_step_with_rules`` against the reference's
    single-device step, and each rank's shards of the pod-cut specs."""
    ref = world["ref"][f"pod_train_{name}"]
    jp = jcommon.flatten(ref["params"])
    specs = registry.param_specs(get_smoke(name).with_(**POD_TRAIN_CFGS[name]))
    mesh = shd.abstract_mesh(*POD_MESH)
    cut = [p for p, s in specs.items()
           if shd.resolve_pspec(s.shape, s.axes, mesh, "default")[0] == "pod"]
    assert cut and all(specs[p].axes[0] == "layers" for p in cut), cut
    gn = float(ref["grad_norm"])
    for r, res in enumerate(world["ranks"]):
        got = res[f"pod_train_{name}"]
        assert np.isfinite(float(got["loss"]))
        assert abs(float(got["loss"]) - float(ref["loss"])) < 1e-3
        assert abs(float(got["grad_norm"]) - gn) <= 1e-4 * gn, (r, float(got["grad_norm"]), gn)
        err = max(float(np.max(np.abs(_np(t) - np.asarray(jp[p].astype(jnp.float32)))))
                  for p, t in jcommon.flatten(got["params"]).items())
        assert err < 5e-3, (r, err)
        for path, t in jcommon.flatten(got["local"]).items():
            s = specs[path]
            sh = shd.NamedSharding(mesh, shd.resolve_pspec(s.shape, s.axes, mesh, "default"))
            assert tuple(t.shape) == sh.shard_shape(s.shape), path


@pytest.mark.parametrize("name", sorted(POD_TRAIN_CFGS))
def test_pod_sharded_train_step_bound_sees_the_wrong_pod(world, name):
    """A planted fault: the same step gathering each layer from the other
    pod (the layer at the same slot there) lands beyond the grad-norm bound
    on every rank."""
    gn = float(world["ref"][f"pod_train_{name}"]["grad_norm"])
    for r, res in enumerate(world["ranks"]):
        got = float(res[f"wrong_pod_{name}"]["grad_norm"])
        assert np.isfinite(got)
        assert abs(got - gn) > 1e-4 * gn, (r, got, gn)


def test_pod_context_parallel_decode_step_matches_reference(world):
    """``registry.decode_step`` of llama4's smoke config with ``decode_cp``
    under the default rules on (2, 2, 2): each cache stack cut over layers
    (pod), batch (data) and sequence (model), while the attention's layer
    spec cuts the batch over (pod, data).  The logits within 1e-5 of the
    reference's single-device ``decode_step``; the gathered stacks equal
    its caches, bit for bit where nothing was written and within 1e-5 at
    the written positions (each layer's new token follows the layers
    before it)."""
    ref = world["ref"]["pod_decode"]
    want = jcommon.flatten(ref["cache"])
    b, s = len(POD_DECODE_LENS), POD_DECODE_SEQ
    written = np.zeros((b, s), bool)
    written[np.arange(b), POD_DECODE_LENS] = True
    for r, res in enumerate(world["ranks"]):
        got = res["pod_decode"]
        np.testing.assert_allclose(_np(got["logits"]), np.asarray(ref["logits"]), atol=1e-5,
                                   rtol=0, err_msg=f"rank {r}")
        for path, t in jcommon.flatten(got["cache"]).items():
            g, w = _np(t), np.asarray(want[path])
            np.testing.assert_array_equal(g[:, ~written], w[:, ~written])
            np.testing.assert_allclose(g[:, written], w[:, written], atol=1e-5, rtol=0)
            key = "/".join(path)
            # layers over pod, batch over data, sequence over model
            assert [int(v) for v in got["specs"][key]] == [1, 1, 1, 0, 0], (path, got["specs"])
            lay, _, _, hk, hd = w.shape
            assert tuple(int(v) for v in got["local"][key]) == (lay // 2, b // 2, s // 2, hk,
                                                                 hd), path
