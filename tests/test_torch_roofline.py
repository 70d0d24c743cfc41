"""The port's cost counter and roofline (``repro_torch.launch.hlo_analysis``,
``repro_torch.launch.roofline``, ``repro_torch.configs``' shape cells) on the
CPU, held against the reference's ``repro.launch``:

- the mirrors of ``tests/test_roofline.py``: a plain product counts exactly
  2 * 256^3; a Python loop of 12 products counts 12 of them and a nested
  4 x 5 loop 20 (``FlopCounterMode`` agrees: no loop trip count to recover,
  where the reference's test shows XLA's ``cost_analysis`` undercounting);
  dtype byte sizes; collective bytes over a fake world of 8 ranks in a
  subprocess (an all-reduce at twice its operand, a broadcast at once);
  the roofline terms and bottleneck with the H100 constants; the flash
  adjustment lowering the memory term; ``model_flops_for_cell`` equal to
  the reference's for every arch x shape;
- the mirrors of ``test_paper_surface.py``'s analyzer edges: an empty
  function costs nothing; an in-place cache write inside a 50-step loop is
  charged the slice, under 5 x the buffer;
- parity: ``SHAPES``, ``cell_applicable`` and ``input_specs`` shapes for
  every arch x shape; ``param_count`` and ``active_param_count`` of the 10
  configs, exactly; each family's smoke forward FLOPs against
  ``analyze_text`` of the reference's compiled forward (exact, or one named
  op: zamba2's shared-block ``skip_proj`` product, which XLA computes once
  for all the block's applications, and whisper's encoder keys, which the
  reference's chunked attention pads to a whole block); ``Roofline.to_json``
  of both packages on the same inputs with the reference module's constants
  set to the port's; ``report.build_table`` of both on one directory of
  records, identical text.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import pytest
import torch

import repro_torch
from repro import common as jcommon
from repro.configs import SHAPES as JSHAPES
from repro.configs import cell_applicable as jcell_applicable
from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.configs import input_specs as jinput_specs
from repro.launch import report as jreport
from repro.launch import roofline as jroofline
from repro.launch.hlo_analysis import analyze_text
from repro.models import registry as jregistry
from repro_torch import common
from repro_torch.configs import ARCHS, SHAPES, cell_applicable, get_config, get_smoke, input_specs
from repro_torch.launch import report, roofline
from repro_torch.launch.hlo_analysis import analyze, tensor_bytes
from repro_torch.models import registry

repro_torch.set_device("cpu")
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _meta_params(cfg):
    return common.unflatten({p: _meta(*s.shape, dtype=s.dtype)
                             for p, s in registry.param_specs(cfg).items()})


# ---------------------------------------------------------------------------
# mirrors of tests/test_roofline.py
# ---------------------------------------------------------------------------


def test_plain_matmul_exact():
    a = _meta(256, 256)
    assert analyze(lambda x, y: x @ y, a, a).flops == 2 * 256 ** 3


def test_python_loop_trips_counted():
    a = _meta(128, 128)

    def looped(x, w):
        for _ in range(12):
            x = x @ w
        return x

    costs = analyze(looped, a, a, flop_counter=True)
    assert costs.flops == 12 * 2 * 128 ** 3
    # FlopCounterMode sees the same ops: nothing here undercounts a loop
    assert costs.memory["flop_counter_flops"] == costs.flops


def test_nested_python_loop_trips():
    a = _meta(64, 64)

    def nested(x, w):
        for _ in range(4):
            for _ in range(5):
                x = x @ w
        return x

    costs = analyze(nested, a, a, flop_counter=True)
    assert costs.flops == 20 * 2 * 64 ** 3 == costs.memory["flop_counter_flops"]


def test_dtype_byte_sizes():
    sizes = {torch.bfloat16: 2, torch.float32: 4, torch.bool: 1, torch.int8: 1,
             torch.int64: 8, torch.float16: 2, torch.int32: 4}
    for dtype, n in sizes.items():
        assert tensor_bytes(_meta(8, 128, dtype=dtype)) == 8 * 128 * n
    assert tensor_bytes(_meta(0, 5)) == 0


def test_collective_bytes_fake_world_subprocess():
    code = """
        import json, torch, torch.distributed as dist
        from repro_torch.launch import dryrun
        from repro_torch.launch.hlo_analysis import analyze
        with dryrun.fake_world(8):
            def step(x, y):
                dist.all_reduce(x)
                dist.broadcast(y, src=0)
                return (x * 2).sum() + y.sum()
            costs = analyze(step, torch.empty(1024, 64, device="meta"),
                            torch.empty(256, dtype=torch.bfloat16, device="meta"))
        print(json.dumps(costs.coll))
    """
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True,
                       text=True, env=dict(os.environ, PYTHONPATH=SRC), timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    coll = json.loads(r.stdout.strip().splitlines()[-1])
    assert coll["all-reduce"] == 2 * 1024 * 64 * 4, coll
    assert coll["broadcast"] == 256 * 2, coll
    assert coll["total"] == coll["all-reduce"] + coll["broadcast"], coll


def test_roofline_terms_and_bottleneck():
    rl = roofline.Roofline(
        arch="x", shape="train_4k", mesh="single", chips=256,
        hlo_flops_per_dev=roofline.PEAK_FLOPS,          # exactly 1s of compute
        hlo_bytes_per_dev=roofline.HBM_BW * 0.5,        # 0.5s of memory
        coll_bytes_per_dev=roofline.LINK_BW * 0.25,     # 0.25s of collectives
        model_flops=256 * roofline.PEAK_FLOPS * 0.5, mem_per_dev={}, coll_breakdown={})
    assert rl.bottleneck == "compute"
    assert abs(rl.step_time - 1.0) < 1e-9
    assert abs(rl.mfu - 0.5) < 1e-9
    assert abs(rl.useful_flops_ratio - 0.5) < 1e-9
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (989e12, 3.35e12, 450e9)
    assert roofline.peaks("NVIDIA H100 80GB HBM3") == roofline.PEAKS["H100 SXM"]
    assert roofline.sku("NVIDIA H100 PCIe") == "H100 PCIe"
    assert roofline.sku("NVIDIA H100 NVL") == "H100 NVL"


def test_flash_adjustment_reduces_memory_term():
    rl = roofline.Roofline(
        arch="x", shape="prefill_32k", mesh="single", chips=256,
        hlo_flops_per_dev=1e12, hlo_bytes_per_dev=1e12,
        coll_bytes_per_dev=0.0, model_flops=1e14, mem_per_dev={},
        coll_breakdown={}, scopes={"attn_core": [5e11, 9e11]}, seq_len=32768)
    assert rl.flash_adjusted_bytes < rl.hlo_bytes_per_dev
    assert rl.t_memory_flash < rl.t_memory


@pytest.mark.parametrize("arch", list(ARCHS))
def test_model_flops_for_cell_matches_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for shape in SHAPES:
        got = roofline.model_flops_for_cell(cfg, SHAPES[shape])
        assert got == jroofline.model_flops_for_cell(jcfg, JSHAPES[shape]), (arch, shape)
    n = cfg.active_param_count()
    assert roofline.model_flops_for_cell(cfg, SHAPES["train_4k"]) == 6.0 * n * 256 * 4096
    assert roofline.model_flops_for_cell(cfg, SHAPES["decode_32k"]) == 2.0 * n * 128


# ---------------------------------------------------------------------------
# mirrors of test_paper_surface.py's analyzer edges
# ---------------------------------------------------------------------------


def test_empty_function_costs_nothing():
    costs = analyze(lambda: None)
    assert costs.flops == 0 and costs.bytes == 0 and costs.coll == {"total": 0}
    assert costs.memory["peak"] == 0


def test_inplace_cache_write_charged_the_slice():
    """An in-place cache update in a loop is charged the slice, not the
    buffer (the reference's decode-step measurement bug)."""
    def step(cache, x, idx):
        for i in range(50):
            cache[i:i + 1] = x                      # copy_ into a view
        cache.index_put_((idx,), x)                 # the decode step's write
        return cache

    cache, x = _meta(1 << 14, 128), _meta(1, 128)
    costs = analyze(step, cache, x, _meta(1, dtype=torch.long))
    buffer_bytes = (1 << 14) * 128 * 4
    assert costs.bytes < 5 * buffer_bytes, costs.bytes
    assert costs.bytes == 51 * 2 * 128 * 4, costs.bytes
    assert costs.memory["alias"] == buffer_bytes     # updated in place, returned


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list(ARCHS))
def test_shape_cells_and_input_specs_match_reference(arch):
    assert {n: (c.seq_len, c.global_batch, c.kind) for n, c in SHAPES.items()} == \
        {n: (c.seq_len, c.global_batch, c.kind) for n, c in JSHAPES.items()}
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert cfg.sub_quadratic == jcfg.sub_quadratic
    for name in SHAPES:
        assert cell_applicable(cfg, SHAPES[name]) == jcell_applicable(jcfg, JSHAPES[name])
        for hb in (None, 4):
            got = input_specs(cfg, SHAPES[name], per_host_batch=hb)
            want = jinput_specs(jcfg, JSHAPES[name], per_host_batch=hb)
            assert sorted(got) == sorted(want)
            for k, t in got.items():
                assert t.device.type == "meta" and tuple(t.shape) == tuple(want[k].shape)
                assert str(t.dtype).removeprefix("torch.") == str(want[k].dtype)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_counts_match_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()


B, S = 2, 32


def _named_op_flops(cfg) -> float:
    """The port's smoke forward FLOPs minus the reference's, by the one op
    where they part (zero elsewhere)."""
    if cfg.family == "hybrid":
        # the shared block's x0 @ skip_proj, the same operands at each of its
        # applications: XLA computes it once, the port at every application
        groups = cfg.num_layers // cfg.attn_every
        return 2.0 * B * S * cfg.d_model * cfg.d_model * (groups - 1)
    if cfg.family == "audio":
        # the encoder's chunked attention: the reference pads the frames'
        # keys to a whole block of attn_q_chunk (QK^T and PV over the pad)
        f, c = cfg.num_audio_frames, min(cfg.attn_q_chunk, cfg.num_audio_frames)
        pad = -f % c
        return -2 * 2.0 * B * cfg.num_heads * f * pad * cfg.hd * cfg.encoder_layers
    return 0.0


@pytest.mark.parametrize("arch", list(ARCHS))
def test_smoke_forward_flops_match_reference_hlo(arch):
    cfg, jcfg = get_smoke(arch), jget_smoke(arch)
    extra_j = extra_t = None
    key = {"vlm": ("image_embeds", cfg.num_image_tokens),
           "audio": ("audio_frames", cfg.num_audio_frames)}.get(cfg.family)
    if key is not None:
        shape = (B, key[1], cfg.d_model)
        extra_j = {key[0]: jax.ShapeDtypeStruct(shape, jcfg.activation_dtype)}
        extra_t = {key[0]: _meta(*shape, dtype=cfg.activation_dtype)}
    structs = jcommon.param_structs(jregistry.param_specs(jcfg))
    text = jax.jit(lambda p, t, e: jregistry.forward(jcfg, p, t, extra=e)[0]).lower(
        structs, jax.ShapeDtypeStruct((B, S), jnp.int32), extra_j).compile().as_text()
    want = analyze_text(text).flops
    got = analyze(lambda p, t: registry.forward(cfg, p, t, extra=extra_t)[0],
                  _meta_params(cfg), _meta(B, S, dtype=torch.int32)).flops
    assert got - want == _named_op_flops(cfg), (arch, got, want)


@pytest.mark.parametrize("with_attn", [False, True])
def test_roofline_to_json_matches_reference(monkeypatch, with_attn):
    monkeypatch.setattr(jroofline, "PEAK_FLOPS", roofline.PEAK_FLOPS)
    monkeypatch.setattr(jroofline, "HBM_BW", roofline.HBM_BW)
    monkeypatch.setattr(jroofline, "ICI_BW", roofline.LINK_BW)
    kw = dict(arch="llama3.2-3b", shape="prefill_32k", mesh="single", chips=256,
              hlo_flops_per_dev=3.1e14, hlo_bytes_per_dev=2.7e12, coll_bytes_per_dev=4.4e10,
              model_flops=5.2e16, mem_per_dev={"peak": 7.5e10},
              coll_breakdown={"all-reduce": 4.4e10, "total": 4.4e10},
              scopes={"attn_core": [1.2e14, 1.9e12]} if with_attn else {}, seq_len=32768)
    got = roofline.Roofline(**kw).to_json()
    want = jroofline.Roofline(**kw).to_json()
    flash = ("t_memory_flash_s", "step_time_flash_s", "mfu_flash")
    assert {k: v for k, v in got.items() if k not in flash} == \
        {k: v for k, v in want.items() if k not in flash}
    if not with_attn:
        assert got == want
    else:   # the K/V re-read per q block of the port's kernel (64 rows), not Pallas's 1024
        f_attn, b_attn = kw["scopes"]["attn_core"]
        adj = kw["hlo_bytes_per_dev"] - b_attn + f_attn * (2 / 64 + 2 / 32768)
        assert got["t_memory_flash_s"] == adj / roofline.HBM_BW


def test_report_table_matches_reference(tmp_path):
    def rec(arch, shape, mesh, status, **extra):
        d = {"arch": arch, "shape": shape, "mesh": mesh, "chips": 256, "status": status}
        d.update(extra)
        (tmp_path / f"{arch}__{shape}__{mesh}.json").write_text(json.dumps(d))

    for i, (arch, shape) in enumerate([("llama3.2-3b", "train_4k"), ("qwen2-72b", "decode_32k"),
                                       ("zamba2-7b", "long_500k"), ("llama3.2-3b", "prefill_32k")]):
        rl = roofline.Roofline(arch=arch, shape=shape, mesh="single", chips=256,
                               hlo_flops_per_dev=1e14 * (i + 1), hlo_bytes_per_dev=3e11 * (4 - i),
                               coll_bytes_per_dev=1e9 * i, model_flops=1e16,
                               mem_per_dev={"peak": 5e10 + i}, coll_breakdown={},
                               scopes={"attn_core": [1e13, 1e11]}, seq_len=4096)
        rec(arch, shape, "single", "ok", roofline=rl.to_json(), ideal_bytes_per_dev=2e9 * i)
    rec("qwen2-72b", "long_500k", "single", "skipped", skipped="long_500k needs ...")
    rec("mixtral-8x22b", "train_4k", "multi", "error", error="RuntimeError: x")
    assert report.build_table(str(tmp_path)) == jreport.build_table(str(tmp_path))
