"""The port's launch/ tooling on the CPU (``repro_torch.launch.dryrun``,
``hlo_debug``, the cost scopes of ``common/scopes.py`` and the kernels'
``cost()``):

- each hand-written kernel's ``cost()`` against a brute-force count of its
  work: the attention forward's and backward's unmasked (q, k) pairs under
  causal, window and GQA masks, ``decode_attention``'s attended rows, the
  cluster scans' distinct (query block, cluster) pairs, ``rmsnorm`` and
  ``similarity``; the bounds at PERF.md's shapes;
- ``temp`` of a known chain of products, exactly;
- the scopes: ``attn_core``, ``moe_ffn`` and ``ssd_core`` hold a train
  step's backward as well as its forward (3 x the forward's products
  without remat), and a call with no counter active records nothing; a
  kernel's charge lands under its scope;
- a dry-run cell traced on meta tensors counts exactly what the same cell
  executes on real tensors (train, prefill and decode of three families);
- ``dryrun.run_cell("llama3.2-3b", "train_4k", ...)`` on a (2, 4) fake world
  in a subprocess: ``ok``, broadcast (the gathers) and all-reduce bytes
  above 0, and per-device FLOPs x 8 at least 0.99 x the unsharded trace's;
  its ``decode_32k`` cell holds an eighth of the cache a rank;
  a skipped cell carries the reference's reason;
- ``hlo_debug.top_contributors`` of a smoke train step.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro_torch
from repro.configs import SHAPES as JSHAPES
from repro.configs import cell_applicable as jcell_applicable
from repro.configs import get_config as jget_config
from repro_torch import common
from repro_torch.common import scopes
from repro_torch.configs import ShapeCell, get_config, get_smoke
from repro_torch.dist import sharding as shd
from repro_torch.kernels import decode_attention as kda
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ivf_scan as kivf
from repro_torch.kernels import ivf_scan_q as kivfq
from repro_torch.kernels import rmsnorm as krn
from repro_torch.kernels import similarity as ksim
from repro_torch.launch import dryrun, hlo_debug, roofline
from repro_torch.launch.hlo_analysis import analyze
from repro_torch.models import registry
from repro_torch.train import optimizer as opt
from repro_torch.train.trainstep import loss_fn, make_train_step

repro_torch.set_device("cpu")
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _brute_pairs(sq, sk, causal, window):
    i, j = np.arange(sq)[:, None], np.arange(sk)[None, :]
    m = np.ones((sq, sk), bool)
    if causal:
        m &= i >= j
    if window:
        m &= i - j < window
    return int(m.sum())


# ---------------------------------------------------------------------------
# the kernels' cost()
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,sq,sk,h,hk,hd,causal,window", [
    (2, 512, 512, 24, 8, 128, True, 0),        # the training shape, GQA 3
    (1, 37, 53, 8, 8, 64, True, 0),            # ragged, causal past the diagonal
    (3, 40, 40, 6, 2, 32, True, 7),            # sliding window
    (2, 24, 24, 12, 12, 32, False, 0),         # the encoder's full mask
    (1, 30, 19, 4, 1, 16, False, 5),           # window without causality, MQA
])
def test_attention_costs_count_the_unmasked_pairs(b, sq, sk, h, hk, hd, causal, window):
    pairs = _brute_pairs(sq, sk, causal, window)
    assert kfa.pairs(sq, sk, causal=causal, window=window) == pairs
    for es in (2, 4):
        qb, kb = es * b * sq * h * hd, es * b * sk * hk * hd
        assert kfa.cost(b, sq, sk, h, hk, hd, causal=causal, window=window, itemsize=es) == \
            (4 * b * h * hd * pairs, 2 * qb + 2 * kb)
        assert kfa.cost(b, sq, sk, h, hk, hd, causal=causal, window=window, itemsize=es,
                        stats=True)[1] == 2 * qb + 2 * kb + 8 * b * h * sq
        assert kfa.backward_cost(b, sq, sk, h, hk, hd, causal=causal, window=window,
                                 itemsize=es) == (10 * b * h * hd * pairs, 4 * qb + 4 * kb)


@pytest.mark.parametrize("window", [0, 100])
def test_decode_attention_cost_counts_attended_rows(window):
    b, s, h, hk, hd = 6, 256, 12, 4, 64
    lens = torch.tensor([0, 5, 255, 300, 100, 17], dtype=torch.int32)
    rows = 0
    for n in lens.tolist():
        k = np.arange(s)
        seen = k <= n
        if window:
            seen &= n - k < window
        rows += int(seen.sum())
    flops, nbytes = kda.cost(b, s, h, hk, hd, lens, window=window, itemsize=2)
    assert flops == 4 * rows * h * hd
    assert nbytes == rows * hk * hd * 2 * 2 + 2 * b * h * hd * 2 + 4 * b
    assert kda.cost(b, s, h, hk, hd, lens.tolist(), window=window) == (flops, nbytes)


def test_cluster_scan_costs_count_distinct_pairs():
    g = torch.Generator().manual_seed(3)
    kc, L, d, bq, nb, slots = 9, 40, 24, 4, 5, 12
    mask = (torch.rand(kc, L, generator=g) > 0.4).float()
    probes = torch.randint(-1, kc + 1, (nb, slots), generator=g, dtype=torch.int32)
    valid = mask.sum(dim=1)
    pairs = {(blk, int(c)) for blk in range(nb) for c in probes[blk] if 0 <= c < kc}
    probed = {c for _, c in pairs}
    rows_pairs = sum(int(valid[c]) for _, c in pairs)
    rows_probed = sum(int(valid[c]) for c in probed)
    nq = nb * bq
    rest = len(probed) * L * 4 + nq * d * 4 + nb * slots * 4 + nq * slots * L * 4
    assert kivf.cost(nq, d, L, probes, valid, block_q=bq) == \
        (2 * d * bq * rows_pairs, rows_probed * 4 * d + rest)
    assert kivfq.cost(nq, d, L, probes, valid, block_q=bq) == \
        (2 * d * bq * rows_pairs, rows_probed * (d + 4) + rest)


def test_kernel_bounds_at_the_table_shapes():
    """The bounds PERF.md's kernel table gives, from the one peaks table and
    the kernels' cost() (the data-dependent rows are printed on the card)."""
    p = roofline.PEAKS["H100 SXM"]

    def ms(cost, peak):
        return round(roofline.bound(cost[1], cost[0], hbm_bw=p.hbm_bw, peak=peak)[0], 4)
    assert ms(ksim.cost(256, 1_000_000, 384), p.fp32) == 2.9344
    assert ms(kfa.cost(32, 512, 512, 24, 8, 128), p.bf16) == 0.0801
    assert ms(krn.cost(16384, 3072), p.fp32) == 0.0601
    assert ms(kfa.backward_cost(2, 512, 512, 24, 8, 128), p.bf16) == 0.0100
    assert roofline.bound(1.0, 1e30, hbm_bw=p.hbm_bw, peak=p.bf16)[1] == "operations"


def test_kernel_hooks_charge_nothing_on_the_cpu():
    """On CPU tensors ``ops`` takes the plain versions: no launch, no charge."""
    from repro_torch.kernels import ops
    q = torch.randn(1, 8, 2, 16)
    costs = analyze(lambda a: ops.flash_attention(a, a, a), q)
    assert costs.kernels == {} and costs.flops > 0


# ---------------------------------------------------------------------------
# memory and scopes
# ---------------------------------------------------------------------------


def test_temp_of_a_chain_of_products():
    n = 64
    blk = n * n * 4

    def chain(a, w):
        x = a @ w           # live: x
        y = x @ w           # live: x, y (x dies after this line)
        del x
        z = y @ w           # live: y, z
        return z

    a, w = _meta(n, n), _meta(n, n)
    mem = analyze(chain, a, w).memory
    assert mem["argument"] == 2 * blk and mem["output"] == blk and mem["alias"] == 0
    assert mem["temp"] == blk                       # two live at the peak, one is the result
    assert mem["peak"] == mem["argument"] + 2 * blk
    returned = analyze(lambda a: a.mul_(2), a).memory
    assert returned["alias"] == blk and returned["peak"] == blk


def _train_costs(cfg):
    params = common.unflatten({p: _meta(*s.shape, dtype=s.dtype)
                               for p, s in registry.param_specs(cfg).items()})
    toks = _meta(2, 32, dtype=torch.int64)

    def step(params, toks):
        leaves = [t.detach().requires_grad_() for t in common.flatten(params).values()]
        tree = common.unflatten(dict(zip(common.flatten(params), leaves)))
        loss, _ = loss_fn(cfg, tree, toks, toks)
        return torch.autograd.grad(loss, leaves, allow_unused=True)

    fwd = analyze(lambda p, t: registry.forward(cfg, p, t)[0], params, toks)
    return fwd, analyze(step, params, toks)


@pytest.mark.parametrize("arch,scope", [("llama3.2-3b", "attn_core"),
                                        ("mixtral-8x22b", "moe_ffn"),
                                        ("zamba2-7b", "ssd_core")])
def test_scopes_hold_forward_and_backward(arch, scope):
    cfg = get_smoke(arch).with_(remat=False)
    fwd, train = _train_costs(cfg)
    f_fwd, f_train = fwd.scopes[scope][0], train.scopes[scope][0]
    assert f_fwd > 0
    if scope == "ssd_core":      # the zero initial state takes no gradient
        assert 2 * f_fwd < f_train <= 3 * f_fwd
    else:                        # each product's backward is two of its size
        assert f_train == 3 * f_fwd
    assert not scopes.ACTIVE and not scopes._regions and not scopes._stack


def test_scope_is_inert_without_a_counter():
    cfg = get_smoke("llama3.2-3b")
    params = registry.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.zeros((1, 8), dtype=torch.long)
    registry.forward(cfg, params, toks)
    assert not scopes._regions and not scopes._stack


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mixtral-8x22b", "zamba2-7b"])
def test_meta_trace_counts_what_a_real_run_executes(arch):
    """A dry-run cell traced on meta tensors and the same cell run on real
    tensors (here the CPU's plain paths) count the same ops: FLOPs, bytes,
    scopes and memory, exactly (what phase 21 holds on the card outside
    the kernels)."""
    cfg = get_smoke(arch).with_(num_layers=2)    # zamba2: two Mamba blocks, one shared
    for cell, mb in ((ShapeCell("t", 16, 2, "train"), 2), (ShapeCell("p", 16, 2, "prefill"), None),
                     (ShapeCell("d", 32, 3, "decode"), None)):
        runs = []
        for device in ("meta", "cpu"):
            traced, _ = dryrun.build_cell(arch, cell, None, microbatches=mb, cfg=cfg,
                                          device=device)
            runs.append(analyze(traced.fn, *traced.args))
        (m, c) = runs
        assert (m.flops, m.bytes, m.scopes, m.memory) == (c.flops, c.bytes, c.scopes, c.memory)


def test_kernel_charges_reach_the_counter_under_their_scope():
    from repro_torch.common.scopes import scoped
    from repro_torch.kernels import _build

    @scoped("attn_core")
    def launch(x):
        y = x * 2
        if _build.cost_counter is not None:     # what a wrapper does after its launch
            _build.cost_counter("flash_attention", lambda: (float(x.sum()), 64.0))
        return y

    costs = analyze(launch, torch.ones(4, 4))
    assert costs.kernels == {"flash_attention": [1, 16.0, 64.0]}   # x.sum() not counted
    assert costs.scopes["attn_core"] == [16.0, 64.0 + 2 * 64]      # the charge and x * 2
    assert _build.cost_counter is None and not scopes.ACTIVE


# ---------------------------------------------------------------------------
# dry run and hlo_debug
# ---------------------------------------------------------------------------


def test_dryrun_train_cell_on_a_fake_world_subprocess(tmp_path):
    code = f"""
        import json
        from repro_torch.launch import dryrun, hlo_analysis
        rec = dryrun.run_cell("llama3.2-3b", "train_4k", "single", {str(tmp_path)!r})
        dec = dryrun.run_cell("llama3.2-3b", "decode_32k", "single", {str(tmp_path)!r})
        traced, _ = dryrun.build_cell("llama3.2-3b", "train_4k", None)
        whole = hlo_analysis.analyze(traced.fn, *traced.args)
        print(json.dumps({{"rec": rec, "dec": dec, "whole": whole.flops}}))
    """
    env = dict(os.environ, PYTHONPATH=SRC, REPRO_DRYRUN_DEVICES="8")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    rec, whole = out["rec"], out["whole"]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["chips"] == 8 and rec["kind"] == "train" and rec["microbatches"] == 1
    rl = rec["roofline"]
    coll = rl["coll_breakdown"]
    assert coll.get("broadcast", 0) + coll.get("all-gather", 0) > 0, coll
    assert coll.get("all-reduce", 0) > 0, coll
    ratio = rl["hlo_flops_per_dev"] * 8 / whole
    print(f"per-device FLOPs x 8 / unsharded trace's: {ratio:.4f}")
    assert ratio >= 0.99, ratio
    assert rl["mem_per_dev"]["argument"] > 0 and rl["bottleneck"] in ("compute", "memory")
    assert json.loads((tmp_path / "llama3.2-3b__train_4k__single.json").read_text()) == rec
    # context-parallel decode: the caches are DTensors of this rank's shards
    # (1/8 of the whole), and DTensor's own fake tensors count nothing
    dec = out["dec"]
    assert dec["status"] == "ok", dec.get("traceback")
    mem = dec["roofline"]["mem_per_dev"]
    cfg = get_config("llama3.2-3b")
    cache = 2 * cfg.num_layers * 128 * 32768 * cfg.num_kv_heads * cfg.hd * 2
    params = cfg.param_count() * 2
    assert abs(mem["argument"] - (params + cache / 8)) < 1e-3 * mem["argument"], mem
    assert mem["temp"] < mem["argument"], mem         # the whole cache would be 8 x
    assert dec["roofline"]["coll_breakdown"]["all-reduce"] > 0


# the multi mesh's cells at smoke widths: train_4k's and decode_32k's kinds
# cut to a length every smoke config takes (whisper's learned positions stop
# at 128), with stacks that split over pod
MULTI_TRAIN = ShapeCell("train_cut", 64, 16, "train")
MULTI_DECODE = ShapeCell("decode_cut", 256, 16, "decode")


def _multi_cfg(arch: str):
    cfg = get_smoke(arch)
    return cfg.with_(num_layers=4) if cfg.num_layers == 3 else cfg


def test_dryrun_multi_mesh_cells_with_pod_cut_stacks_subprocess(tmp_path):
    """``--mesh multi`` on a fake (2, 2, 2) world: every arch's train cell
    (the sharded step over stacks the default rules cut over pod) and
    llama4's decode cell (context-parallel decode over cache stacks cut over
    pod, data and model) build and trace without an error (the cells that
    ``run_cell`` recorded as ``error`` before).  The decode cell's arguments
    are the whole params and 1/8 of the cache stacks."""
    archs = sorted(dryrun.ARCHS)
    mesh = shd.abstract_mesh((2, 2, 2), ("pod", "data", "model"))
    for arch in archs:        # each case is real: some stack is cut over pod
        specs = registry.param_specs(_multi_cfg(arch))
        assert any(s.axes[0] == "layers"
                   and shd.resolve_pspec(s.shape, s.axes, mesh, "default")[0] == "pod"
                   for s in specs.values()), arch
    dec = "llama4-maverick-400b-a17b"
    cache = registry.cache_specs(get_smoke(dec), MULTI_DECODE.global_batch,
                                 MULTI_DECODE.seq_len)
    assert all(shd.resolve_pspec(s.shape, s.axes, mesh, "default")[:3] == ("pod", "data", "model")
               for s in cache.values())
    code = f"""
        import json
        from repro_torch.configs import ShapeCell, get_smoke
        from repro_torch.launch import dryrun

        def cell(arch, shape):
            cfg = get_smoke(arch)
            cfg = cfg.with_(num_layers=4) if cfg.num_layers == 3 else cfg
            with dryrun.fake_world(8):
                mesh = dryrun.make_mesh("multi")
                traced, meta = dryrun.build_cell(arch, shape, mesh, cfg=cfg)
                rl, _ = dryrun.analyse_cell(traced, cfg, shape, arch=arch, shape=shape.name,
                                            mesh_name="multi", chips=8)
            return {{**meta, "roofline": rl.to_json()}}

        out = {{arch: cell(arch, {MULTI_TRAIN!r}) for arch in {archs!r}}}
        out["decode"] = cell({dec!r}, {MULTI_DECODE!r})
        print(json.dumps(out))
    """
    env = dict(os.environ, PYTHONPATH=SRC, REPRO_DRYRUN_DEVICES="8")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    for arch in archs:
        assert out[arch]["kind"] == "train" and out[arch]["rules"] == "default"
        assert out[arch]["roofline"]["coll_breakdown"].get("broadcast", 0) > 0, arch
    rec = out["decode"]
    assert rec["kind"] == "decode" and rec["rules"] == "default"
    mem = rec["roofline"]["mem_per_dev"]
    cfg = _multi_cfg(dec)
    whole = common.param_bytes(registry.param_specs(cfg)) + common.param_bytes(cache) / 8
    assert abs(mem["argument"] - whole) < 1e-3 * mem["argument"], (mem, whole)
    coll = rec["roofline"]["coll_breakdown"]
    assert coll.get("broadcast", 0) > 0 and coll.get("all-reduce", 0) > 0, coll


def test_dryrun_skipped_cell_carries_the_reference_reason(tmp_path):
    traced, meta = dryrun.build_cell("qwen2-72b", "long_500k", None)
    assert traced is None
    assert meta["skipped"] == jcell_applicable(jget_config("qwen2-72b"),
                                               JSHAPES["long_500k"])[1]
    assert dryrun.mesh_shape("single", 8) == ((2, 4), ("data", "model"))
    assert dryrun.mesh_shape("single", 256) == ((16, 16), ("data", "model"))
    assert dryrun.mesh_shape("multi", 512) == ((2, 16, 16), ("pod", "data", "model"))


def test_hlo_debug_top_contributors_of_a_smoke_step():
    cfg = get_smoke("llama3.2-3b")
    ocfg = opt.OptimizerConfig()
    params = registry.init_params(cfg, torch.Generator().manual_seed(0))
    state = opt.init_state(params, ocfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(1))
    step = make_train_step(cfg, ocfg, microbatches=2)
    costs = analyze(step, params, state, {"tokens": toks, "labels": toks}, rows=True)
    top, rows = hlo_debug.top_contributors(costs, 5)
    assert len(top) == 5 and len(rows) > 20
    assert [r[0] for r in top] == sorted((r[0] for r in top), reverse=True)
    assert sum(r[0] for r in rows) == costs.bytes and sum(r[1] for r in rows) == costs.flops
    assert any(r[4] == "attn_core" for r in rows)
    # the stacked layers' products: each layer's call counted, grouped by shapes
    assert max(r[2] for r in rows if r[3] == "bmm") >= cfg.num_layers
    mem = costs.memory
    assert mem["alias"] > 0 and mem["peak"] == mem["argument"] + mem["output"] \
        + mem["temp"] - mem["alias"]
    assert cfg.num_layers and get_config("llama3.2-3b").num_layers == 28
