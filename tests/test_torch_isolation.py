"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or the ``repro`` package, so the port runs
on a machine that has neither.  The guarded run imports every module of the
port and drives retrieval, the LLM oracle (predicate, LLM rerank), the
generate path (``EngineModel.generate``, ``sem_map``, ``sem_agg``, a paged
decode step), a lazy ``SemFrame`` pipeline through the plan layer
(filter -> join -> topk, optimized and collected), a ``Gateway`` session, a
``Subscription`` over a ``CorpusTable`` with one append, an ``Embedder``
forward, a smoke mixtral forward (MoE), a VLM decode step, two train steps
over ``packed_batch``, a checkpoint saved and loaded, ``resolve_pspec`` and
a context-parallel decode step in a one-rank gloo world, and a smoke train
step counted on meta tensors through the launch/ tooling (dry-run cell,
cost counter, roofline, hlo_debug rows, report table), on the CPU."""
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_GUARDED = textwrap.dedent("""
    import importlib, importlib.abc, pathlib, sys

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                raise ImportError(f"the port must not import {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    import repro_torch
    root = pathlib.Path(repro_torch.__file__).parent
    names = sorted("repro_torch." + ".".join(p.relative_to(root).with_suffix("").parts)
                   .removesuffix(".__init__") for p in root.rglob("*.py"))
    for name in names:
        importlib.import_module(name)
    repro_torch.set_device("cpu")
    from repro_torch.core.backends import synth
    from repro_torch.core.operators.search import sem_index, sem_search
    recs, world, _, _, emb = synth.make_filter_world(120, seed=2)
    texts = [r["claim"] for r in recs]
    for kind, kw in [("exact", {}), ("ivf", {"n_clusters": 4}),
                     ("ivf", {"n_clusters": 4, "quantize": "int8"})]:
        idx = sem_index(texts, emb, index=kind, **kw)
        hits, st = sem_search(idx, texts[7], emb, k=3)
        assert hits[0] == 7 and st["scored_vectors"] > 0, (hits, st)
    from repro_torch.configs import get_smoke
    from repro_torch.core.backends.torch_engine import EngineModel
    from repro_torch.data.tokenizer import TOKENIZER
    from repro_torch.engine.engine import InferenceEngine
    cfg = get_smoke("llama3.2-3b").with_(vocab_size=TOKENIZER.vocab_size,
                                         attn_impl="pallas")
    model = EngineModel(InferenceEngine(cfg, seed=0, max_seq=128))
    passes, scores = model.predicate(["The sky is blue.", "2 + 2 = 5"])
    assert passes.shape == (2,) and ((scores > 0) & (scores < 1)).all(), scores
    hits, st = sem_search(idx, texts[7], emb, k=4, n_rerank=2, rerank_model=model,
                          records=recs, rerank_langex="{claim}")
    assert len(hits) == 2 and st["reranked"] == 2, (hits, st)
    gen = EngineModel(InferenceEngine(cfg.with_(attn_impl="auto"), seed=0, max_slots=2,
                                      max_seq=128), max_new_tokens=5)
    texts = gen.generate(["one", "two", "three"])
    assert len(texts) == 3 and all(isinstance(t, str) for t in texts), texts
    assert gen.engine.stats.generated_tokens > 0, gen.engine.stats
    from repro_torch.core.operators.agg import sem_agg_hierarchical
    from repro_torch.core.operators.mapex import sem_map
    notes, st = sem_map(recs[:4], "a note on {claim}", gen)
    assert len(notes) == 4 and st["operator"] == "sem_map", (notes, st)
    summary, st = sem_agg_hierarchical(recs[:5], "summarize {claim}", gen, fanout=2)
    assert isinstance(summary, str) and st["depth"] == 3, st
    import numpy as np
    from repro_torch.engine import paged
    alloc = paged.PageAllocator(num_pages=4, page_size=4, max_slots=1, max_pages_per_slot=4)
    alloc.ensure(0, 1)
    logits, _ = paged.paged_decode_step(cfg, gen.engine.runner.params, np.zeros((1, 1)),
                                        paged.init_pages(cfg, 4, 4), alloc.table,
                                        np.zeros(1))
    assert logits.shape == (1, 1, cfg.vocab_size), logits.shape
    from repro_torch.core.frame import SemFrame, Session
    left, right, world, oracle, _, emb = synth.make_join_world(30, 12, seed=4)
    synth.add_phrase_predicate(world, left, "is checkable", 0.5, seed=4)
    lz = (SemFrame(left, Session(oracle=oracle, embedder=emb, sample_size=20)).lazy()
          .sem_filter("the {abstract} is checkable")
          .sem_join(right, "the {abstract} reports the {reaction:right}")
          .sem_topk("the {abstract} reports the highest accuracy", 3))
    plan = lz.explain(prefilter_threshold=100)
    rows = lz.collect(prefilter_threshold=100).records
    assert "inject_sim_prefilter" in plan and 0 < len(rows) <= 3, (plan, rows)
    from repro_torch.serve import Gateway
    from repro_torch.stream import CorpusTable
    sess = Session(oracle=oracle, embedder=emb, sample_size=20)
    with Gateway(sess, max_inflight=2) as gw:
        h = gw.submit(SemFrame(left, gw.session).lazy()
                      .sem_filter("the {abstract} is checkable"), tenant="a")
        served = h.result(timeout=60)
        assert h.status == "done" and 0 < len(served) < len(left), h.summary()
        table = CorpusTable(left[:20])
        sub = gw.subscribe(table.lazy(sess).sem_filter("the {abstract} is checkable"))
        em0 = sub.poll(timeout=60)
        table.append(left[20:])
        em1 = sub.poll(timeout=60)
        assert em0.error is None and em1.error is None, (em0, em1)
        assert (em0.version, em1.version) == (1, 2) and em1.records == served, em1
        sub.cancel()
    from repro_torch.embed.encoder import E5_SMALL, Embedder
    vecs = Embedder(E5_SMALL.with_(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                                   d_ff=128)).embed(["a claim", "another, longer claim"])
    assert vecs.shape == (2, 64) and np.allclose(np.linalg.norm(vecs, axis=1), 1.0, atol=1e-5)
    import torch
    from repro_torch.models import registry
    moe_cfg = get_smoke("mixtral-8x22b")
    moe_params = registry.init_params(moe_cfg, torch.Generator().manual_seed(0))
    logits, aux = registry.forward(moe_cfg, moe_params, torch.zeros((2, 12), dtype=torch.long))
    assert logits.shape == (2, 12, moe_cfg.vocab_size) and sorted(aux) == ["moe_lb", "moe_z"]
    vlm_cfg = get_smoke("llama-3.2-vision-11b")
    vlm_params = registry.init_params(vlm_cfg, torch.Generator().manual_seed(0))
    image = {"image_embeds": torch.randn(1, vlm_cfg.num_image_tokens, vlm_cfg.d_model)}
    cache = registry.init_cache(vlm_cfg, 1, 16)
    registry.prefill(vlm_cfg, vlm_params, torch.ones((1, 5), dtype=torch.long), cache,
                     extra=image)
    logits, _ = registry.decode_step(vlm_cfg, vlm_params, torch.ones((1, 1), dtype=torch.long),
                                     cache, 5)
    assert logits.shape == (1, 1, vlm_cfg.vocab_size) and bool(torch.isfinite(logits).all())
    import tempfile
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.data.pipeline import SyntheticSource, packed_batch
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainstep import make_train_step
    tcfg = get_smoke("llama3.2-3b").with_(vocab_size=TOKENIZER.vocab_size)
    tparams = registry.init_params(tcfg, torch.Generator().manual_seed(0))
    ocfg = opt.OptimizerConfig(warmup_steps=1, total_steps=2)
    state = opt.init_state(tparams, ocfg)
    step = make_train_step(tcfg, ocfg, microbatches=2)
    for s in range(2):
        b = packed_batch(SyntheticSource(seed=0), s, batch=2, seq_len=16)
        tparams, state, m = step(tparams, state, {k: torch.from_numpy(v) for k, v in b.items()})
        assert np.isfinite(float(m["loss"])), m
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 2, {"params": tparams, "opt_state": state})
        n, back = ckpt.load(d)
    wq = tparams["layers"]["attn"]["wq"]
    assert n == 2 and int(back["opt_state"]["step"]) == 2
    assert torch.equal(back["params"]["layers"]["attn"]["wq"].view(torch.int16),
                       wq.view(torch.int16))
    import torch.distributed as dist
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import attention as attn
    amesh = shd.abstract_mesh((2, 4), ("data", "model"))
    assert shd.resolve_pspec((1, 64, 8, 128), ("batch", "kv_seq", "kv_heads", "qkv"), amesh,
                             "default") == shd.P(None, ("data", "model"), None, None)
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", init_method=f"file://{d}/rdzv", world_size=1, rank=0)
        try:
            mesh = make_test_mesh((1, 1), ("data", "model"))
            ap = tparams["layers"]["attn"]
            ap = {k: v[0] for k, v in ap.items()}
            x = torch.randn(2, 1, tcfg.d_model)
            kc, vc = (torch.randn(2, 32, tcfg.num_kv_heads, tcfg.hd) for _ in range(2))
            lens = torch.tensor([5, 31], dtype=torch.int32)
            want, wk, _ = attn.decode_self_attention(ap, x, kc.clone(), vc.clone(), lens, cfg=tcfg)
            sh = shd.NamedSharding(mesh, shd.P("data", "model", None, None))
            kd, vd = sh.distribute(kc), sh.distribute(vc)
            with shd.activation_rules(mesh, "serve_replicated"):
                got, _, _ = attn.decode_self_attention(ap, x, kd, vd, lens,
                                                       cfg=tcfg.with_(decode_cp=True))
            assert torch.allclose(got, want, atol=1e-5) and torch.equal(kd.to_local(), wk)
        finally:
            dist.destroy_process_group()
    import json
    from repro_torch.configs import ShapeCell
    from repro_torch.launch import dryrun, hlo_analysis, hlo_debug, report, roofline
    cell = ShapeCell("train_64", 64, 2, "train")
    traced, meta = dryrun.build_cell("llama3.2-3b", cell, None, cfg=tcfg)
    costs = hlo_analysis.analyze(traced.fn, *traced.args, rows=True, flop_counter=True)
    rl = roofline.analyse(costs, arch="llama3.2-3b", shape=cell.name, mesh_name="single",
                          chips=1, model_flops=roofline.model_flops_for_cell(tcfg, cell),
                          seq_len=cell.seq_len)
    top, _ = hlo_debug.top_contributors(costs, 3)
    assert costs.flops == costs.memory["flop_counter_flops"] > 0 and len(top) == 3
    assert costs.scopes["attn_core"][0] > 0 and rl.bottleneck in ("compute", "memory")
    with tempfile.TemporaryDirectory() as d:
        with open(f"{d}/llama3.2-3b__train_64__single.json", "w") as f:
            json.dump({"arch": "llama3.2-3b", "shape": cell.name, "mesh": "single",
                       "status": "ok", "roofline": rl.to_json(), **meta}, f)
        assert "| single | llama3.2-3b | train_64 |" in report.build_table(d)
    assert not any(m.split(".")[0] in ("jax", "jaxlib", "repro") for m in sys.modules)
    print("modules", len(names))
""")


def test_port_imports_and_runs_with_jax_and_repro_refused():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", _GUARDED], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    n = int(out.stdout.split("modules")[-1])
    assert n >= 113         # every module of slices 1, 2a-2c, the plan and serving layers,
                            # the model families, training, the distribution layer and
                            # the launch/ tooling (dryrun, hlo_analysis, hlo_debug,
                            # roofline, report, common/scopes)


_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|repro)(?:[.\s,]|$)", re.M)


def test_no_source_of_the_port_names_jax_or_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert all(f.exists() for f in files)
    offenders = {str(f.relative_to(ROOT)): _IMPORT.findall(f.read_text())
                 for f in files}
    assert not {f: m for f, m in offenders.items() if m}
