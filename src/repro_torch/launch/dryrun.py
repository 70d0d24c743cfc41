"""Multi-pod dry run: trace every (arch x shape x mesh) cell's real step on
meta tensors and count its costs.

For each cell this builds the real step (the train step with its AdamW
update, or serve prefill / decode against a full-size KV cache), with
``meta`` stand-ins for every input, parameter, optimizer state and cache (no
allocation: a 400B-param tree never reaches host memory), runs it once as
rank 0 of a fake process group of the mesh's size (``torch.distributed``'s
``fake`` backend: collectives return at once and carry no data), and
records the cost counter's FLOPs, bytes, collectives and memory
(``launch/hlo_analysis.py``) with the roofline terms (``launch/roofline.py``)
into a JSON artifact per cell, which ``launch/report.py`` renders.  Where the
reference lowers and compiles each cell for its mesh, the port executes the
step op by op; the ops are those the card would run.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single --arch qwen2-72b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

``main`` runs each cell in a process of its own.  The world has 256 ranks
for ``single`` ((16, 16) over ("data", "model")) and
512 for ``multi`` ((2, 16, 16) over ("pod", "data", "model")), or
``REPRO_DRYRUN_DEVICES`` ranks for a small local run (``single``: (n / m, m)
with m = 2 ** ceil(log2(n) / 2); ``multi``: a pod axis of 2 before that).

What each cell runs, per rank:

  * train: the sharded train step (``dist/trainstep.make_sharded_train_step``:
    this rank's shards of params and AdamW state under the ``"default"``
    rules, layers gathered at use, gradients summed over the batch axes) at
    one microbatch; with no mesh, ``train/trainstep.make_train_step`` with
    the microbatch default.  ``OPT_OVERRIDES`` are the reference's.
  * prefill: ``registry.prefill(..., last_only=True)`` of this rank's batch
    rows against a full-size cache of them; the weights whole on every rank
    (the port's serving path holds whole weights per card).
  * decode: ``registry.decode_step`` with ``decode_cp=True``: under a mesh
    with a ``model`` axis the caches are ``DTensor``s sharded over batch
    and ``kv_seq`` (context-parallel decode), and over their layers where
    the rules cut them (llama4's ``"default"`` serving rules on the multi
    mesh: ``layers -> pod``); x holds this rank's rows of the attention's
    batch spec.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch import common
from repro_torch.configs import ARCHS, SHAPES, ShapeCell, cell_applicable, get_config, input_specs
from repro_torch.dist import sharding as shd
from repro_torch.launch import hlo_analysis, roofline
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.models import registry
from repro_torch.train import optimizer as opt

# Per-arch dry-run knobs, the reference's.  Default is NO gradient
# accumulation (the sharded step takes one microbatch).
TRAIN_MICROBATCHES: dict[str, int] = {}
DEFAULT_MICROBATCHES = 1
# 400B + f32 Adam: bf16 moments, no master (the reference's documented deviation).
OPT_OVERRIDES = {
    "llama4-maverick-400b-a17b": dict(state_dtype="bfloat16", use_master=False),
}
SERVE_RULES = {  # weights-replicated-over-data serving for <=72B; FSDP rules for 400B
    "llama4-maverick-400b-a17b": "default",
}
DEFAULT_OUT = "artifacts/dryrun_torch"


@dataclasses.dataclass
class Traced:
    """A cell's step and the inputs it is called with."""
    fn: Callable
    args: tuple

    def run(self):
        return self.fn(*self.args)


def world_size(mesh_name: str) -> int:
    n = os.environ.get("REPRO_DRYRUN_DEVICES")
    return int(n) if n else (512 if mesh_name == "multi" else 256)


def mesh_shape(mesh_name: str, n: int) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """The (shape, axes) of the ``single`` or ``multi`` mesh over ``n`` ranks."""
    pods = 2 if mesh_name == "multi" else 1
    per = n // pods
    m = 2 ** math.ceil(math.log2(per) / 2) if per > 1 else 1
    if pods * (per // m) * m != n:
        raise ValueError(f"{n} ranks do not make a {mesh_name} mesh")
    if mesh_name == "multi":
        return (2, per // m, m), ("pod", "data", "model")
    return (per // m, m), ("data", "model")


@contextlib.contextmanager
def fake_world(n: int):
    """A process group of ``n`` ranks in this process, as rank 0, over
    torch's ``fake`` backend; torn down on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_mesh(mesh_name: str):
    """The ``mesh_name`` mesh over the initialized world, of device type
    ``"cpu"`` (its tensors stay on meta)."""
    n = dist.get_world_size()
    if n == (512 if mesh_name == "multi" else 256):
        return make_production_mesh(multi_pod=mesh_name == "multi", device_type="cpu")
    shape, axes = mesh_shape(mesh_name, n)
    return make_test_mesh(shape, axes, device_type="cpu")


def _chips(mesh) -> int:
    return 1 if mesh is None else mesh.size()


def _tensors(specs: dict, device, generator=None, shardings=None) -> dict:
    """A nested tree of a spec table's tensors on ``device``: ``meta``
    stand-ins, or drawn from ``generator`` by each spec's initializer (zeros
    without one); with ``shardings`` (a flat {path: NamedSharding}) each rank's shard."""
    out = {}
    for path, s in specs.items():
        shape = s.shape if shardings is None else shardings[path].shard_shape(s.shape)
        if str(device) == "meta":
            out[path] = torch.empty(shape, dtype=s.dtype, device=device)
        elif generator is None:
            out[path] = torch.zeros(shape, dtype=s.dtype, device=device)
        else:
            out[path] = dataclasses.replace(s, shape=tuple(shape)).materialize(generator)
    return common.unflatten(out)


def _inputs(cfg, cell: ShapeCell, device, generator, rows=None) -> dict:
    """The cell's model inputs on ``device`` (``input_specs`` shapes); with
    ``rows`` the batch rows of this rank."""
    specs = input_specs(cfg, cell)
    out = {}
    for name, t in specs.items():
        shape = list(t.shape)
        if rows is not None and shape:
            shape[0] = len(range(*rows.indices(shape[0])))
        if str(device) == "meta":
            out[name] = torch.empty(shape, dtype=t.dtype, device="meta")
        elif name == "cache_len":
            out[name] = torch.full(shape, cell.seq_len - 1, dtype=t.dtype, device=device)
        elif t.dtype == torch.int32:
            out[name] = torch.randint(0, cfg.vocab_size, shape, generator=generator,
                                      dtype=t.dtype, device=device)
        else:
            out[name] = torch.randn(shape, generator=generator, device=device).to(t.dtype)
    return out


def build_cell(arch: str, shape, mesh, *, rules: str | None = None,
               microbatches: int | None = None, cfg=None, device="meta", seed: int = 0):
    """Returns (Traced, meta) for one (arch x shape) on ``mesh`` (None: one
    device), or (None, {"skipped": reason}).  ``shape`` is a ``SHAPES`` name
    or a ``ShapeCell``; ``cfg`` replaces the catalog config; ``device`` other
    than ``meta`` draws the inputs there from ``seed`` (one device only)."""
    cfg = cfg or get_config(arch)
    cell = SHAPES[shape] if isinstance(shape, str) else shape
    ok, why = cell_applicable(cfg, cell)
    if not ok:
        return None, {"skipped": why}
    if mesh is not None and str(device) != "meta":
        raise ValueError("a mesh cell is traced on meta tensors only")
    gen = None if str(device) == "meta" else \
        torch.Generator(device=device).manual_seed(seed)
    pspecs = registry.param_specs(cfg)
    t0 = time.time()
    ospecs = None
    if cell.kind == "train":
        rules = rules or "default"
        opt_cfg = opt.OptimizerConfig(**OPT_OVERRIDES.get(arch, {}))
        ospecs = opt.state_specs(pspecs, opt_cfg)
        mb = microbatches or TRAIN_MICROBATCHES.get(arch, DEFAULT_MICROBATCHES)
        batch = _inputs(cfg, cell, device, gen)
        if mesh is None:
            from repro_torch.train.trainstep import make_train_step
            step = make_train_step(cfg, opt_cfg, microbatches=mb)
            params = _tensors(pspecs, device, gen)
            state = opt.init_state(params, opt_cfg)
        else:
            if mb != 1:
                raise NotImplementedError("the sharded train step takes one microbatch")
            from repro_torch.dist.trainstep import make_sharded_train_step
            step = make_sharded_train_step(cfg, opt_cfg, mesh)
            params = _tensors(pspecs, device, shardings=common.flatten(
                shd.spec_shardings(pspecs, mesh, rules)))
            state = _tensors(ospecs, device, shardings=common.flatten(
                shd.spec_shardings(ospecs, mesh, rules)))
        traced = Traced(step, (params, state, batch))
        meta = {"kind": "train", "microbatches": mb, "rules": rules}

    elif cell.kind == "prefill":
        rules = rules or SERVE_RULES.get(arch, "serve_replicated")
        rows = _batch_rows(cell, mesh, rules)
        b = cell.global_batch if rows is None else len(range(*rows.indices(cell.global_batch)))
        cspecs = registry.cache_specs(cfg, b, cell.seq_len)
        params = _tensors(pspecs, device, gen)
        cache = _tensors(cspecs, device)
        ins = _inputs(cfg, cell, device, gen, rows)
        extra = {k: v for k, v in ins.items() if k != "tokens"} or None

        def serve_prefill(params, tokens, cache, extra):
            with _rules(mesh, rules):
                logits, cache = registry.prefill(cfg, params, tokens, cache, extra=extra,
                                                 last_only=True)
            return logits[:, 0].to(torch.float32), cache

        traced = Traced(serve_prefill, (params, ins["tokens"], cache, extra))
        meta = {"kind": "prefill", "rules": rules}

    else:  # decode
        rules = rules or SERVE_RULES.get(arch, "serve_replicated")
        cfg = cfg.with_(decode_cp=True)  # context-parallel decode under a model axis
        cspecs = registry.cache_specs(cfg, cell.global_batch, cell.seq_len)
        rows = _batch_rows(cell, mesh, rules)
        params = _tensors(pspecs, device, gen)
        ins = _inputs(cfg, cell, device, gen, rows)
        cache = _cache(cspecs, mesh, rules, rows, device)

        def serve_step(params, tokens, cache, cache_len):
            with _rules(mesh, rules):
                logits, cache = registry.decode_step(cfg, params, tokens, cache, cache_len)
            return logits[:, 0].to(torch.float32), cache

        traced = Traced(serve_step, (params, ins["tokens"], cache, ins["cache_len"]))
        meta = {"kind": "decode", "rules": rules}

    meta["build_s"] = time.time() - t0
    meta["param_count"] = common.param_count(pspecs)
    meta["active_param_count"] = cfg.active_param_count()
    # analytic lower bound on per-device HBM traffic for one step (the
    # roofline floor: weights/caches/optimizer state each touched once-ish)
    chips = _chips(mesh)
    pbytes = common.param_bytes(pspecs)
    if cell.kind == "train":
        obytes = common.param_bytes(ospecs)
        act = cell.global_batch * cell.seq_len * cfg.d_model * 2 * max(cfg.num_layers, 1)
        ideal = 3 * pbytes + 2 * obytes + act  # fwd+remat+bwd reads, opt rw, residuals
    else:
        cbytes = common.param_bytes(registry.cache_specs(cfg, cell.global_batch, cell.seq_len))
        ideal = pbytes + cbytes
    meta["ideal_bytes_per_dev"] = ideal / chips
    return traced, meta


def _rules(mesh, rules):
    return shd.activation_rules(mesh, rules) if mesh is not None else contextlib.nullcontext()


def _batch_rows(cell: ShapeCell, mesh, rules) -> slice | None:
    """This rank's batch rows under ``rules`` (None: every row)."""
    if mesh is None:
        return None
    spec = shd.resolve_pspec((cell.global_batch, 1), ("batch", None), mesh, rules)
    return shd.NamedSharding(mesh, spec).local_slices((cell.global_batch, 1))[0]


def _cache(cspecs, mesh, rules, rows: slice | None, device) -> dict:
    """The decode cache: whole on one device.  Under a mesh with a ``model``
    axis the self-attention K/V stacks (the entries over ``kv_seq``) are
    this rank's shards as ``DTensor``s, cut over layers, batch and sequence
    as the rules resolve the stack (context-parallel decode); every other
    entry (cross-attention memories, recurrent states) holds this rank's
    batch ``rows``."""
    if mesh is None:
        return _tensors(cspecs, device)
    cp = "model" in shd.axis_names(mesh)
    out = {}
    for path, sh in common.flatten(shd.spec_shardings(cspecs, mesh, rules)).items():
        s = cspecs[path]
        if cp and "kv_seq" in s.axes and path[0] != "cross":
            local = torch.empty(sh.shard_shape(s.shape), dtype=s.dtype, device=device)
            out[path] = sh.dtensor(local, s.shape)
            continue
        shape = list(s.shape)
        if "batch" in s.axes:
            d = s.axes.index("batch")
            shape[d] = len(range(*rows.indices(shape[d])))
        out[path] = torch.empty(shape, dtype=s.dtype, device=device)
    return common.unflatten(out)


def analyse_cell(traced: Traced, cfg, cell: ShapeCell, *, arch: str, shape: str,
                 mesh_name: str, chips: int) -> tuple[roofline.Roofline, hlo_analysis.Costs]:
    """Count one run of ``traced`` and derive its roofline."""
    costs = hlo_analysis.analyze(traced.fn, *traced.args, flop_counter=True)
    rl = roofline.analyse(costs, arch=arch, shape=shape, mesh_name=mesh_name, chips=chips,
                          model_flops=roofline.model_flops_for_cell(cfg, cell),
                          seq_len=cell.seq_len)
    return rl, costs


def run_cell(arch: str, shape: str, mesh_name: str, out_dir: str, *,
             rules: str | None = None, microbatches: int | None = None) -> dict:
    n = world_size(mesh_name)
    cfg = get_config(arch)
    cell = SHAPES[shape]
    rec: dict = {"arch": arch, "shape": shape, "mesh": mesh_name, "chips": n}
    try:
        with fake_world(n):
            mesh = make_mesh(mesh_name)
            traced, meta = build_cell(arch, shape, mesh, rules=rules,
                                      microbatches=microbatches)
            rec.update(meta)
            if traced is None:
                rec["status"] = "skipped"
            else:
                t0 = time.time()
                rl, _ = analyse_cell(traced, cfg, cell, arch=arch, shape=shape,
                                     mesh_name=mesh_name, chips=n)
                rec["trace_s"] = time.time() - t0
                rec["roofline"] = rl.to_json()
                rec["status"] = "ok"
            del traced
    except Exception as e:  # noqa: BLE001 - recorded as a failing cell
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape}__{mesh_name}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--rules", default=None)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--save-hlo", action="store_true",
                    help="also write each cell's grouped op rows (hlo_debug's) as .ops.json")
    ap.add_argument("--skip-done", action="store_true")
    args = ap.parse_args()

    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if not args.all and not args.arch:
        ap.error("pass --arch/--shape or --all")

    n_ok = n_skip = n_err = 0
    for mesh_name in meshes:
        for arch in archs:
            for shape in shapes:
                path = os.path.join(args.out, f"{arch}__{shape}__{mesh_name}.json")
                if args.skip_done and os.path.exists(path):
                    with open(path) as f:
                        if json.load(f).get("status") in ("ok", "skipped"):
                            continue
                t0 = time.time()
                rec = _run_cell_apart(arch, shape, mesh_name, args)
                status = rec["status"]
                n_ok += status == "ok"
                n_skip += status == "skipped"
                n_err += status == "error"
                extra = ""
                if status == "ok":
                    r = rec["roofline"]
                    extra = (f"bottleneck={r['bottleneck']} step={r['step_time_s']:.4g}s "
                             f"mfu={r['mfu']:.3f}")
                elif status == "error":
                    extra = rec["error"][:120]
                print(f"[dryrun] {mesh_name:6s} {arch:26s} {shape:12s} {status:8s} "
                      f"({time.time()-t0:.1f}s) {extra}", flush=True)
    print(f"[dryrun] done ok={n_ok} skipped={n_skip} errors={n_err}", flush=True)


CELL_STACK = 1 << 30   # bytes of stack for a cell's thread (below)


def _cell_child(arch: str, shape: str, mesh_name: str, args) -> None:
    """One cell in its process, on a thread with a stack of CELL_STACK: the
    backward of xlstm's sLSTM token loop at 4,096 tokens recurses deeper
    than a main thread's 8 MB allow."""
    import threading

    def cell():
        rec = run_cell(arch, shape, mesh_name, args.out, rules=args.rules,
                       microbatches=args.microbatches)
        if args.save_hlo and rec["status"] == "ok":
            _save_rows(arch, shape, mesh_name, args)

    threading.stack_size(CELL_STACK)
    t = threading.Thread(target=cell)
    t.start()
    t.join()


def _run_cell_apart(arch: str, shape: str, mesh_name: str, args) -> dict:
    """``run_cell`` in a process of its own (:func:`_cell_child`): a world
    and a trace per process, and a trace that kills its process ends as an
    ``error`` cell, not the run."""
    import multiprocessing
    path = os.path.join(args.out, f"{arch}__{shape}__{mesh_name}.json")
    if os.path.exists(path):
        os.remove(path)
    p = multiprocessing.get_context("spawn").Process(
        target=_cell_child, args=(arch, shape, mesh_name, args))
    p.start()
    p.join()
    if p.exitcode == 0 and os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "chips": world_size(mesh_name),
           "status": "error", "error": f"the cell's process ended with exit code {p.exitcode}"}
    os.makedirs(args.out, exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def _save_rows(arch: str, shape: str, mesh_name: str, args) -> None:
    """The cell's grouped op rows (the port's counterpart of saving the HLO
    text), from a second trace."""
    from repro_torch.launch.hlo_debug import cell_rows
    rows = cell_rows(arch, shape, mesh_name, rules=args.rules, microbatches=args.microbatches)
    with open(os.path.join(args.out, f"{arch}__{shape}__{mesh_name}.ops.json"), "w") as f:
        json.dump(rows, f, indent=0)


if __name__ == "__main__":
    main()
