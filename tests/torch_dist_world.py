"""One gloo world on the CPU for ``test_torch_dist.py``: every rank runs the
port's distribution layer on the inputs the test wrote and saves what it got.

    python tests/torch_dist_world.py WORKDIR [RANKS]

WORKDIR holds ``in/`` (a checkpoint in the reference's format: the inputs)
and, for the restore check, ``ref_ckpt/``.  Each rank writes
``out_<rank>/`` (the port's checkpoint format).  Every check shares the one
world of RANKS (8) processes; each builds the mesh it needs over it, the
pod checks a (2, 2, 2) ("pod", "data", "model") mesh.
"""
from __future__ import annotations

import datetime
import os
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import repro_torch  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.common import flatten, unflatten  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.data.tokenizer import TOKENIZER  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import registry  # noqa: E402

CP_CASES = {"default": {}, "window": {"sliding_window": 16}, "batch1": {}}


def cp_decode(inp, mesh) -> dict:
    """``decode_self_attention`` with ``decode_cp`` under the default rules:
    this rank's batch rows and cache shards in, the whole out and caches
    (gathered) back."""
    out = {}
    for name, over in CP_CASES.items():
        case = inp[f"cp_{name}"]
        cfg = get_smoke("llama3.2-3b").with_(decode_cp=True, **over)
        kc, vc = case["kc"], case["vc"]
        spec = shd.resolve_pspec(tuple(kc.shape), ("batch", "kv_seq", "kv_heads", "qkv"),
                                 mesh, "default")
        cache_sh = shd.NamedSharding(mesh, shd.P(spec[0], spec[1], None, None))
        rows_sh = shd.NamedSharding(mesh, shd.P(spec[0], None, None))
        rows = rows_sh.local_slices(case["x"].shape)[0]
        kd, vd = cache_sh.distribute(kc), cache_sh.distribute(vc)
        with shd.activation_rules(mesh, "default"):
            o, k2, v2 = A.decode_self_attention(case["params"], case["x"][rows], kd, vd,
                                                case["lens"][rows], cfg=cfg)
        assert k2 is kd and v2 is vd
        out[name] = {"out": rows_sh.gather(o), "k": cache_sh.gather(kd.to_local()),
                     "v": cache_sh.gather(vd.to_local()),
                     "local_shape": torch.tensor(kd.to_local().shape),
                     "spec_seq": torch.tensor(len(shd.entry_axes(spec[1])))}
    return out


def moe(inp, mesh) -> dict:
    """``moe_ffn`` under rules on this mesh (so ``moe_ffn_sharded``): this
    rank's rows of x in, the whole y (gathered) and the aux losses back."""
    cfg = get_smoke("mixtral-8x22b")
    x = inp["moe"]["x"]
    rows_sh = shd.NamedSharding(mesh, shd.P("data", None, None))
    rows = rows_sh.local_slices(x.shape)[0]
    with shd.activation_rules(mesh, "default"):
        y, aux = M.moe_ffn(inp["moe"]["params"], x[rows], cfg=cfg)
    return {"y": rows_sh.gather(y), "lb": aux["moe_lb"], "z": aux["moe_z"]}


def pipeline(inp, mesh) -> dict:
    from repro_torch.dist.pipeline_parallel import make_pp_loss, pp_forward
    cfg = get_smoke("llama3.2-3b").with_(vocab_size=TOKENIZER.vocab_size, num_layers=4)
    p = inp["pp"]
    logits = pp_forward(cfg, mesh, p["params"], p["tokens"], n_micro=4)
    flat = flatten(p["params"])
    leaves = {k: v.detach().requires_grad_() for k, v in flat.items()}
    loss = make_pp_loss(cfg, mesh, n_micro=4)(unflatten(leaves), p["tokens"], p["labels"])
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return {"logits": logits, "loss": loss.detach(),
            "grads": unflatten(dict(zip(leaves, grads)))}


TRAIN_CFGS = {"llama3.2-3b": dict(vocab_size=384, d_model=64, d_ff=128),
              "mixtral-8x22b": dict(vocab_size=384)}


# the (2, 2, 2) ("pod", "data", "model") mesh's configs: stacks that split by 2
POD_TRAIN_CFGS = {"llama3.2-3b": dict(TRAIN_CFGS["llama3.2-3b"], num_layers=4),
                  "mixtral-8x22b": TRAIN_CFGS["mixtral-8x22b"]}


def train_step(inp, mesh, name: str, key: str = "train", cfgs=TRAIN_CFGS) -> dict:
    from repro_torch.dist.trainstep import make_sharded_train_step
    from repro_torch.train import optimizer as opt
    t = inp[f"{key}_{name}"]
    cfg = get_smoke(name).with_(**cfgs[name])
    ocfg = opt.OptimizerConfig(total_steps=2, warmup_steps=0)
    pspecs = registry.param_specs(cfg)
    psh = shd.spec_shardings(pspecs, mesh)
    ssh = shd.spec_shardings(opt.state_specs(pspecs, ocfg), mesh)
    params = shd.place_tree(t["params"], psh)
    state = shd.place_tree(t["state"], ssh)
    step = make_sharded_train_step(cfg, ocfg, mesh)
    params, state, m = step(params, state, {"tokens": t["tokens"], "labels": t["labels"]})
    return {"params": shd.gather_tree(params, psh), "state": shd.gather_tree(state, ssh),
            "local": params, "loss": m["loss"], "grad_norm": m["grad_norm"]}


def train_step_unsummed(inp, mesh, name: str) -> dict:
    """A planted fault: the sharded step with each gradient kept unsummed
    over the batch axes (its own batch slice's only), to show that the
    test's bounds see it."""
    from repro_torch.dist import trainstep
    real = trainstep._grad_shard
    trainstep._grad_shard = lambda g, mesh, dp, slices: g.float()[slices]
    try:
        return train_step(inp, mesh, name)
    finally:
        trainstep._grad_shard = real


def pod_train_step(inp, mesh, name: str) -> dict:
    return train_step(inp, mesh, name, "pod_train", POD_TRAIN_CFGS)


def pod_train_step_wrong_pod(inp, mesh, name: str) -> dict:
    """A planted fault: the sharded step on the pod mesh reading each layer
    from the other pod (the layer at the same slot there)."""
    from repro_torch.dist import trainstep
    real = trainstep._owner
    trainstep._owner = lambda i, per: (i // per + 1) % 2
    try:
        return pod_train_step(inp, mesh, name)
    finally:
        trainstep._owner = real


def pod_decode(inp, mesh) -> dict:
    """``registry.decode_step`` of llama4's smoke config with ``decode_cp``
    under the default rules on the pod mesh: each cache stack a ``DTensor``
    cut over layers (pod), batch (data) and sequence (model), x this rank's
    rows of the attention's spec; the logits and the stacks gathered back."""
    d = inp["pod_decode"]
    cfg = get_smoke("llama4-maverick-400b-a17b").with_(decode_cp=True)
    whole = flatten(d["cache"])
    specs = registry.cache_specs(cfg, *whole[("dense", "k")].shape[1:3])
    rows_sh = shd.NamedSharding(mesh, shd.resolve_pspec(d["tokens"].shape, ("batch", None),
                                                        mesh, "default"))
    rows = rows_sh.local_slices(d["tokens"].shape)[0]
    cache_sh = {p: shd.NamedSharding(mesh, shd.resolve_pspec(s.shape, s.axes, mesh, "default"))
                for p, s in specs.items()}
    cache = unflatten({p: cache_sh[p].distribute(whole[p]) for p in specs})
    with shd.activation_rules(mesh, "default"):
        logits, cache = registry.decode_step(cfg, d["params"], d["tokens"][rows], cache,
                                             d["lens"][rows])
    lay = flatten(cache)
    return {"logits": shd.NamedSharding(mesh, shd.P(rows_sh.spec[0], None, None)).gather(logits),
            "cache": unflatten({p: cache_sh[p].gather(t.to_local()) for p, t in lay.items()}),
            "specs": {"/".join(p): torch.tensor([len(shd.entry_axes(e)) for e in sh.spec])
                      for p, sh in cache_sh.items()},
            "local": {"/".join(p): torch.tensor(t.to_local().shape) for p, t in lay.items()}}


def restore(root, mesh) -> dict:
    sh = {"params": {"w": shd.NamedSharding(mesh, shd.P("data", "model")),
                     "b": shd.NamedSharding(mesh, shd.P(None, ("data", "model")))}}
    step, out = ckpt.restore_sharded(os.path.join(root, "ref_ckpt"), sh)
    return {"step": torch.tensor(step), **out["params"]}


def rank_main(rank: int, world: int, root: str) -> None:
    torch.set_num_threads(1)
    repro_torch.set_device("cpu")
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(root, 'rdzv')}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        _, inp = ckpt.load(os.path.join(root, "in"))
        dm = make_test_mesh((2, 4), ("data", "model"))
        res = {"cp": cp_decode(inp, dm), "moe_2x4": moe(inp, dm),
               **{f"train_{n}": train_step(inp, dm, n) for n in TRAIN_CFGS},
               **{f"unsummed_{n}": train_step_unsummed(inp, dm, n) for n in TRAIN_CFGS},
               "restore": restore(root, dm),
               "moe_4x2": moe(inp, make_test_mesh((4, 2), ("data", "model"))),
               "moe_1x8": moe(inp, make_test_mesh((1, 8), ("data", "model"))),
               "pp": pipeline(inp, make_test_mesh((2, 4), ("pod", "data")))}
        pm = make_test_mesh((2, 2, 2), ("pod", "data", "model"))
        res.update({"pod_decode": pod_decode(inp, pm),
                    **{f"pod_train_{n}": pod_train_step(inp, pm, n) for n in POD_TRAIN_CFGS},
                    **{f"wrong_pod_{n}": pod_train_step_wrong_pod(inp, pm, n)
                       for n in POD_TRAIN_CFGS}})
        ckpt.save(os.path.join(root, f"out_{rank}"), 0, res)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    root = os.path.abspath(sys.argv[1])
    world = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    mp.start_processes(rank_main, args=(world, root), nprocs=world, start_method="spawn")
