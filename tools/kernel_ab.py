"""Time the hand-written kernels of several source trees in turns on one
CUDA card, each beside its PyTorch library call.

    python3 tools/kernel_ab.py TREE [TREE ...] [--rounds N] [--seed N]
                               [--groups retrieval,model,attention]

A TREE is the root of a checkout of this repository (its ``src/`` holds
``repro_torch``); to compare a variant, unpack a copy of the tree
(``git archive``) into an ignored directory and edit it there.
Each tree is measured in a process of its own (two trees of one package
cannot share one), in the order A B B A A B ... over ``--rounds`` rounds,
so that a drift of the card's clocks reaches every tree; each builds the
kernel libraries it times into its own ``build/kernels/`` first.

Group ``retrieval``: the three retrieval kernels at ``chip_smoke.py``'s
phase-3 shapes, on the same data.  The corpus is ``chip_smoke.make_corpus``'s
mixture drawn the same way from ``--seed`` (1,000,000 x 384 fp32 unit rows
around 1000 unit centres, noise 0.04 per coordinate, then 256 queries), and
the IVF store is built from it by the tree's own ``IVFIndex(n_clusters=256,
nprobe=8)``, whose seeded host k-means gives the smoke's store (kc 256, L
7040 at seed 0), mask and centroids; the int8 tiles are ``quantize_tiles``
of that store, as ``IVFIndex(quantize="int8")`` makes them.  The probes are
``ivf_probes`` of the unitized, block-padded queries (32 blocks x 64 slots).
``similarity`` q [256,384] x c [1M,384] (and q [1,384], ``sem_search``'s
shape) runs against ``F.normalize`` + ``matmul``; ``cluster_scan`` and
``cluster_scan_q`` against one gathered ``einsum`` over the whole batch, and
again at ``sem_search``'s shape (one query, padded to one block of 8 by
edge replication as ``ivf_search`` pads it: probes [1, 64], 8 distinct
clusters).
Bounds (every group): the kernel's ``cost()`` at the row's shapes and data,
computed by the checkout that runs this script (whichever tree a child
measures), over the card's datasheet peaks (``repro_torch.launch.roofline
.PEAKS``, by the SKU in the card's name): the larger of the bytes each
input read once and each output written once (for the scans, the valid
rows and the mask of the distinct probed clusters, the queries, the probe
ids and the output plane) over the memory rate, and the operations over
the fp32 SIMT peak (retrieval, ``rmsnorm``) or the bf16 tensor cores' (the
attention kernels; for the scans, the valid rows of each distinct (query
block, cluster) pair against the block's 8 queries: a block that probed a
cluster from several slots needs its scores once).

Group ``model``: ``decode_attention`` at q [32,1,24,128], k/v
[32,1024,8,128] with random lens (f32 and bf16, against SDPA with a bool
mask and GQA; bf16 also with every lens at S - 1), ``rmsnorm`` at x
[16384, 3072] bf16 (against ``F.rms_norm``), and ``x.clone()`` of that x, a
copy of the same bytes (``chip_smoke.py``'s phases 7 and 9).  Besides,
``decode_attention`` bf16 at small batches, where ``chunk_for`` decides
whether a row's keys split into several chunks: the engine's default 8
slots at S 1024 (random lens and lens S - 1), the paged phase's 8 rows of
128 positions, and 2 rows of 4096.

Group ``attention``: the bf16 ``flash_attention`` forward and its backward
(``flash_attention_bwd``) at the training shape (q [2,512,24,128], k/v
[2,512,8,128], causal: ``chip_smoke.py``'s phase 19) and at the oracle's
forward shape (q [32,512,24,128], k/v [32,512,8,128], causal: phase 7),
the forward against cuDNN SDPA's forward and the backward against one
``torch.autograd.grad`` over SDPA's graph (GQA).  The forward is timed as
inference launches it (no statistics) and as the training path does (with
the row statistics the backward reads, where the tree's kernel saves them);
the backward of a tree whose bf16 backward reads no statistics is called
without them.  Bounds as above: the unmasked products (2 in the forward, 5
in the backward) at the bf16 tensor cores' peak; errors: the largest
|kernel - plain| / (1 + |plain|) against the tree's plain versions.  A row
beyond its limit (forward 2e-2, backward 5e-2, as ``chip_smoke.py`` holds
them), or a backward that gives other bits on a second call, is marked
``DISAGREES``.  The backward's rows also print each of its kernels' time.

Times are profiler device time per call (every kernel a call launches,
the cluster scans' probe inversion included).  Prints the card's name and
power limit, then one line per tree and kernel (median kernel ms, library
ms, the ratio of each of the tree's runs, GB/s, TFLOP/s, the bound and its
share), and exits non-zero if a kernel disagrees with its plain version or
the profiler keeps no record of a timing.  A retrieval kernel that
disagrees is still timed and its line printed with ``DISAGREES``, so a
variant tree that leaves out part of a kernel's work (an ablation) can be
read; the run then exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUPS = {"retrieval": ("similarity", "ivf_scan", "ivf_scan_q"),
          "model": ("rmsnorm", "decode_attention"),
          "attention": ("flash_attention", "flash_attention_bwd")}
MASKED_SCORE = -1e30
RETRIEVAL = ("similarity", "similarity, one query", "cluster_scan", "cluster_scan_q",
             "cluster_scan, one query", "cluster_scan_q, one query")


# A copy of chip_smoke.device_ms, not an import of it: chip_smoke puts the
# checkout's own src/ first on sys.path, so importing it here would load
# that tree's repro_torch instead of the one this child measures.
def device_ms(torch, fn, reps: int, tries: int = 3) -> float:
    """Device time of one call of ``fn``: the profiler's kernel records of
    ``reps`` calls, each record name at its mean duration times its
    launches per call; a window that kept no record is profiled again, and
    after ``tries`` such windows this fails."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if dev:
            return sum(e.self_device_time_total / e.count * -(-e.count // reps)
                       for e in dev) / 1e3
    sys.exit(f"device_ms: the profiler kept no record of {reps} calls in {tries} windows")


def kernel_split(torch, fn, reps: int) -> dict[str, float]:
    """Each kernel's mean device time (ms) in one call of ``fn``, by its
    name without template arguments and parameters, from the profiler's
    records of ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.key.removeprefix("void ").replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0][:60]
            out[name] = out.get(name, 0.0) + e.self_device_time_total / reps / 1e3
    return out


def corpus(torch, seed: int, rows: int = 1_000_000, nq: int = 256, dim: int = 384):
    """``chip_smoke.make_corpus``'s mixture, drawn the same way from ``seed``
    on the card: (corpus [rows, dim], queries [nq, dim]) unit rows."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    centres = torch.randn(1000, dim, device="cuda", generator=g)
    centres /= centres.norm(dim=1, keepdim=True)

    def draw(n):
        lab = torch.randint(0, 1000, (n,), device="cuda", generator=g)
        x = centres[lab] + 0.04 * torch.randn(n, dim, device="cuda", generator=g)
        return x / x.norm(dim=1, keepdim=True)
    c = draw(rows)
    return c, draw(nq)


def ivf_store(torch, c, q):
    """The smoke's IVF store over corpus ``c`` by the importing tree's own
    ``IVFIndex(n_clusters=256, nprobe=8)`` and the probes of queries ``q``
    -> (index, block-padded unit queries [nb*8, d], probes [nb, 64])."""
    from repro_torch.index.ivf_index import IVFIndex
    from repro_torch.kernels import ref
    idx = IVFIndex(c.cpu().numpy(), n_clusters=256, nprobe=8)
    qp, _ = ref.pad_queries(q, 8)
    qp = ref._unitize(qp)
    return idx, qp, ref.ivf_probes(qp, idx._dev["centroids"], 8, 8)


def issued_flops(torch, mask, pairs, dim: int, bq: int = 8) -> int:
    """The FLOPs the cluster-major scans issue (``csrc/cluster_major.cuh``):
    every 128-row chunk of a probed cluster that holds a valid row, against
    each group (up to 64 / bq distinct probing blocks) in 16-row warp bands,
    a band with one live row computed whole."""
    chunk, band, rows = 128, 16, 64
    kc, L = mask.shape
    nch = -(-L // chunk)
    m = torch.zeros(kc, nch * chunk, device=mask.device)
    m[:, :L] = mask
    live = (m.reshape(kc, nch, chunk) > 0).any(-1).sum(-1)
    blocks = torch.bincount(pairs, minlength=kc)
    per = rows // bq
    bands = blocks // per * (rows // band) + (blocks % per * bq + band - 1) // band
    return int(2 * dim * chunk * band * float((live * bands).sum()))


def retrieval_rows(torch, seed: int) -> dict:
    """The three retrieval kernels on the smoke's data (module docstring)."""
    from repro_torch.index.quant import quantize_tiles
    from repro_torch.kernels import ivf_scan as kivf
    from repro_torch.kernels import ivf_scan_q as kivfq
    from repro_torch.kernels import ref
    from repro_torch.kernels import similarity as ksim

    c, q = corpus(torch, seed)
    dim, nq = c.shape[1], q.shape[0]
    out = {}
    norm = torch.nn.functional.normalize
    err = float((ksim.similarity(q, c) - ref.similarity_ref(q, c)).abs().max())
    out["similarity"] = dict(
        ms=device_ms(torch, lambda: ksim.similarity(q, c), 10),
        lib=device_ms(torch, lambda: torch.matmul(norm(q, dim=1), norm(c, dim=1).T), 10),
        cost=("similarity", "cost", [nq, c.shape[0], dim], {}), err=err)

    q1 = q[:1]                                              # sem_search's shape
    err = float((ksim.similarity(q1, c) - ref.similarity_ref(q1, c)).abs().max())
    out["similarity, one query"] = dict(
        ms=device_ms(torch, lambda: ksim.similarity(q1, c), 10),
        lib=device_ms(torch, lambda: torch.matmul(norm(q1, dim=1), norm(c, dim=1).T), 10),
        cost=("similarity", "cost", [1, c.shape[0], dim], {}), err=err)
    idx, qp, probes = ivf_store(torch, c, q)
    del c
    store, mask = idx._dev["store"], idx._dev["store_mask"]
    sq, ssc = (torch.from_numpy(a).cuda() for a in quantize_tiles(idx.store))
    kc, L, _ = store.shape
    sizes = mask.sum(dim=1)
    # sem_search's shape: one query, padded to one block as ivf_search pads it
    qp1, _ = ref.pad_queries(q[:1], 8)
    qp1 = ref._unitize(qp1)
    probes1 = ref.ivf_probes(qp1, idx._dev["centroids"], 8, 8)
    for suffix, qq, pb in (("", qp, probes), (", one query", qp1, probes1)):
        nb, slots = pb.shape
        pl = pb.long()
        uniq = torch.unique(pl)
        srt = pl.sort(dim=1).values                         # distinct (block, cluster) pairs
        first = torch.ones_like(srt, dtype=torch.bool)
        first[:, 1:] = srt[:, 1:] != srt[:, :-1]
        pairs = srt[first]
        issued = issued_flops(torch, mask, pairs, dim)
        qb = qq.reshape(nb, 8, dim)
        # the scans' cost() (computed by the driving checkout): the valid rows
        # of each distinct (block, cluster) pair against the block's 8
        # queries; the probed clusters' valid rows and mask rows, the queries,
        # the probe ids and the plane
        scan_args = [qq.shape[0], dim, L, pb.tolist(), sizes.tolist()]
        for name, module, run, plain, lib in [
                ("cluster_scan", "ivf_scan",
                 lambda: kivf.cluster_scan(qq, store, mask, pb, normalize=False),
                 lambda: ref.ivf_scan_ref(qq, store, mask, pb, normalize=False),
                 lambda: torch.where(mask[pl][:, None] > 0,
                                     torch.einsum("bqd,bsld->bqsl", qb, store[pl]),
                                     MASKED_SCORE)),
                ("cluster_scan_q", "ivf_scan_q",
                 lambda: kivfq.cluster_scan_q(qq, sq, ssc, mask, pb, normalize=False),
                 lambda: ref.ivf_scan_q_ref(qq, sq, ssc, mask, pb, normalize=False),
                 lambda: torch.where(mask[pl][:, None] > 0,
                                     torch.einsum("bqd,bsld->bqsl", qb, sq[pl].float())
                                     * ssc[pl][:, None], MASKED_SCORE))]:
            got, want = run(), plain()
            masked = want <= MASKED_SCORE / 2
            err = float((got[~masked] - want[~masked]).abs().max())
            if not torch.equal(got[masked], want[masked]) or not torch.equal(got, run()):
                err = float("inf")           # masked lanes differ, or two calls do
            del got, want, masked
            out[name + suffix] = dict(ms=device_ms(torch, run, 5), lib=device_ms(torch, lib, 3),
                                      cost=(module, "cost", scan_args, {"block_q": 8}),
                                      issued=issued, err=err)
            torch.cuda.empty_cache()
        print(f"retrieval data{suffix}: store [{kc}, {L}, {dim}], valid rows "
              f"{int(sizes.sum())}, probes [{nb}, {slots}], distinct probed {len(uniq)}, "
              f"distinct (block, cluster) pairs {len(pairs)}; the scans issue "
              f"{issued / 1e9:.2f} GFLOP")
    return out


def attention_rows(torch, seed: int) -> dict:
    """The bf16 attention forward and backward beside SDPA's (module
    docstring)."""
    import inspect

    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ref

    g = torch.Generator(device="cuda").manual_seed(seed)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    saves_stats = "return_stats" in inspect.signature(kfa.flash_attention).parameters
    out = {}
    for label, B in (("training shape", 2), ("oracle shape", 32)):
        S, H, HK, HD = 512, 24, 8, 128
        q, k, v, dout = (torch.randn(B, S, h, HD, device="cuda", generator=g).to(torch.bfloat16)
                         for h in (H, HK, HK, H))
        shape = [B, S, S, H, HK, HD]
        o = kfa.flash_attention(q, k, v, causal=True)
        plain = ref.flash_attention_ref(q, k, v, causal=True).float()
        err = float(((o.float() - plain).abs() / (1 + plain.abs())).max())
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        lib_fwd = device_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True), 10)
        out[f"flash_attention bf16, {label}"] = dict(
            ms=device_ms(torch, lambda: kfa.flash_attention(q, k, v, causal=True), 10),
            lib=lib_fwd, cost=("flash_attention", "cost", shape, {}), peak="bf16",
            err=err, tol=2e-2)
        if saves_stats:
            o, st = kfa.flash_attention(q, k, v, causal=True, return_stats=True)
            fwd_train = lambda: kfa.flash_attention(q, k, v, causal=True, return_stats=True)
            bwd = lambda: kfa.flash_attention_bwd(q, k, v, o, dout, causal=True, stats=st)
        else:
            fwd_train = lambda: kfa.flash_attention(q, k, v, causal=True)
            bwd = lambda: kfa.flash_attention_bwd(q, k, v, o, dout, causal=True)
        out[f"flash_attention bf16 with statistics, {label}"] = dict(
            ms=device_ms(torch, fwd_train, 10), lib=lib_fwd,
            cost=("flash_attention", "cost", shape, {}), peak="bf16", err=err, tol=2e-2)
        got = bwd()
        want = ref.flash_attention_bwd_ref(q, k, v, o, dout, causal=True)
        err = max(float(((a.float() - b.float()).abs() / (1 + b.float().abs())).max())
                  for a, b in zip(got, want))
        if not all(torch.equal(a, b) for a, b in zip(got, bwd())):
            err = float("inf")                               # two calls differ
        del got, want
        so = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
        dot = dout.transpose(1, 2)
        out[f"flash_attention_bwd bf16, {label}"] = dict(
            ms=device_ms(torch, bwd, 10),
            lib=device_ms(torch, lambda: torch.autograd.grad(so, (qt, kt, vt), dot,
                                                             retain_graph=True), 10),
            cost=("flash_attention", "backward_cost", shape, {}), peak="bf16", err=err,
            tol=5e-2, split=kernel_split(torch, bwd, 10))
        del q, k, v, dout, o, plain, qt, kt, vt, so
        torch.cuda.empty_cache()
    return out


def child(tree: str, seed: int, groups: list[str]) -> None:
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.kernels import rmsnorm as krn

    _build.SOURCES = tuple(n for gr in groups for n in GROUPS[gr])
    _build.build()
    out = retrieval_rows(torch, seed) if "retrieval" in groups else {}
    if "attention" in groups:
        out.update(attention_rows(torch, seed))
    if "model" not in groups:
        print(json.dumps(out))
        return
    dev = torch.device("cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, S, H, HK, HD = 32, 1024, 24, 8, 128
    for dt in (torch.bfloat16, torch.float32):
        q = torch.randn(B, 1, H, HD, device=dev, generator=g).to(dt)
        k = torch.randn(B, S, HK, HD, device=dev, generator=g).to(dt)
        v = torch.randn(B, S, HK, HD, device=dev, generator=g).to(dt)
        lens = torch.randint(0, S, (B,), device=dev, generator=g, dtype=torch.int32)
        mask = (torch.arange(S, device=dev)[None, :] <= lens[:, None])[:, None, None, :]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        err = float((kda.decode_attention(q, k, v, lens).float()
                     - ref.decode_attention_ref(q, k, v, lens).float()).abs().max())
        tol = 1e-5 if dt == torch.float32 else 2e-2
        assert err <= 2 * tol, f"decode_attention {dt}: max abs err {err}"
        ms = device_ms(torch, lambda: kda.decode_attention(q, k, v, lens), 20)
        lib = device_ms(torch, lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True), 20)
        es = q.element_size()
        out[f"decode_attention {str(dt)[6:]}"] = dict(
            ms=ms, lib=lib, err=err, peak="bf16",
            cost=("decode_attention", "cost", [B, S, H, HK, HD, lens.tolist()], {"itemsize": es}))
        if dt == torch.bfloat16:   # every row at S - 1: the whole cache, uniform work
            full = torch.full_like(lens, S - 1)
            out["decode_attention bfloat16, lens S - 1"] = dict(
                ms=device_ms(torch, lambda: kda.decode_attention(q, k, v, full), 20),
                lib=lib, peak="bf16",
                cost=("decode_attention", "cost", [B, S, H, HK, HD, full.tolist()],
                      {"itemsize": es}),
                err=float((kda.decode_attention(q, k, v, full).float()
                           - ref.decode_attention_ref(q, k, v, full).float()).abs().max()))
    # small batches: several chunks a row (the engine's 8 slots, the paged
    # phase's 8 rows of 128 positions, 2 rows of 4096)
    for b, s, full in ((8, 1024, False), (8, 1024, True), (8, 128, True), (2, 4096, True)):
        dt = torch.bfloat16
        q = torch.randn(b, 1, H, HD, device=dev, generator=g).to(dt)
        k = torch.randn(b, s, HK, HD, device=dev, generator=g).to(dt)
        v = torch.randn(b, s, HK, HD, device=dev, generator=g).to(dt)
        lens = torch.full((b,), s - 1, device=dev, dtype=torch.int32) if full else \
            torch.randint(0, s, (b,), device=dev, generator=g, dtype=torch.int32)
        mask = (torch.arange(s, device=dev)[None, :] <= lens[:, None])[:, None, None, :]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        err = float((kda.decode_attention(q, k, v, lens).float()
                     - ref.decode_attention_ref(q, k, v, lens).float()).abs().max())
        assert err <= 4e-2, f"decode_attention B {b} S {s}: max abs err {err}"
        out[f"decode_attention bfloat16, B {b} S {s}, lens {'S - 1' if full else 'random'}"] = \
            dict(ms=device_ms(torch, lambda: kda.decode_attention(q, k, v, lens), 20),
                 lib=device_ms(torch, lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                                   enable_gqa=True), 20),
                 cost=("decode_attention", "cost", [b, s, H, HK, HD, lens.tolist()], {}),
                 peak="bf16", err=err)
    x = torch.randn(16384, 3072, device=dev, generator=g).to(torch.bfloat16)
    sc = torch.randn(3072, device=dev, generator=g)
    sc16 = sc.to(torch.bfloat16)
    err = float((krn.rmsnorm(x, sc, eps=1e-5).float()
                 - ref.rmsnorm_ref(x, sc, eps=1e-5).float()).abs().max())
    ms = device_ms(torch, lambda: krn.rmsnorm(x, sc, eps=1e-5), 20)
    lib = device_ms(torch, lambda: torch.nn.functional.rms_norm(x, (3072,), sc16, eps=1e-5), 20)
    out["rmsnorm bfloat16"] = dict(ms=ms, lib=lib, err=err,
                                   cost=("rmsnorm", "cost", [x.shape[0], 3072], {}))
    # a copy of x moves the same bytes: the card's reachable rate for them
    out["x.clone() bfloat16"] = dict(ms=device_ms(torch, x.clone, 20), lib=1.0,
                                     nbytes=2 * x.numel() * 2, err=0.0)
    print(json.dumps(out))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--groups", default="retrieval,model")
    ap.add_argument("--child", default=None)
    args = ap.parse_args()
    groups = args.groups.split(",")
    if not set(groups) <= set(GROUPS):
        sys.exit(f"--groups: each of {sorted(GROUPS)}")
    if args.child is not None:
        child(args.child, args.seed, groups)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"device: {smi}", flush=True)
    # the bounds: this checkout's peaks table and kernels' cost(), whichever
    # tree a child measures
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import importlib

    from repro_torch.launch import roofline
    name = smi.split(",")[0]
    peaks = roofline.peaks(name)
    print(f"peaks of the {roofline.sku(name)} (datasheet): {peaks}", flush=True)

    def count(row: dict) -> tuple[float, float]:
        """(FLOPs, bytes) of a row: its kernel's cost(), or its bytes alone."""
        if "cost" not in row:
            return 0.0, row["nbytes"]
        module, fn, a, kw = row["cost"]
        return getattr(importlib.import_module(f"repro_torch.kernels.{module}"), fn)(*a, **kw)
    order = []
    for r in range(args.rounds):
        order += args.trees if r % 2 == 0 else args.trees[::-1]
    runs: dict[str, list[dict]] = {t: [] for t in args.trees}
    for spec in order:
        res = subprocess.run([sys.executable, __file__, "_", "--child", spec,
                              "--seed", str(args.seed), "--groups", args.groups],
                             capture_output=True, text=True)
        if res.returncode != 0:
            sys.exit(f"{spec} failed:\n{res.stdout[-4000:]}\n{res.stderr[-4000:]}")
        *notes, last = res.stdout.strip().splitlines()
        runs[spec].append(json.loads(last))
        shown = {n: {k: v for k, v in r.items() if k != "cost"}     # the cost's arguments
                 for n, r in runs[spec][-1].items()}                 # (probe lists) are long
        print("\n".join(f"ran {spec}: {line}" for line in (*notes, json.dumps(shown))),
              flush=True)
    wrong = []
    for spec, rs in runs.items():
        for name in rs[0]:
            err = max(r[name]["err"] for r in rs)
            tol = rs[0][name].get("tol", 1e-5 if name in RETRIEVAL else float("inf"))
            bad = not err <= tol
            if bad:
                wrong.append(f"{spec} | {name}")
            ms = statistics.median(r[name]["ms"] for r in rs)
            lib = statistics.median(r[name]["lib"] for r in rs)
            ratios = ", ".join(f"{r[name]['ms'] / r[name]['lib']:.3f}" for r in rs)
            flops, nbytes = count(rs[0][name])
            peak = getattr(peaks, rs[0][name].get("peak", "fp32"))
            bound, by = roofline.bound(nbytes, flops, hbm_bw=peaks.hbm_bw, peak=peak)
            print(f"{spec} | {name}: kernel {ms:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s, "
                  f"{flops / ms / 1e9:.1f} TFLOP/s; bound {bound:.4f} ms by {by}, "
                  f"share {bound / ms:.3f}), library {lib:.4f} ms; kernel / library per "
                  f"run {ratios}; max abs err {err:.3g}"
                  + (" DISAGREES with its plain version" if bad else ""))
            if "issued" in rs[0][name]:
                issued = rs[0][name]["issued"]
                print(f"{spec} | {name}: the scan issues {issued / 1e9:.2f} GFLOP, "
                      f"{issued / flops:.4f} x the bound's {flops / 1e9:.2f}")
            if "split" in rs[0][name]:
                names = rs[0][name]["split"]
                print(f"{spec} | {name}, its kernels (median ms): " + ", ".join(
                    f"{n} {statistics.median(r[name]['split'].get(n, 0.0) for r in rs):.4f}"
                    for n in names))
    if wrong:
        sys.exit("these kernels disagree with their plain versions: " + "; ".join(wrong))


if __name__ == "__main__":
    main()
