"""Drive the PyTorch/CUDA port (``repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed N] [--rows N]

Phases (any failure raises and exits non-zero; nothing is caught):

  1. device   — require CUDA, print the card's name and power limit, build
                the kernels from ``src/repro_torch/kernels/csrc``;
  2. retrieval at a realistic size — a synthetic Gaussian mixture of
                1,000,000 x 384 fp32 rows (384 = the width of the repo's
                E5-small embedder; 1000 centres, noise 0.04 per coordinate)
                and 256 queries, made from ``--seed``; ``sem_index`` builds an
                exact, an IVF and an int8 IVF index (``n_clusters=256``, cut
                from the default 1000 because the host k-means++ build grows
                with k^2);
  3. kernels  — each hand-written kernel against its plain torch version on
                the card, at the shapes the main path gives it plus ragged
                edges: max abs error, masked lanes exact, CUDA-event times of
                kernel / plain version / one PyTorch library call, and the
                bound from bytes and FLOPs at the card's datasheet peaks;
  4. main path — launch counters set to 0, then ``sem_sim_join`` and
                ``sem_search`` over the three indexes, counters read: each
                kernel must have launched; recall@10 of both IVF flavours
                against exact, search times, scanned bytes, peak memory;
  5. hard corpus — the same mixture with noise 0.065, where each centre's
                rows straddle several lists: IVF fp32 and int8 at the nprobe
                of ``recall_target=0.90`` must reach recall@10 >= 0.90 (and
                int8 within 0.01 of fp32), with the recall of other nprobe
                values printed;
  6. small end to end — ``SimulatedEmbedder`` worlds through ``sem_index``
                / ``sem_search`` / ``sem_sim_join`` / ``add()`` on the card,
                checked against the same run on the CPU (the plain versions,
                which the tests hold against the JAX reference).

The second-to-last line of output is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

import repro_torch  # noqa: E402
from repro_torch.core.backends import synth  # noqa: E402
from repro_torch.core.operators.search import (sem_index, sem_search,  # noqa: E402
                                               sem_sim_join)
from repro_torch.index.backend import MASKED_SCORE  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import ivf_scan as kivf  # noqa: E402
from repro_torch.kernels import ivf_scan_q as kivfq  # noqa: E402
from repro_torch.kernels import similarity as ksim  # noqa: E402
from repro_torch.obs import trace  # noqa: E402

DIM = 384              # E5_SMALL's width (src/repro/embed/encoder.py)
N_CLUSTERS = 256       # cut from default_n_clusters(1e6) = 1000: host k-means++ cost
NPROBE = 8             # 3% of the lists per query; a block scans its 8 queries' union
K = 10
N_QUERIES = 256
NOISE = 0.04           # the main corpus: tight clusters, recall@10 near 1
HARD_NOISE = 0.065     # the hard corpus: clusters straddle the IVF lists
TOL = 1e-5             # unit-vector dot products summed in another order

# NVIDIA datasheet peaks (dense): device-memory bytes/s and fp32 FLOP/s outside
# the tensor cores; the kernels are IEEE fp32 SIMT by contract.
PEAKS = {"H100 SXM": (3.35e12, 67e12), "H100 PCIe": (2.0e12, 51e12),
         "H100 NVL": (3.9e12, 60e12)}

_KERNELS = (("similarity", ksim), ("cluster_scan", kivf), ("cluster_scan_q", kivfq))
_SOURCES = {"similarity": ("src/repro_torch/kernels/csrc/similarity.cu",
                           "src/repro/kernels/similarity.py:45"),
            "cluster_scan": ("src/repro_torch/kernels/csrc/ivf_scan.cu",
                             "src/repro/kernels/ivf_scan.py:49"),
            "cluster_scan_q": ("src/repro_torch/kernels/csrc/ivf_scan_q.cu",
                               "src/repro/kernels/ivf_scan_q.py:46")}


def log(*a):
    print(*a, flush=True)


def peaks(name: str) -> tuple[str, float, float]:
    sku = "H100 PCIe" if "PCIe" in name else "H100 NVL" if "NVL" in name \
        else "H100 SXM"
    return (sku, *PEAKS[sku])


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def plane_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max abs error over scored lanes; masked lanes must match exactly."""
    assert got.shape == want.shape, (got.shape, want.shape)
    masked = want <= MASKED_SCORE / 2
    assert torch.equal(got[masked], want[masked]), "masked lanes differ"
    assert bool((got[~masked] > MASKED_SCORE / 2).all()), "scored lane masked"
    err = float((got[~masked] - want[~masked]).abs().max()) if (~masked).any() else 0.0
    assert np.isfinite(err) and err <= TOL, f"max abs error {err} > {TOL}"
    return err


class RowEmbedder:
    """Texts "c:<i>" / "q:<i>" embed to row i of the seeded corpus / query
    arrays: the stand-in for a real embedder at the corpus's real width."""

    def __init__(self, corpus: np.ndarray, queries: np.ndarray):
        self.rows = {"c": corpus, "q": queries}
        self.dim = corpus.shape[1]
        self.index_key = "chip-smoke-rows"

    def embed(self, texts):
        kind = texts[0][0]
        idx = np.fromiter((int(t[2:]) for t in texts), np.int64, len(texts))
        return self.rows[kind][idx]


def make_corpus(rows: int, seed: int, noise: float) -> tuple[np.ndarray, np.ndarray]:
    """A synthetic Gaussian mixture, made on the card in bulk: unit rows
    around 1000 random unit centres plus ``noise`` * N(0, 1) per coordinate,
    'rows' corpus rows and N_QUERIES query rows from the same mixture."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    centres = torch.randn(1000, DIM, device="cuda", generator=g)
    centres /= centres.norm(dim=1, keepdim=True)

    def draw(n):
        lab = torch.randint(0, 1000, (n,), device="cuda", generator=g)
        x = centres[lab] + noise * torch.randn(n, DIM, device="cuda", generator=g)
        return (x / x.norm(dim=1, keepdim=True)).cpu().numpy()
    return draw(rows), draw(N_QUERIES)


def recall(exact: np.ndarray, got: np.ndarray) -> float:
    return float(np.mean([len(set(e) & set(g)) / exact.shape[1]
                          for e, g in zip(exact.tolist(), got.tolist())]))


def kernel_phase(args, idx_exact, idx_ivf, idx_q, queries, bw, fp32) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    dev = torch.device("cuda")
    out = {}
    q = torch.from_numpy(queries).to(dev)

    # similarity: the exact join's shape, then ragged edges both ways
    c = idx_exact._device_vectors(idx_exact.vectors)
    got = ksim.similarity(q, c)
    err = float((got - ref.similarity_ref(q, c)).abs().max())
    assert err <= TOL, err
    del got
    g = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    for nq, nc, d in [(37, 1001, 17), (1, 129, 3), (65, 300, DIM)]:
        a = torch.randn(nq, d, device=dev, generator=g)
        b = torch.randn(nc, d, device=dev, generator=g)
        err = max(err, float((ksim.similarity(a, b) - ref.similarity_ref(a, b)).abs().max()))
        a, b = a / a.norm(dim=1, keepdim=True), b / b.norm(dim=1, keepdim=True)
        err = max(err, float((ksim.similarity(a, b, normalize=False)
                              - ref.similarity_ref(a, b, normalize=False)).abs().max()))
    assert err <= TOL, err
    nq, nc = q.shape[0], c.shape[0]
    ms = cuda_ms(lambda: ksim.similarity(q, c), 10)
    plain = cuda_ms(lambda: ref.similarity_ref(q, c), 5)
    lib = cuda_ms(lambda: torch.matmul(torch.nn.functional.normalize(q, dim=1),
                                       torch.nn.functional.normalize(c, dim=1).T), 5)
    nbytes = 4 * DIM * (nq + nc) + 4 * nq * nc
    flops = 2 * nq * nc * DIM
    out["similarity"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                             nbytes=nbytes, flops=flops,
                             shape=f"q[{nq},{DIM}] x c[{nc},{DIM}]")

    # the probes the IVF join computes (both IVF indexes share the quantizer)
    qp, nb = ref.pad_queries(q, 8)
    qp = ref._unitize(qp)
    assert torch.equal(idx_ivf._dev["centroids"], idx_q._dev["centroids"])
    probes = ref.ivf_probes(qp, idx_ivf._dev["centroids"], NPROBE, 8)
    for name, idx in (("cluster_scan", idx_ivf), ("cluster_scan_q", idx_q)):
        dv = idx._dev
        if name == "cluster_scan":
            run = lambda: kivf.cluster_scan(qp, dv["store"], dv["store_mask"], probes,
                                            normalize=False)
            plain_fn = lambda: ref.ivf_scan_ref(qp, dv["store"], dv["store_mask"],
                                                probes, normalize=False)
            row_bytes, tiles = 4 * DIM, dv["store"]
        else:
            run = lambda: kivfq.cluster_scan_q(qp, dv["store_q"], dv["store_scales"],
                                               dv["store_mask"], probes, normalize=False)
            plain_fn = lambda: ref.ivf_scan_q_ref(qp, dv["store_q"], dv["store_scales"],
                                                  dv["store_mask"], probes,
                                                  normalize=False)
            row_bytes, tiles = DIM + 4, dv["store_q"]      # int8 row + its scale
        err = plane_err(run(), plain_fn())
        # ragged edges: d=17 (scalar loads), block sizes 4 and 16, normalize in-kernel
        gg = torch.Generator(device="cuda").manual_seed(args.seed + 2)
        for kc, L, d, bq in [(6, 128, 17, 8), (5, 256, DIM, 4), (7, 128, 64, 16)]:
            st = torch.randn(kc, L, d, device=dev, generator=gg)
            mk = (torch.rand(kc, L, device=dev, generator=gg) > 0.3).float()
            st = st / st.norm(dim=-1, keepdim=True) * mk[..., None]
            qq = torch.randn(3 * bq, d, device=dev, generator=gg)
            pb = torch.randint(0, kc, (3, 2 * bq), device=dev, generator=gg,
                               dtype=torch.int32)
            if name == "cluster_scan":
                e = plane_err(kivf.cluster_scan(qq, st, mk, pb, block_q=bq),
                              ref.ivf_scan_ref(qq, st, mk, pb, block_q=bq))
            else:
                sq = torch.randint(-127, 128, (kc, L, d), device=dev, generator=gg,
                                   dtype=torch.int8)
                sc = torch.rand(kc, L, device=dev, generator=gg) / (127 * d ** 0.5)
                e = plane_err(kivfq.cluster_scan_q(qq, sq, sc, mk, pb, block_q=bq),
                              ref.ivf_scan_q_ref(qq, sq, sc, mk, pb, block_q=bq))
            err = max(err, e)
        ms = cuda_ms(run, 10)
        plain = cuda_ms(plain_fn, 3)
        kc, L, _ = tiles.shape
        nbp, slots = probes.shape
        sizes = dv["store_mask"].sum(dim=1)                    # valid rows per cluster
        valid_lanes = float(sizes[probes.long()].sum()) * 8   # scored (query, row) pairs
        uniq = torch.unique(probes.long())
        # each input read once: the valid rows of the distinct probed clusters
        # (padded lanes are masked, so need not be read), the whole mask, the
        # queries and probe ids; the output plane written once
        nbytes = int(sizes[uniq].sum()) * row_bytes + kc * L * 4 + qp.numel() * 4 \
            + probes.numel() * 4 + qp.shape[0] * slots * L * 4
        flops = int(2 * DIM * valid_lanes)
        # library yardstick: one gathered einsum over the whole batch, when the
        # gathered fp32 tiles, a possible copy of them for the batched matmul
        # (and the gathered int8 tiles) fit in the free memory
        gathered = nbp * slots * L * DIM * 4
        need = 2 * gathered + (gathered // 4 if name == "cluster_scan_q" else 0)
        free, _ = torch.cuda.mem_get_info()
        lib = None
        if need < 0.9 * free:
            qb = qp.reshape(nbp, 8, DIM)
            pl = probes.long()
            if name == "cluster_scan":
                lib_fn = lambda: torch.where(
                    dv["store_mask"][pl][:, None] > 0,
                    torch.einsum("bqd,bsld->bqsl", qb, dv["store"][pl]), MASKED_SCORE)
            else:
                lib_fn = lambda: torch.where(
                    dv["store_mask"][pl][:, None] > 0,
                    torch.einsum("bqd,bsld->bqsl", qb, dv["store_q"][pl].float())
                    * dv["store_scales"][pl][:, None], MASKED_SCORE)
            lib = cuda_ms(lib_fn, 3)
        else:
            log(f"{name}: library einsum skipped, it may need "
                f"{need / 2**30:.1f} GiB of {free / 2**30:.1f} GiB free")
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                         nbytes=nbytes, flops=flops,
                         shape=f"q[{qp.shape[0]},{DIM}] probes[{nbp},{slots}] "
                               f"tiles[{kc},{L},{DIM}] distinct_probed={len(uniq)}")
        torch.cuda.empty_cache()
    for name, r in out.items():
        r["bound_ms"] = 1e3 * max(r["nbytes"] / bw, r["flops"] / fp32)
        r["bound_by"] = "bytes" if r["nbytes"] / bw >= r["flops"] / fp32 else "operations"
        log(f"kernel {name}: {r['shape']} err={r['max_abs_err']:.3g} "
            f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']} "
            f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) bytes={r['nbytes']} "
            f"flops={r['flops']}")
    return out


def main_path(corpus_texts, query_texts, emb, indexes) -> tuple[dict, dict]:
    """The user-facing calls, with every launch counter set to 0 first."""
    for _, mod in _KERNELS:
        mod.launches = 0
    results = {}
    for name, idx in indexes.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores, ids, st = sem_sim_join(query_texts, idx, emb, k=K)
        dt = time.perf_counter() - t0
        assert ids.shape == (N_QUERIES, K) and np.isfinite(scores).all()
        hits, st1 = sem_search(idx, query_texts[0], emb, k=K)
        assert hits == ids[0].tolist(), (name, hits, ids[0])
        results[name] = dict(ids=ids, search_s=dt, details=st)
    launches = {name: mod.launches for name, mod in _KERNELS}
    return results, launches


def breakdown(name, idx, query_texts, emb) -> None:
    """One more join under a tracer: the operator span against its kernel
    spans (the tracer synchronizes, so a kernel span holds the device work
    of its ops call plus the copy of its result to the host)."""
    tracer = trace.Tracer()
    with trace.activate(tracer):
        sem_sim_join(query_texts, idx, emb, k=K)
    op = sum(s.dur_s for s in tracer.spans(kind="operator")) * 1e3
    kern = {s.name: s.dur_s * 1e3 for s in tracer.spans(kind="kernel")}
    log(f"breakdown {name}: sem_sim_join {op:.1f} ms, kernel spans "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in kern.items())
        + f", rest (embed, host top-k, rerank, stats) {op - sum(kern.values()):.1f} ms")
    # and one under the profiler: device busy time (kernels and copies) by name
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        sem_sim_join(query_texts, idx, emb, k=K)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies): a CPU op's device total
    # would count its kernels a second time
    dev = sorted(((e.self_device_time_total / 1e3, e.key) for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)
    busy = sum(ms for ms, _ in dev)
    if busy > 0:
        log(f"profile {name}: wall {wall:.1f} ms, device busy {busy:.2f} ms, "
            f"idle share {1 - busy / wall:.4f}; top: "
            + ", ".join(f"{k} {ms:.2f} ms" for ms, k in dev[:4]))
    else:
        log(f"profile {name}: the profiler recorded no device time (not measured)")


def hard_recall(args) -> dict:
    """The recall floor on a corpus where it can fail: the same mixture with
    HARD_NOISE per coordinate, so each centre's rows straddle several IVF
    lists.  nprobe comes from the repo's own recall knob
    (``recall_target=0.90``, the floor); the recall@10 of other nprobe
    values is printed beside it."""
    corpus, queries = make_corpus(args.rows, args.seed + 3, HARD_NOISE)
    emb = RowEmbedder(corpus, queries)
    corpus_texts = [f"c:{i}" for i in range(len(corpus))]
    query_texts = [f"q:{i}" for i in range(N_QUERIES)]
    _, exact_ids, _ = sem_sim_join(query_texts, sem_index(corpus_texts, emb), emb, k=K)
    rec = {}
    for name, kw in [("ivf", {}), ("ivf_int8", {"quantize": "int8"})]:
        t0 = time.perf_counter()
        idx = sem_index(corpus_texts, emb, index="ivf", n_clusters=N_CLUSTERS,
                        recall_target=0.90, **kw)
        build_s = time.perf_counter() - t0
        _, ids, _ = sem_sim_join(query_texts, idx, emb, k=K)
        rec[name] = recall(exact_ids, ids)
        curve = {n: recall(exact_ids, idx.search(queries, K, nprobe=n)[1])
                 for n in (4, 8, 16, 32, 64)}
        log(f"hard corpus (noise {HARD_NOISE}) {name}: nprobe={idx.nprobe} "
            f"(recall_target 0.90), recall@{K}={rec[name]:.4f}, build_s={build_s:.2f}, "
            f"recall@{K} by nprobe: " + ", ".join(f"{n}: {r:.4f}" for n, r in curve.items()))
        del idx
    assert rec["ivf"] >= 0.90, rec
    assert rec["ivf_int8"] >= rec["ivf"] - 0.01, rec
    return rec


def small_end_to_end() -> None:
    """SimulatedEmbedder worlds on the card, checked against the CPU run."""
    def run():
        left, right, _, _, _, emb = synth.make_join_world(80, 600, seed=11)
        texts = [r["reaction"] for r in right]
        queries = [r["abstract"] for r in left]
        out = []
        for kind, kw in [("exact", {}), ("ivf", {"n_clusters": 8, "nprobe": 2}),
                         ("ivf", {"n_clusters": 8, "nprobe": 2, "quantize": "int8"})]:
            idx = sem_index(texts, emb, index=kind, retrain="off", **kw) \
                if kind == "ivf" else sem_index(texts, emb, index=kind)
            hits, st = sem_search(idx, queries[0], emb, k=5)
            s, i, st2 = sem_sim_join(queries, idx, emb, k=3)
            extra = emb.embed([f"new row {j} <rec:extra{j}>" for j in range(40)])
            idx.add(extra)
            s3, i3 = idx.search(emb.embed(queries[:16]), 5)
            full = idx.search(emb.embed(queries[:16]), 5,
                              **({"nprobe": idx.n_clusters} if kind == "ivf" else {}))[1]
            out.append((hits, i, s, i3, full, st2["scored_vectors"]))
        return out
    before = {name: mod.launches for name, mod in _KERNELS}
    gpu = run()
    after = {name: mod.launches for name, mod in _KERNELS}
    assert all(after[n] > before[n] for n in after), (before, after)
    repro_torch.set_device("cpu")
    try:
        cpu = run()
    finally:
        repro_torch.set_device(None)
    exact_full = gpu[0][4]
    for (g, c) in zip(gpu, cpu):
        assert g[0] == c[0] and np.array_equal(g[1], c[1]) and np.array_equal(g[3], c[3])
        assert np.allclose(g[2], c[2], rtol=TOL, atol=TOL) and g[5] == c[5]
        assert np.array_equal(g[4], exact_full)   # nprobe=n_clusters == exact ids
    log(f"small end to end: cuda == cpu for exact/ivf/int8, launches {after}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=1_000_000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA device; none is available")
    torch.manual_seed(args.seed)
    t_start = time.perf_counter()

    # 1. device + build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    sku, bw, fp32 = peaks(kind)
    log(f"device: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; peaks for {sku}: "
        f"{bw / 1e12} TB/s, {fp32 / 1e12} TFLOP/s fp32")
    build_s = _build.build()
    log(f"kernels built in {build_s:.2f} s")
    for name in _build.SOURCES:
        text = _build.library_path(name).with_suffix(".log")
        if text.exists():
            for line in text.read_text().splitlines():
                if "Used" in line:
                    log(f"  {name}: {line.strip()}")

    # 2. realistic retrieval: corpus, queries, three indexes
    if args.rows != 1_000_000:
        log(f"cut: corpus rows {args.rows} (default 1000000)")
    log(f"cut: n_clusters={N_CLUSTERS} (default for {args.rows} rows would be 1000)")
    t0 = time.perf_counter()
    corpus, queries = make_corpus(args.rows, args.seed, NOISE)
    log(f"corpus {corpus.shape} queries {queries.shape} made in "
        f"{time.perf_counter() - t0:.2f} s")
    emb = RowEmbedder(corpus, queries)
    corpus_texts = [f"c:{i}" for i in range(len(corpus))]
    query_texts = [f"q:{i}" for i in range(N_QUERIES)]
    torch.cuda.reset_peak_memory_stats()
    indexes, build = {}, {}
    for name, kw in [("exact", dict(index="exact")),
                     ("ivf", dict(index="ivf", n_clusters=N_CLUSTERS, nprobe=NPROBE)),
                     ("ivf_int8", dict(index="ivf", n_clusters=N_CLUSTERS,
                                       nprobe=NPROBE, quantize="int8"))]:
        t0 = time.perf_counter()
        indexes[name] = sem_index(corpus_texts, emb, **kw)
        torch.cuda.synchronize()
        build[name] = time.perf_counter() - t0
        log(f"sem_index {name}: {build[name]:.2f} s  {indexes[name].describe()}")
    log(f"indexes on the card: {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    L = indexes["ivf"].store.shape[1]
    log(f"ivf store [{N_CLUSTERS}, {L}, {DIM}] fp32 = "
        f"{N_CLUSTERS * L * DIM * 4 / 2**30:.2f} GiB on the card")

    # 3. kernels against their plain versions
    kres = kernel_phase(args, indexes["exact"], indexes["ivf"], indexes["ivf_int8"],
                        queries, bw, fp32)

    # 4. the main path, counted
    torch.cuda.reset_peak_memory_stats()
    results, launches = main_path(corpus_texts, query_texts, emb, indexes)
    log(f"main path launches: {launches}")
    assert all(n > 0 for n in launches.values()), launches
    exact_ids = results["exact"]["ids"]
    rec = {n: recall(exact_ids, r["ids"]) for n, r in results.items()}
    for name, r in results.items():
        d = r["details"]
        log(f"sem_sim_join {name}: {r['search_s'] * 1e3:.1f} ms for {N_QUERIES} queries, "
            f"k={K}, recall@{K}={rec[name]:.4f}, scanned_bytes={d.get('scanned_bytes')}, "
            f"scored_vectors={d.get('scored_vectors')}, probed={d.get('probed_clusters')}, "
            f"build_s={build[name]:.2f}")
    log(f"max_memory_allocated during the main path "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name, idx in indexes.items():
        breakdown(name, idx, query_texts, emb)
    assert rec["ivf"] >= 0.90, rec
    assert rec["ivf_int8"] >= rec["ivf"] - 0.01, rec
    del indexes, results
    torch.cuda.empty_cache()

    # 5. the recall floor on the hard corpus
    hard_recall(args)
    torch.cuda.empty_cache()

    # 6. small end to end, card against CPU
    small_end_to_end()

    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(f"device: {smi}")
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": _SOURCES[name][0],
         "replaces": _SOURCES[name][1], "launches": launches[name],
         "max_abs_err": kres[name]["max_abs_err"], "ms": kres[name]["ms"],
         "plain_ms": kres[name]["plain_ms"], "bound_ms": kres[name]["bound_ms"],
         "bound_by": kres[name]["bound_by"], "library_ms": kres[name]["library_ms"]}
        for name, _ in _KERNELS]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
