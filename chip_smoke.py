"""Drive the PyTorch/CUDA port (``repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed N] [--rows N]

Phases (any failure raises and exits non-zero; nothing is caught):

  1. device   — require CUDA, print the card's name and power limit, build
                the kernels from ``src/repro_torch/kernels/csrc`` and print
                each kernel instance's registers, shared memory and spills
                (``nvcc -Xptxas -v``);
  2. retrieval at a realistic size — a synthetic Gaussian mixture of
                1,000,000 x 384 fp32 rows (384 = the width of the repo's
                E5-small embedder; 1000 centres, noise 0.04 per coordinate)
                and 256 queries, made from ``--seed``; ``sem_index`` builds an
                exact, an IVF and an int8 IVF index (``n_clusters=256``, cut
                from the default 1000 because the host k-means++ build grows
                with k^2);
  3. kernels  — each retrieval kernel against its plain torch version on
                the card, at the shapes the main path gives it plus ragged
                and misaligned edges: max abs error, masked lanes exact, the
                top-10 ids of every row equal to the plain version's (up to
                near-ties), two calls bit for bit; profiler device times of
                the kernel and one PyTorch library call in turns over ROUNDS
                rounds and of the plain version, beside the bound from bytes
                and FLOPs at the card's datasheet peaks (GB/s, TFLOP/s and
                the share of the bound); each kernel also at ``sem_search``'s
                one-query shape, printed only;
  4. main path — launch counters set to 0, then ``sem_sim_join`` and
                ``sem_search`` over the three indexes, counters read: each
                kernel must have launched; recall@10 of both IVF flavours
                against exact, search times, scanned bytes, peak memory; the
                joins again through the plain versions on the card, whose
                top-10 ids must be the kernel path's (up to near-ties);
  5. hard corpus — the same mixture with noise 0.065, where each centre's
                rows straddle several lists: IVF fp32 and int8 at the nprobe
                of ``recall_target=0.90`` must reach recall@10 >= 0.90 (and
                int8 within 0.01 of fp32), with the recall of other nprobe
                values printed;
  6. small end to end — ``SimulatedEmbedder`` worlds through ``sem_index``
                / ``sem_search`` / ``sem_sim_join`` / ``add()``, and one lazy
                ``SemFrame`` pipeline (filter -> join under rule 4's
                prefilter -> pivot-guided topk), on the card, checked against
                the same run on the CPU (the plain versions, which the tests
                hold against the JAX reference) record for record and bill
                for bill;
  7. oracle kernels — ``flash_attention`` and ``rmsnorm`` against their
                plain versions at the oracle's shapes (q [32,512,24,128],
                k/v [32,512,8,128] bf16 causal; x [32*512, 3072]) and at
                ragged edges (for bf16 attention, the tensor-core kernel's:
                hd 20, 24, 64 and 100, Sq and Sk no multiple of 64, one
                prefill, H/Hk 8, rows no key may see, misaligned rows; for
                rmsnorm, one row, rows no multiple of the persistent blocks'
                share, d 8192 in registers, d 16384, odd and misaligned rows
                in the fallback), and ``flash_attention`` at the E5
                embedder's shape (q/k/v [64,256,12,32] f32, non-causal: the
                SIMT kernel), also timed beside SDPA and its bound (printed
                only; the kernel's row stays the oracle's bf16 shape); the
                bf16 kernel's SASS must hold
                tensor-core instructions; timed by profiler device time
                beside the bound (GB/s and its share) and SDPA / F.rms_norm,
                kernel and library call in turn over ROUNDS rounds, with the
                ratio of each round;
  8. the LLM oracle at full width — llama3.2-3b (28 layers, d 3072, 24/8
                heads, ff 8192, bf16, random weights from ``--seed``; the one
                cut is the vocabulary, 128256 -> the byte tokenizer's 384)
                under the config's own ``attn_impl="auto"``: launch counters
                set to 0, then ``predicate`` over 64 prompts, ``compare`` over
                32 pairs, ``choose`` among 4 options and ``sem_search`` with
                an LLM rerank; ``flash_attention`` must have launched 28
                times per forward pass.  The same prompts through the plain
                path on the card (``attn_impl="full"``) must agree with it:
                in f32 to 1e-4, in bf16 to BF16_LOGPROB_TOL (a limit that a
                second correct plain path meets and two gross faults of the
                plain path exceed; two mild ones are printed), and in the
                sign of token-pair margins above 0.1 (of both signs).  Then
                the ``ops.rmsnorm`` entry at the oracle's activations,
                counted on its own, and the forward pass's time by kernel
                (profiler; the bf16 attention kernel, found by its symbol,
                must read more than 0 ms).
  9. decode kernel — ``decode_attention`` against its plain version in f32
                and bf16: the generate path's shape (q [32,1,24,128], k/v
                [32,1024,8,128]), a 256 window, S 4096 (many chunks a row),
                8 and 16 q-heads a kv-head, Hk = H, hd 128, 100, 64, 17 and
                16, S 77, 129 and 300, misaligned k/v, lens 0, S - 1 and
                past S; two calls give identical bits and every merge ticket
                ends at 0; timed beside the bound (GB/s and its share) and
                SDPA (bool mask, GQA), in turn over ROUNDS rounds;
 10. small generate — the smoke-size model (f32) generating on the card
                against the CPU: identical texts, teacher-forced log-probs
                within 1e-5;
 11. the generate path at full width — llama3.2-3b (bf16, random weights,
                the same vocabulary cut), ``InferenceEngine(max_slots=32,
                max_seq=1024)``: launch counters set to 0, then ``sem_map``
                over 64 records (64 new tokens each) and
                ``sem_agg_hierarchical`` (fanout 8) over the notes, through
                ``EngineModel``; ``decode_attention`` must have launched 28
                times per decode step and ``flash_attention`` 28 times per
                prefill, and every request must end done, none failed or
                retried.  Time to first token, the decode step at 32 active
                slots, generated tokens/s, peak memory, and one decode step
                by kernel (profiler; every device function named
                ``decode_attention_*`` counts, and it must read more than 0
                ms);
 12. generate agreement — the kernel path against the plain path
                (``attn_impl="full"``) teacher-forced over 32 sequences x 64
                generated positions: bf16 through 28 layers to
                GEN_BF16_LOGPROB_TOL (a limit that a second correct plain
                path meets and two gross faults exceed), f32 through 4
                layers to 1e-4;
 13. paged decode — ``engine/paged.py`` against contiguous decode at full
                width (8 rows, pages of 16), its kernel launches counted;
 14. the SemFrame main path — benchmarks/pipeline_bench.py's pipeline
                (filter broad 0.85 -> filter selective 0.15 -> gold join ->
                topk 10) over the paper's BioDEX size, 250 articles x 24,000
                reaction labels at width 384, launch counters set to 0:
                eagerly and lazily with rule 4 off (records must be equal;
                this check, which launches no kernel, joins the first 4,000
                labels for the host's gold joins); the optimizer's default
                plan (rule 4's prefilter through an exact index; its pairs
                must be true pairs of the world) under the profiler (device
                idle share); the pipeline with a cascade join under each
                ``force_plan`` (sim-filter, project-sim-filter: the left x
                right similarity plane and the projected plane); a lazy
                ``sem_sim_join`` (k 10) whose index the plan picks under the
                serving layer's ``index_shared``; and gold and cascade
                ``sem_group_by`` over 10,000 topic records into 8 groups.
                Each of these calls must have launched ``similarity``, or
                the scan of the index the plan picked.  The gold calls run
                again through the plain versions and must give the same
                records (``sim_score`` within TOL), bills, details and plan
                text.  The cascades read thresholds from quantile ranks of
                their planes, which two fp32 planes agreeing to TOL order
                otherwise among near-equal scores: each plane is held to the
                plain version's within TOL (the scores ranked otherwise are
                counted), and the cascades run through the plain versions on
                the kernels' planes must give the same records, bills and
                thresholds.
 15. serving at full width — ``make_session`` builds the oracle
                (llama3.2-3b at its published widths, vocab cut to 384 as in
                phases 8 and 11) and a proxy of the same widths cut to 4
                layers; the embedder is E5_SMALL at its published widths (12
                layers, d 384, 12 heads, ff 1536, f32; it replaces
                make_session's 2-layer default).  ``Gateway(max_inflight=4)``
                serves 8 sessions over 2 tenants, launch counters set to 0,
                under the profiler: 4 run launch/serve.py's engine pipeline
                (sem_map -> sem_filter) over 64 records of 300-480 bytes, two
                pairs sharing their records; 4 run a lazy ``sem_search`` (k
                10, exact: ``similarity``) over 20,000 passages that E5-small
                embeds once through the IndexRegistry.  Every session must
                end done, no generate request failed or retried, the index
                built once and hit by the others, every prompt and text reach
                its model exactly once (backend prompts = unique prompts),
                sessions that share a pipeline return identical records, and
                ``flash_attention`` must have launched 12 times an embedder
                batch (f32 non-causal) and 28 times an oracle prefill or
                scoring forward (bf16 causal), ``decode_attention`` 28 times a
                decode step.  Sessions/s, p50/p95 latency, fusion, cache and
                the device idle share are printed.  The embedder's kernel
                path against its plain path (``attn_impl="full"``) on the
                card: embeddings within EMB_TOL, the searches' top-10 ids
                equal up to near-ties;
 16. a continuous query and the CLI — a ``CorpusTable`` of 200,000 rows
                of phase 2's mixture gets four commits of 5,000 appended rows (a spill of 0.10: no
                retrain); ``Gateway.subscribe`` runs a lazy ``sem_sim_join``
                (k 10, fp32 IVF) of 256 queries over it, which reaches
                ``cluster_scan`` and, for the delta buffer, ``similarity``.
                One build and four delta updates in the registry, only the
                delta rows embedded after the first emission, recall@10 of
                each emission against an exact search over its version's
                snapshot >= 0.90, and the index's kernel path equal to its
                plain path (top-10 ids, up to near-ties).  Then
                ``python -m repro_torch.launch.serve`` as subprocesses on
                the card: the simulated backend (8 sessions, 2 tenants, 400
                records, ``--audit``, a metrics dump that must parse) and the
                engine backend (4 sessions at make_session's defaults); each
                must print every session done.

Phases 15 and 16's launch counts are printed on a line of their own,
``serving launches {...}``.  The second-to-last line of output is ``{"kernels": [...]}``, whose
``clock`` says how ``ms`` and ``library_ms`` were timed ("profiler": device
time; "events": CUDA events, host launch gaps included) and ``plain_clock``
the same of ``plain_ms``; the last is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

import repro_torch  # noqa: E402
from repro_torch.common import flatten  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.core.backends import synth  # noqa: E402
from repro_torch.core.backends.simulated import (SimConfig,  # noqa: E402
                                                 SimulatedEmbedder, SimulatedModel)
from repro_torch.core.backends.testing import CountingBackend  # noqa: E402
from repro_torch.core.backends.torch_engine import EngineModel, make_session  # noqa: E402
from repro_torch.core.frame import SemFrame, Session  # noqa: E402
from repro_torch.core.operators import groupby as sf_groupby  # noqa: E402
from repro_torch.core.operators import join as sf_join  # noqa: E402
from repro_torch.core.operators.agg import sem_agg_hierarchical  # noqa: E402
from repro_torch.core.operators.mapex import sem_map  # noqa: E402
from repro_torch.core.operators.search import (sem_index, sem_search,  # noqa: E402
                                               sem_sim_join)
from repro_torch.core.operators.topk import compare_prompt  # noqa: E402
from repro_torch.data.tokenizer import TOKENIZER  # noqa: E402
from repro_torch.embed.encoder import E5_SMALL, Embedder  # noqa: E402
from repro_torch.engine import engine as engine_mod  # noqa: E402
from repro_torch.engine import paged  # noqa: E402
from repro_torch.engine.engine import InferenceEngine  # noqa: E402
from repro_torch.engine.scheduler import ContinuousBatchScheduler  # noqa: E402
from repro_torch.index.backend import MASKED_SCORE  # noqa: E402
from repro_torch.index.quantile import quantile_calibrate  # noqa: E402
from repro_torch.index.vector_index import VectorIndex  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import decode_attention as kda  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels import ivf_scan as kivf  # noqa: E402
from repro_torch.kernels import ivf_scan_q as kivfq  # noqa: E402
from repro_torch.kernels import rmsnorm as krn  # noqa: E402
from repro_torch.kernels import similarity as ksim  # noqa: E402
from repro_torch.models import attention, layers, registry  # noqa: E402
from repro_torch.obs import parse_exposition, trace  # noqa: E402
from repro_torch.serve import Gateway  # noqa: E402
from repro_torch.stream import CorpusTable  # noqa: E402

DIM = 384              # E5_SMALL's width (src/repro_torch/embed/encoder.py)
E5_ATTN = (64, 256, 256, 12, 12, 32)   # [b, sq, sk, h, hk, hd]: one Embedder batch of 64
                                       # texts at max_len 256, E5_SMALL's heads, f32
N_CLUSTERS = 256       # cut from default_n_clusters(1e6) = 1000: host k-means++ cost
NPROBE = 8             # 3% of the lists per query; a block scans its 8 queries' union
K = 10
N_QUERIES = 256
NOISE = 0.04           # the main corpus: tight clusters, recall@10 near 1
HARD_NOISE = 0.065     # the hard corpus: clusters straddle the IVF lists
HARD_ROWS = 250_000    # the hard corpus's rows, cut from the main corpus's 1M for the
                       # run's time limit (its four host k-means builds are the cost)
TOL = 1e-5             # unit-vector dot products summed in another order

# NVIDIA datasheet peaks (dense): device-memory bytes/s, fp32 FLOP/s outside
# the tensor cores (the retrieval kernels are IEEE fp32 SIMT by contract) and
# bf16 tensor-core FLOP/s (the peak for the oracle's bf16 attention inputs).
PEAKS = {"H100 SXM": (3.35e12, 67e12, 989e12), "H100 PCIe": (2.0e12, 51e12, 756e12),
         "H100 NVL": (3.9e12, 60e12, 835e12)}

_RETRIEVAL = (("similarity", ksim), ("cluster_scan", kivf), ("cluster_scan_q", kivfq))
_KERNELS = _RETRIEVAL + (("flash_attention", kfa), ("rmsnorm", krn),
                         ("decode_attention", kda))
_SOURCES = {"similarity": ("src/repro_torch/kernels/csrc/similarity.cu",
                           "src/repro/kernels/similarity.py:45"),
            "cluster_scan": ("src/repro_torch/kernels/csrc/ivf_scan.cu",
                             "src/repro/kernels/ivf_scan.py:49"),
            "cluster_scan_q": ("src/repro_torch/kernels/csrc/ivf_scan_q.cu",
                               "src/repro/kernels/ivf_scan_q.py:46"),
            "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                "src/repro/kernels/flash_attention.py:64"),
            "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                        "src/repro/kernels/rmsnorm.py:22"),
            "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                                 "src/repro/kernels/decode_attention.py:55")}

ORACLE = "llama3.2-3b"
ROUNDS = 5   # kernel / library timings in turns, for every kernel's row
ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}   # atol + rtol * |plain|
# The oracle's last-token log-probs, kernel path against the plain path
# (attn_impl="full") on the same weights: in f32 they agree to 1e-4 (sums in
# another order through 28 layers).  In bf16 each path rounds at other
# points through 28 layers: on the H100 at seed 0 the kernel path lies 0.080
# from the plain path and a second correct plain path (chunked) 0.076, while
# p rounded to fp8 lies 0.42 or more and a GQA mapping fault 6.
# BF16_LOGPROB_TOL sits between.
F32_LOGPROB_TOL = 1e-4
BF16_LOGPROB_TOL = 0.15
DECISION_MARGIN = 0.1   # decisions must agree wherever |lt - lf| exceeds this


def _faulty_attend(q, k, v, mask, *, scores_dtype=None, p_dtype=None, scale_err=0.0,
                   kv_head_mod=False):
    """The plain attention (``models.attention.gqa_attend`` for Sq > 1) with
    one deliberate fault: the f32 scores rounded to ``scores_dtype``, p
    rounded to ``p_dtype`` before the PV product, the softmax scale off by
    the fraction ``scale_err``, or q-head h reading kv-head ``h % Hk`` in
    place of ``h // (H / Hk)``."""
    h, hk = q.shape[2], k.shape[2]
    if kv_head_mod:
        heads = torch.arange(h, device=k.device) % hk
        k, v = k[:, :, heads], v[:, :, heads]
    else:
        k, v = attention._repeat_kv(k, h), attention._repeat_kv(v, h)
    sc = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float()) * (
        ref.attn_scale(q.shape[-1]) * (1 + scale_err))
    if scores_dtype is not None:
        sc = sc.to(scores_dtype).float()
    p = torch.softmax(torch.where(mask, sc, ref.NEG_INF), dim=-1)
    if p_dtype is not None:
        p = p.to(p_dtype)
    return torch.einsum("bhqs,bshd->bqhd", p.to(v.dtype), v)


# Deliberate faults of the plain path: (name, the type it runs in, whether
# that type's limit must catch it, attention).  With random weights the
# last-token log-probs hardly move under the mild faults (scores rounded to
# bf16, a 1% scale error): on the H100 at seed 0 they stay under 6e-5 in f32
# and under the correct chunked path's distance in bf16, so they are printed
# only, and the kernel phase's check of the attention output itself is what
# holds the kernel to that precision.
_SCORES_BF16 = functools.partial(_faulty_attend, scores_dtype=torch.bfloat16)
_SCALE_ERR = functools.partial(_faulty_attend, scale_err=0.01)
FAULTS = [
    ("scores in bf16", "float32", False, _SCORES_BF16),
    ("scale +1%", "float32", False, _SCALE_ERR),
    ("scores in bf16", "bfloat16", False, _SCORES_BF16),
    ("scale +1%", "bfloat16", False, _SCALE_ERR),
    ("p in fp8", "bfloat16", True, functools.partial(
        _faulty_attend, p_dtype=torch.float8_e4m3fn)),
    ("kv-head h % Hk", "bfloat16", True, functools.partial(
        _faulty_attend, kv_head_mod=True)),
]


@contextlib.contextmanager
def plain_attention(attend):
    """Run the model's plain attention (``attn_impl="full"``) as ``attend``."""
    saved = attention.gqa_attend
    attention.gqa_attend = attend
    try:
        yield
    finally:
        attention.gqa_attend = saved


def log(*a):
    print(*a, flush=True)


_LAP = [time.perf_counter()]


def lap(phase: str) -> None:
    """Print the wall seconds since the previous phase ended."""
    now = time.perf_counter()
    log(f"phase {phase}: {now - _LAP[0]:.1f} s")
    _LAP[0] = now


def peaks(name: str) -> tuple[str, float, float, float]:
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


def device_ms(fn, reps: int, tries: int = 3) -> float | None:
    """Device time of one call of ``fn`` from the profiler's kernel and copy
    records of ``reps`` calls, or None when the profiler kept no record in
    ``tries`` windows.  CUDA events around a call also count the host's
    launch time, which on a busy host exceeds a decode kernel's own tenth of
    a millisecond; the profiler counts device time alone.

    Deep into this script's run the profiler loses some of a window's
    records: 16 of cuDNN SDPA's 20 (a kernel and a memset per call), or 5 of
    10 kernel launches, now and then all of them, where a fresh process
    keeps them all (H100, torch 2.11).  A sum over the records divided by
    ``reps`` then reads low (by a third for the flash kernel).  So each
    record name counts with its mean duration times its launches per call,
    ceil(records / reps), which is exact while fewer than ``reps`` records
    of a name are lost.  A window that lost records is reported; one with
    none is profiled again, up to ``tries`` times (three empty windows in a
    row happened once, timing the f32 decode kernel)."""
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
            break
        log(f"device_ms: the profiler kept no record of {reps} calls, profiled again")
    else:
        log(f"device_ms: the profiler kept no record of {reps} calls in {tries} windows")
        return None
    lost = [f"{e.key[:40]} {e.count}" for e in dev if e.count % reps]
    if lost:
        log(f"device_ms: the profiler kept {', '.join(lost)} records of {reps} calls")
    us = sum(e.self_device_time_total / e.count * -(-e.count // reps) for e in dev)
    return us / 1e3


def plain_ms(fn, reps: int) -> tuple[float, str]:
    """(ms, clock) of a plain version: ``device_ms`` ("profiler"), or the
    median CUDA-event time of a call ("events", host launch gaps included)
    where the profiler kept no record.  The clock goes into the kernels line
    as ``plain_clock``; no kernel / library ratio reads this time."""
    ms = device_ms(fn, reps)
    return (ms, "profiler") if ms is not None else (cuda_ms(fn, reps), "events")


def profiled(fn, tries: int = 3) -> tuple[float, list]:
    """(wall ms, the device records) of one call of ``fn`` under the
    profiler; a window that kept no device record is profiled again, up to
    ``tries`` times (the fault ``device_ms`` describes), and after that the
    records are empty."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        recs = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        if recs:
            return wall, recs
        log("profiled: the profiler kept no device record, profiled again")
    return wall, []


def interleaved_ms(kernel, library, reps: int) -> tuple[float, float, list[float]]:
    """``device_ms`` of ``kernel`` and of ``library`` in turns over ROUNDS
    rounds, so that a drift of the card's clocks reaches both: -> (median
    kernel ms, median library ms, the ratio of each round).  A round in
    which the profiler kept no record of either side is left out of the
    medians and ratios and reported; with no round left this fails, so both
    times are always the profiler's device time."""
    ks, ls = [], []
    for r in range(ROUNDS):
        a, b = device_ms(kernel, reps), device_ms(library, reps)
        if a is None or b is None:
            log(f"interleaved_ms: round {r + 1} of {ROUNDS} left out, the profiler kept no "
                f"record of the {'kernel' if a is None else 'library call'}")
            continue
        ks.append(a)
        ls.append(b)
    assert ks, f"the profiler kept no record in any of {ROUNDS} rounds"
    return statistics.median(ks), statistics.median(ls), [a / b for a, b in zip(ks, ls)]


def misaligned(shape, dt, g) -> torch.Tensor:
    """A contiguous CUDA tensor of ``shape`` whose data starts one element
    past an allocation: rows not 16-byte aligned, so a kernel takes scalar
    loads; drawn from the generator ``g``."""
    buf = torch.randn(int(np.prod(shape)) + 1, device="cuda", generator=g).to(dt)
    return buf[1:].view(shape)


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
        idx = np.fromiter((int(t[2:]) for t in texts), np.int64, len(texts))
        # a dispatcher may fuse corpus and query texts into one batch
        is_q = np.fromiter((t[0] == "q" for t in texts), bool, len(texts))
        out = np.empty((len(texts), self.dim), np.float32)
        out[~is_q], out[is_q] = self.rows["c"][idx[~is_q]], self.rows["q"][idx[is_q]]
        return out


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


def topk_agree(got: torch.Tensor, want: torch.Tensor, k: int, tol: float = TOL) -> int:
    """The top-k ids of each row of a kernel's scores against the plain
    version's: a row whose ids differ is allowed only where the plain scores
    of the two id lists agree to ``tol`` (a near-tie).  -> rows with
    identical ids."""
    gi = torch.topk(got, k, dim=1).indices
    wv, wi = torch.topk(want, k, dim=1)
    same = (gi == wi).all(dim=1)
    if not bool(same.all()):
        gap = float((want.gather(1, gi) - wv).abs()[~same].max())
        assert gap <= tol, f"top-{k} ids differ beyond a near-tie: {gap}"
    return int(same.sum())


def distinct_pairs(probes: torch.Tensor) -> torch.Tensor:
    """The cluster of each distinct (query block, cluster) pair of probes
    [nb, slots] whose id lies in [0, kc) (ivf_probes gives no other)."""
    srt = probes.long().sort(dim=1).values
    first = torch.ones_like(srt, dtype=torch.bool)
    first[:, 1:] = srt[:, 1:] != srt[:, :-1]
    return srt[first]


def retrieval_row(name, shape, err, run, plain_fn, lib_fn, lib_name, reps, nbytes, flops,
                  bw, fp32) -> dict:
    """Time a retrieval kernel by profiler device time, in turns with its
    library call (``interleaved_ms``; alone when there is none), and its
    plain version by ``plain_ms``; print its rates beside the bound."""
    if lib_fn is not None:
        ms, lib, ratios = interleaved_ms(run, lib_fn, reps)
    else:
        ms, lib, ratios = device_ms(run, reps), None, []
        assert ms is not None, f"{name}: the profiler kept no record"
    plain, pclock = plain_ms(plain_fn, 3)
    bms, by = bound(nbytes, flops, bw, fp32)
    log(f"{name} {shape}, device time (profiler): kernel {ms:.4f} ms "
        f"({nbytes / ms / 1e6:.0f} GB/s, {flops / ms / 1e9:.1f} TFLOP/s, {bms / ms:.3f} of "
        f"the {by} bound {bms:.4f} ms), plain {plain:.4f} ms ({pclock}), {lib_name} "
        + (f"{lib:.4f} ms; median kernel / library {statistics.median(ratios):.3f} (each "
           "round: " + ", ".join(f"{r:.3f}" for r in ratios) + ")" if lib is not None
           else "not timed"))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms,
                bound_by=by, nbytes=nbytes, flops=flops, clock="profiler", plain_clock=pclock,
                shape=shape)


def kernel_phase(args, idx_exact, idx_ivf, idx_q, queries, bw, fp32) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    dev = torch.device("cuda")
    out = {}
    q = torch.from_numpy(queries).to(dev)

    # similarity: the exact join's shape (its top-10 ids against the plain
    # version's, two calls bit for bit), then ragged and misaligned edges
    c = idx_exact._device_vectors(idx_exact.vectors)
    got, want = ksim.similarity(q, c), ref.similarity_ref(q, c)
    err = float((got - want).abs().max())
    assert err <= TOL, err
    same = topk_agree(got, want, K)
    assert torch.equal(got, ksim.similarity(q, c)), "similarity: two calls differ"
    log(f"similarity q[{q.shape[0]},{DIM}] x c[{c.shape[0]},{DIM}]: max abs err {err:.3g}, "
        f"top-{K} ids identical to the plain version's in {same} of {q.shape[0]} rows "
        "(others near-ties), two calls identical")
    del got, want
    g = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    for case in [(37, 1001, 17), (1, 129, 3), (65, 300, DIM), (128, 256, 32),
                 (129, 1001, 383), (300, 40000, 64), "misaligned"]:
        if case == "misaligned":
            a, b = misaligned((70, DIM), torch.float32, g), misaligned((300, DIM), torch.float32, g)
        else:
            nq, nc, d = case
            a = torch.randn(nq, d, device=dev, generator=g)
            b = torch.randn(nc, d, device=dev, generator=g)
        err = max(err, float((ksim.similarity(a, b) - ref.similarity_ref(a, b)).abs().max()))
        a, b = a / a.norm(dim=1, keepdim=True), b / b.norm(dim=1, keepdim=True)
        err = max(err, float((ksim.similarity(a, b, normalize=False)
                              - ref.similarity_ref(a, b, normalize=False)).abs().max()))
    assert err <= TOL, err
    nq, nc = q.shape[0], c.shape[0]
    norm = torch.nn.functional.normalize
    # the shape of sem_search (one query; printed only, not the kernel's row)
    q1 = q[:1]
    ms1, lib1, r1 = interleaved_ms(lambda: ksim.similarity(q1, c),
                                   lambda: torch.matmul(norm(q1, dim=1), norm(c, dim=1).T), 10)
    log(f"similarity q[1,{DIM}] x c[{nc},{DIM}] (sem_search's shape), device time (profiler): "
        f"kernel {ms1:.4f} ms ({4 * DIM * nc / ms1 / 1e6:.0f} GB/s of corpus), F.normalize + "
        f"matmul {lib1:.4f} ms, median kernel / library {statistics.median(r1):.3f}")
    out["similarity"] = retrieval_row(
        "similarity", f"q[{nq},{DIM}] x c[{nc},{DIM}]", err, lambda: ksim.similarity(q, c),
        lambda: ref.similarity_ref(q, c),
        lambda: torch.matmul(norm(q, dim=1), norm(c, dim=1).T), "F.normalize + matmul", 10,
        4 * DIM * (nq + nc) + 4 * nq * nc, 2 * nq * nc * DIM, bw, fp32)

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
        got, want = run(), plain_fn()
        err = plane_err(got, want)
        same = topk_agree(got, want, K)
        assert torch.equal(got, run()), f"{name}: two calls differ"
        log(f"{name}: max abs err {err:.3g}, top-{K} ids identical to the plain version's "
            f"in {same} of {got.shape[0]} rows (others near-ties), two calls identical")
        del got, want
        # ragged edges: d=17, 33 and 1000, block sizes 1 to 16, L no multiple
        # of 128, normalize in-kernel; int8 rows also 1 byte past a 16-byte
        # boundary (byte loads)
        gg = torch.Generator(device="cuda").manual_seed(args.seed + 2)
        for kc, L, d, bq, skew in [(6, 128, 17, 8, 0), (5, 256, DIM, 4, 0), (7, 128, 64, 16, 0),
                                   (5, 300, DIM, 2, 0), (4, 77, 1000, 1, 0),
                                   (5, 200, 33, 8, 0), (5, 300, DIM, 8, 1)]:
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
                buf = torch.randint(-128, 128, (kc * L * d + skew,), device=dev, generator=gg,
                                    dtype=torch.int8)
                sq = buf[skew:].view(kc, L, d)
                sc = torch.rand(kc, L, device=dev, generator=gg) / (127 * d ** 0.5)
                e = plane_err(kivfq.cluster_scan_q(qq, sq, sc, mk, pb, block_q=bq),
                              ref.ivf_scan_q_ref(qq, sq, sc, mk, pb, block_q=bq))
            err = max(err, e)
        kc, L, _ = tiles.shape
        nbp, slots = probes.shape
        sizes = dv["store_mask"].sum(dim=1)                    # valid rows per cluster
        pairs = distinct_pairs(probes)
        # scored (query, row) pairs: a block that probed one cluster from
        # several slots needs its scores once (the other strips are copies)
        valid_lanes = float(sizes[pairs].sum()) * 8
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
        lib_fn = None
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
        else:
            log(f"{name}: library einsum skipped, it may need "
                f"{need / 2**30:.1f} GiB of {free / 2**30:.1f} GiB free")
        out[name] = retrieval_row(
            name, f"q[{qp.shape[0]},{DIM}] probes[{nbp},{slots}] tiles[{kc},{L},{DIM}] "
                  f"distinct_probed={len(uniq)} distinct_pairs={len(pairs)}", err, run,
            plain_fn, lib_fn,
            "gathered einsum", 5, nbytes, flops, bw, fp32)
        torch.cuda.empty_cache()
        # the shape of sem_search (one query padded to one block of 8, as
        # ivf_search pads it; printed only, not the kernel's row)
        q1, _ = ref.pad_queries(q[:1], 8)
        q1 = ref._unitize(q1)
        pb1 = ref.ivf_probes(q1, idx_ivf._dev["centroids"], NPROBE, 8)
        pl1 = pb1.long()
        if name == "cluster_scan":
            run1 = lambda: kivf.cluster_scan(q1, dv["store"], dv["store_mask"], pb1,
                                             normalize=False)
            plain1 = lambda: ref.ivf_scan_ref(q1, dv["store"], dv["store_mask"], pb1,
                                              normalize=False)
            lib1 = lambda: torch.where(
                dv["store_mask"][pl1][:, None] > 0,
                torch.einsum("bqd,bsld->bqsl", q1[None], dv["store"][pl1]), MASKED_SCORE)
        else:
            run1 = lambda: kivfq.cluster_scan_q(q1, dv["store_q"], dv["store_scales"],
                                                dv["store_mask"], pb1, normalize=False)
            plain1 = lambda: ref.ivf_scan_q_ref(q1, dv["store_q"], dv["store_scales"],
                                                dv["store_mask"], pb1, normalize=False)
            lib1 = lambda: torch.where(
                dv["store_mask"][pl1][:, None] > 0,
                torch.einsum("bqd,bsld->bqsl", q1[None], dv["store_q"][pl1].float())
                * dv["store_scales"][pl1][:, None], MASKED_SCORE)
        got, want = run1(), plain1()
        e1 = plane_err(got, want)
        assert torch.equal(got, run1()), f"{name}, one query: two calls differ"
        del got, want
        u1 = torch.unique(pl1)
        ms1, lib1_ms, r1 = interleaved_ms(run1, lib1, 5)
        b1 = int(sizes[u1].sum()) * row_bytes
        log(f"{name} q[8,{DIM}] probes[1,{pb1.shape[1]}] (sem_search's shape: one query "
            f"padded to a block, {len(u1)} distinct clusters), device time (profiler): kernel "
            f"{ms1:.4f} ms ({b1 / ms1 / 1e6:.0f} GB/s of valid rows), gathered einsum "
            f"{lib1_ms:.4f} ms, median kernel / library {statistics.median(r1):.3f}; max abs "
            f"err {e1:.3g}, two calls identical")
        torch.cuda.empty_cache()
    for name, r in out.items():
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
        results[name] = dict(ids=ids, scores=scores, search_s=dt, details=st)
    launches = {name: mod.launches for name, mod in _KERNELS}
    return results, launches


def plain_path_agrees(query_texts, emb, indexes, results) -> None:
    """Every join of the counted main path again through the plain versions
    on the card (``ops.DEFAULT_IMPL = "ref"``): the top-K ids of each query
    must be the kernel path's, a row that differs only where the scores at
    each rank agree to TOL (a near-tie)."""
    saved = ops.DEFAULT_IMPL
    ops.DEFAULT_IMPL = "ref"
    try:
        plain = {name: sem_sim_join(query_texts, idx, emb, k=K)[:2]
                 for name, idx in indexes.items()}
    finally:
        ops.DEFAULT_IMPL = saved
    for name, (scores, ids) in plain.items():
        got_ids, got = results[name]["ids"], results[name]["scores"]
        same = (got_ids == ids).all(axis=1)
        gap = float(np.abs(got - scores)[~same].max()) if (~same).any() else 0.0
        assert gap <= TOL, f"{name}: ids differ from the plain path beyond a near-tie ({gap})"
        log(f"sem_sim_join {name}: top-{K} ids identical to the plain path's (the plain "
            f"versions on the card) in {int(same.sum())} of {len(same)} queries, max score "
            f"difference at a rank {float(np.abs(got - scores).max()):.3g}")


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
    rows = min(args.rows, HARD_ROWS)
    log(f"cut: hard corpus rows {rows} (main corpus {args.rows})")
    corpus, queries = make_corpus(rows, args.seed + 3, HARD_NOISE)
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
    before = {name: mod.launches for name, mod in _RETRIEVAL}
    gpu = run()
    after = {name: mod.launches for name, mod in _RETRIEVAL}
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

    def lazy_run():
        """A lazy SemFrame pipeline whose prefilter (rule 4, at a low
        threshold) and pivot-guided top-k score through the exact index."""
        left, right, world = biodex_world(300, 11)
        slog: list = []
        lz = (sf_frame(left[:60], world, slog).lazy().sem_filter(SF_BROAD)
              .sem_join(right, SF_JOIN).sem_topk(SF_RANK, 5, pivot_query="highest accuracy"))
        kw = {"prefilter_threshold": 1000}
        return lz.collect(**kw).records, no_wall(slog), lz.explain(**kw)
    before = retrieval_counts()
    gpu = lazy_run()
    n = retrieval_counts()["similarity"] - before["similarity"]
    assert n > 0, n
    repro_torch.set_device("cpu")
    try:
        cpu = lazy_run()
    finally:
        repro_torch.set_device(None)
    assert gpu[0] == cpu[0] and gpu[1] == cpu[1] and gpu[2] == cpu[2]
    log(f"small end to end: a lazy SemFrame pipeline (filter -> join with rule 4's "
        f"prefilter -> pivot-guided topk) on the card == on the CPU: {len(gpu[0])} records, "
        f"{bill(gpu[1])}, similarity launches {n}")


def close_err(got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """Max abs error; every element within ``tol + tol * |want|``."""
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
    g, w = got.float(), want.float()
    assert bool(torch.isfinite(g).all()), "non-finite output"
    diff = (g - w).abs()
    bad = int((diff > tol + tol * w.abs()).sum())
    assert bad == 0, f"{bad} elements beyond {tol}; max abs error {float(diff.max())}"
    return float(diff.max())


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest distance between two bf16 tensors in units in the last place."""
    def key(t):
        bits = t.view(torch.int16).long()
        return torch.where(bits >= 0, bits, -(bits & 0x7FFF))
    return int((key(got) - key(want)).abs().max())


def tensor_core_ops(symbol: str) -> dict[str, int]:
    """The tensor-core instructions (HGMMA: wgmma; HMMA: mma.sync) in the
    SASS of each instance of the kernel ``symbol`` in the built
    flash_attention library, by ``cuobjdump -sass``."""
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build.library_path("flash_attention"))],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            if symbol in fn:
                counts[fn] = 0
        elif fn in counts and ("HGMMA" in line or "HMMA" in line):
            counts[fn] += 1
    return counts


def ptxas_report(name: str) -> list[tuple[str, str, str]]:
    """(kernel instance, registers and shared memory, spills) of each entry
    function in the ``nvcc -Xptxas -v`` log of the ``name`` library, names
    demangled by the toolkit's ``cu++filt`` where it has one; empty when
    the library has no log beside it."""
    path = _build.library_path(name).with_suffix(".log")
    if not path.exists():
        return []
    fns, used, spills, cur = [], {}, {}, None
    for line in path.read_text().splitlines():
        if "Compiling entry function" in line:
            cur = line.split("'")[1]
            fns.append(cur)
        elif "Function properties for" in line:
            cur = line.rsplit(" ", 1)[1].strip()
        elif "spill stores" in line and cur is not None:
            spills[cur] = line.strip()
        elif "Used" in line and cur is not None:
            used[cur] = line.split(":", 1)[1].strip()
    filt = os.path.join(os.path.dirname(_build.nvcc()), "cu++filt")
    names = fns
    if fns and os.path.exists(filt):
        names = subprocess.run([filt], input="\n".join(fns), capture_output=True, text=True,
                               check=True).stdout.splitlines()
    short = [re.sub(r"\((unsigned )?int\)|<unnamed>::|\(anonymous namespace\)::", "", n)
             .split("(")[0] for n in names]
    return [(n, used.get(f, "?"), spills.get(f, "?")) for n, f in zip(short, fns)]


def bound(nbytes: float, flops: float, bw: float, peak: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / bw, flops / peak
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def oracle_kernel_phase(args, bw, fp32, bf16) -> dict:
    """flash_attention and rmsnorm against their plain versions at the
    oracle's shapes and at ragged edges, timed beside bound and library."""
    dev = torch.device("cuda")
    g = torch.Generator(device="cuda").manual_seed(args.seed + 4)
    cfg = get_config(ORACLE)
    B, S, H, HK, HD, D = 32, 512, cfg.num_heads, cfg.num_kv_heads, cfg.hd, cfg.d_model
    f32, b16 = torch.float32, torch.bfloat16
    out = {}

    def qkv(b, sq, sk, h, hk, hd, dt):
        return (torch.randn(b, sq, h, hd, device=dev, generator=g).to(dt),
                torch.randn(b, sk, hk, hd, device=dev, generator=g).to(dt),
                torch.randn(b, sk, hk, hd, device=dev, generator=g).to(dt))

    # bf16 runs the tensor-core kernel, f32 the SIMT one; the bf16 cases reach
    # the tensor-core kernel's edges: hd 20 and 100 (rows not 16-byte aligned:
    # scalar loads), hd 24 and 64 (zero-padded to 64), Sq and Sk no multiple of
    # its 64-row tiles, one prefill, H/Hk 8, rows no key may see, misaligned
    # pointers
    err = 0.0
    for shape, dt, causal, window in [
            ((B, S, S, H, HK, HD), b16, True, 0),        # the oracle's shape
            ((B, S, S, H, HK, HD), f32, True, 0),
            ((1, S, S, H, HK, HD), b16, True, 0),        # one prefill [1, 512]
            ((4, S, S, H, HK, HD), b16, True, 128),      # sliding window
            ((4, 300, S, H, HK, HD), b16, True, 0),      # Sq < Sk
            ((2, 129, 191, H, HK, HD), b16, True, 0),    # Sq, Sk no multiple of 64
            ((4, S, 300, H, HK, HD), b16, True, 64),     # Sq > Sk + window: empty rows
            ((4, S, 300, H, HK, HD), f32, True, 64),
            ((4, S, S, 8, 2, 64), b16, True, 0),         # hd 64
            ((2, 100, 100, 4, 2, 24), b16, True, 0),     # hd 24
            ((2, 100, 100, 4, 2, 20), b16, False, 0),    # hd 20: unaligned rows
            ((1, 130, 130, 8, 1, 100), b16, True, 0),    # H/Hk 8, hd 100
            ((3, 77, 77, 8, 4, 16), f32, True, 0),       # hd 16, odd S
            ((3, 77, 77, 8, 4, 16), b16, False, 8),
            ((2, 129, 61, 4, 2, 16), f32, False, 0),
            (E5_ATTN, f32, False, 0),                    # the E5 embedder's shape
            ("misaligned", b16, True, 0)]:
        if shape == "misaligned":
            shape = (2, 96, 96, 4, 2, HD)
            q, k, v = (misaligned((2, 96, h, HD), dt, g) for h in (4, 2, 2))
        else:
            q, k, v = qkv(*shape, dt)
        e = close_err(kfa.flash_attention(q, k, v, causal=causal, window=window),
                      ref.flash_attention_ref(q, k, v, causal=causal, window=window),
                      ATTN_TOL[dt])
        log(f"flash_attention [b,sq,sk,h,hk,hd]={list(shape)} {dt} causal={causal} "
            f"window={window}{' misaligned' if q.data_ptr() % 16 else ''}: "
            f"max abs err {e:.3g} (tol {ATTN_TOL[dt]} + rel)")
        err = max(err, e)
    tc = tensor_core_ops(kfa.KERNEL_NAMES[b16])
    log(f"flash_attention bf16 SASS (cuobjdump -sass): tensor-core instructions per "
        f"instance {tc}")
    assert tc and all(n > 0 for n in tc.values()), f"no HGMMA/HMMA in the bf16 kernel: {tc}"

    sdpa = torch.nn.functional.scaled_dot_product_attention
    pairs = S * (S + 1) // 2                               # unmasked (q, k) per head
    flops = 4 * B * H * HD * pairs
    for dt in (b16, f32):
        q, k, v = qkv(B, S, S, H, HK, HD, dt)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ms, lib, ratios = interleaved_ms(
            lambda: kfa.flash_attention(q, k, v, causal=True),
            lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True), 10)
        plain, pclock = plain_ms(lambda: ref.flash_attention_ref(q, k, v, causal=True), 3)
        ev = cuda_ms(lambda: kfa.flash_attention(q, k, v, causal=True), 10)
        nbytes = q.element_size() * (q.numel() + k.numel() + v.numel() + q.numel())
        bms, by = bound(nbytes, flops, bw, bf16 if dt == b16 else fp32)
        log(f"flash_attention q[{B},{S},{H},{HD}] k/v[{B},{S},{HK},{HD}] {dt} causal, "
            f"device time (profiler): kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
            f"TFLOP/s), plain {plain:.4f} ms ({pclock}), SDPA {lib:.4f} ms "
            f"({flops / lib / 1e9:.1f} TFLOP/s); bound {bms:.4f} ms ({by}); median kernel / SDPA "
            f"{statistics.median(ratios):.3f}; kernel by CUDA events {ev:.4f} ms")
        log(f"  kernel / SDPA in each of {len(ratios)} rounds: "
            + ", ".join(f"{r:.3f}" for r in ratios))
        if dt == b16:
            out["flash_attention"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms,
                bound_by=by, nbytes=nbytes, flops=flops, clock="profiler", plain_clock=pclock,
                shape=f"q[{B},{S},{H},{HD}] k/v[{B},{S},{HK},{HD}] bf16 causal")
        del q, k, v, qt, kt, vt
    e5_attention_row(g, bw, fp32)

    # the register path (rows of up to 8192 bf16 / 4096 f32 values, here one
    # row and rows no multiple of the persistent blocks' share) and the
    # two-pass fallback (wider, odd or misaligned rows)
    err = 0.0
    for shape in [(B * S, D), (1, D), (3001, D), (2500, 8192), (300, 16384), (1000, D - 1),
                  (37, 17), (5, 7, 8), "misaligned"]:
        for dt in (b16, f32):
            if shape == "misaligned":
                x = misaligned((40, D), dt, g)
            else:
                x = torch.randn(shape, device=dev, generator=g).to(dt)
            sc = torch.randn(x.shape[-1], device=dev, generator=g)
            got, want = krn.rmsnorm(x, sc, eps=1e-5), ref.rmsnorm_ref(x, sc, eps=1e-5)
            if dt == b16:
                u = bf16_ulps(got, want)
                assert u <= 1, f"rmsnorm {shape} bf16: {u} ulps"
            err = max(err, close_err(got, want, 1e-5 if dt == f32 else 1e-2))
    x = torch.randn(B * S, D, device=dev, generator=g).to(b16)
    sc = torch.randn(D, device=dev, generator=g)
    sc16 = sc.to(b16)
    ms, lib, ratios = interleaved_ms(
        lambda: krn.rmsnorm(x, sc, eps=1e-5),
        lambda: torch.nn.functional.rms_norm(x, (D,), sc16, eps=1e-5), 20)
    plain, pclock = plain_ms(lambda: ref.rmsnorm_ref(x, sc, eps=1e-5), 10)
    nbytes = 2 * x.numel() * 2 + D * 4
    bms, by = bound(nbytes, 4 * x.numel(), bw, fp32)
    out["rmsnorm"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                          bound_ms=bms, bound_by=by, nbytes=nbytes, flops=4 * x.numel(),
                          clock="profiler", plain_clock=pclock,
                          shape=f"x[{B * S},{D}] bf16, scale[{D}] f32")
    log(f"rmsnorm x[{B * S},{D}] bf16, device time (profiler): kernel {ms:.4f} ms "
        f"({nbytes / ms / 1e6:.0f} GB/s, {bms / ms:.3f} of the {by} bound {bms:.4f} ms at "
        f"{bw / 1e9:.0f} GB/s), plain {plain:.4f} ms ({pclock}), F.rms_norm {lib:.4f} ms "
        f"({nbytes / lib / 1e6:.0f} GB/s); "
        f"median kernel / F.rms_norm {statistics.median(ratios):.3f} (each round: "
        + ", ".join(f"{r:.3f}" for r in ratios) + f"); max abs err over all cases "
        f"{err:.3g} (f32 within 1e-5, bf16 within one ulp)")
    for name, r in out.items():
        log(f"kernel {name}: {r['shape']} err={r['max_abs_err']:.3g} ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) bytes={r['nbytes']} "
            f"flops={r['flops']}")
    torch.cuda.empty_cache()
    return out


def e5_attention_row(g, bw, fp32) -> None:
    """flash_attention at the E5 embedder's shape (f32, non-causal, hd 32:
    the SIMT kernel), timed beside SDPA and the bound; printed only, the
    kernel's row stays the oracle's bf16 shape."""
    b, s, _, h, hk, hd = E5_ATTN
    q, k, v = (torch.randn(b, s, n, hd, device="cuda", generator=g) for n in (h, hk, hk))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms, lib, ratios = interleaved_ms(lambda: kfa.flash_attention(q, k, v, causal=False),
                                     lambda: sdpa(qt, kt, vt), 10)
    plain, pclock = plain_ms(lambda: ref.flash_attention_ref(q, k, v, causal=False), 5)
    flops = 4 * b * h * hd * s * s
    nbytes = 4 * (2 * q.numel() + k.numel() + v.numel())
    bms, by = bound(nbytes, flops, bw, fp32)
    log(f"flash_attention E5 q/k/v[{b},{s},{h},{hd}] f32 non-causal, device time "
        f"(profiler): kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
        f"{plain:.4f} ms ({pclock}), SDPA {lib:.4f} ms; bound {bms:.4f} ms ({by}; the "
        f"kernel reaches {bms / ms:.3f} of it); "
        f"median kernel / SDPA {statistics.median(ratios):.3f} (each round: "
        + ", ".join(f"{r:.3f}" for r in ratios) + ")")


_WORDS = ("the", "claim", "evidence", "report", "study", "shows", "that", "model",
          "data", "result", "supports", "city", "river", "found", "in", "a", "was",
          "not", "of", "1998", "measured", "average", "increase", "population")


def oracle_prompts(n: int, seed: int, lo: int = 300, hi: int = 480) -> list[str]:
    """``n`` predicate prompts of ``lo``..``hi`` bytes made from ``seed``."""
    rng = np.random.default_rng(seed)
    tail = "\nIs the claim true? Answer <true> or <false>.\nAnswer:"
    out = []
    for _ in range(n):
        m = max(int(rng.integers(lo, hi + 1)) - len(tail) - len("Claim: "), 0)
        body = " ".join(_WORDS[i] for i in rng.integers(0, len(_WORDS), m // 3))
        out.append("Claim: " + body[:m].ljust(m, ".") + tail)
    return out


def small_oracle_cuda_vs_cpu(seed: int) -> None:
    """The smoke-size oracle (3 layers, d 64, f32) on the card against the
    same weights on the CPU, whose plain path the tests hold against JAX."""
    cfg = get_smoke(ORACLE).with_(vocab_size=TOKENIZER.vocab_size)
    gpu = InferenceEngine(cfg, seed=seed, max_seq=512)
    repro_torch.set_device("cpu")
    try:
        cpu = InferenceEngine(cfg, gpu.runner.params, max_seq=512)
        prompts = oracle_prompts(40, seed + 1, 16, 600)   # some past max_seq
        n0 = kfa.launches
        lg = gpu._last_logits(prompts)
        assert kfa.launches == n0 + 2 * cfg.num_layers
        lc = cpu._last_logits(prompts)
    finally:
        repro_torch.set_device(None)
    err = float(np.abs(lg - lc).max())
    assert err <= 1e-4, err
    log(f"small oracle ({cfg.num_layers} layers, d {cfg.d_model}, f32): card == CPU "
        f"last-token log-probs within {err:.3g} over 40 prompts")


def agreement(cfg, params, engine, prompts, cmp_prompts, seed: int) -> None:
    """The kernel path (``engine``, bf16) against the plain path
    (``attn_impl="full"``) on the same weights, in f32 and in bf16, for the
    predicate and compare prompts.  Beside them, controls read each limit's
    place: a second correct plain path (the chunked online softmax over
    64-key blocks, which rounds p per block as the kernel does) must stay
    inside it, and each fault in FAULTS marked to be caught must exceed
    it."""
    f32, bf, n = "float32", "bfloat16", engine.runner.max_seq
    paths = {(dt, impl): InferenceEngine(cfg.with_(dtype=dt, attn_impl=impl), params,
                                         max_seq=n)
             for dt, impl in [(f32, "pallas"), (f32, "full"), (bf, "full")]}
    paths[(bf, "pallas")] = engine
    paths[(bf, "chunked")] = InferenceEngine(
        cfg.with_(dtype=bf, attn_impl="chunked", attn_q_chunk=64), params, max_seq=n)
    tol = {f32: F32_LOGPROB_TOL, bf: BF16_LOGPROB_TOL}
    pair_rng = np.random.default_rng(seed + 7)
    checks = []
    for name, ps, (a, b) in [("predicate", prompts, (TOKENIZER.true_id, TOKENIZER.false_id)),
                             ("compare", cmp_prompts, (TOKENIZER.a_id, TOKENIZER.b_id))]:
        lp = {key: eng._last_logits(ps) for key, eng in paths.items()}
        for fault, dt, _, attend in FAULTS:
            with plain_attention(attend):
                lp[(dt, fault)] = paths[(dt, "full")]._last_logits(ps)
        assert all(np.isfinite(v).all() for v in lp.values())
        dist = {key: float(np.abs(v - lp[(key[0], "full")]).max())
                for key, v in lp.items() if key[1] != "full"}
        log(f"{name}: max abs last-token log-prob difference from the plain path of "
            f"the same type, over all {cfg.vocab_size} log-probs of {len(ps)} prompts: "
            + "; ".join(f"{dt} (tol {tol[dt]}): " + ", ".join(
                f"{'kernel' if impl == 'pallas' else impl} {d:.4g}"
                for (t, impl), d in dist.items() if t == dt) for dt in (f32, bf)))
        checks += [(dist[(dt, "pallas")] <= tol[dt], (name, dist)) for dt in (f32, bf)]
        checks += [(dist[(bf, "chunked")] <= tol[bf], (name, dist))]
        checks += [(dist[(dt, f)] > tol[dt], (name, f, dist))
                   for f, dt, caught, _ in FAULTS if caught]
        # With random weights every prompt gets the same answer, so the
        # engine's own decisions (a vs b) cannot disagree; 16 random token
        # pairs per prompt add decisions of both signs.
        ids = np.concatenate([np.broadcast_to([[a, b]], (len(ps), 1, 2)),
                              pair_rng.integers(0, cfg.vocab_size, (len(ps), 16, 2))], 1)
        rows = np.arange(len(ps))[:, None]
        agree = []
        for dt in (f32, bf):
            p = lp[(dt, "full")]
            margin = p[rows, ids[..., 0]] - p[rows, ids[..., 1]]
            clear = np.abs(margin) > DECISION_MARGIN
            for impl in ["pallas"] + [f for f, t, _, _ in FAULTS if t == dt]:
                k = lp[(dt, impl)]
                same = (k[rows, ids[..., 0]] > k[rows, ids[..., 1]]) == (margin > 0)
                if impl == "pallas":
                    checks += [(same[clear].all(), (name, dt, "decisions")),
                               (0 < (margin[clear] > 0).sum() < clear.sum(),
                                (name, dt, "both signs"))]
                    agree.append(f"{dt} kernel {int(same[clear].sum())}/{int(clear.sum())} "
                                 f"({int((margin[clear] > 0).sum())} positive; the engine's "
                                 f"own pair: {int(clear[:, 0].sum())} clear, "
                                 f"{int((margin[:, 0] > 0).sum())} positive)")
                else:
                    agree.append(f"{dt} {impl} {int((~same[clear]).sum())} flipped")
        log(f"{name}: decisions over the engine's pair and 16 random token pairs per "
            f"prompt, identical where the plain path's margin > {DECISION_MARGIN}: "
            + "; ".join(agree))
    for ok, what in checks:
        assert ok, what


def counted_forwards(runner) -> list:
    """Count ``runner.logprobs`` calls (the engine's scoring forwards)."""
    n = [0]
    score = runner.logprobs

    def counted(tokens):
        n[0] += 1
        return score(tokens)
    runner.logprobs = counted
    return n


def oracle_phase(args) -> dict:
    """The LLM oracle at full width, its calls counted; the plain path on the
    card against it; the ops.rmsnorm entry at its activations."""
    full = get_config(ORACLE)
    cfg = full.with_(vocab_size=TOKENIZER.vocab_size)
    assert cfg.attn_impl == "auto"   # the shipped default: the kernel on the card
    log(f"cut: {ORACLE} vocab_size {full.vocab_size} -> {cfg.vocab_size} (the repo's "
        f"byte tokenizer, as core/backends/jax_engine.py builds it)")
    small_oracle_cuda_vs_cpu(args.seed)
    t0 = time.perf_counter()
    engine = InferenceEngine(cfg, seed=args.seed, max_seq=512)
    torch.cuda.synchronize()
    params = engine.runner.params
    leaves = list(flatten(params).values())
    n_params = sum(t.numel() for t in leaves)
    log(f"oracle {ORACLE}: {cfg.num_layers} layers, d {cfg.d_model}, heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads}, hd {cfg.hd}, ff {cfg.d_ff}, {cfg.dtype}, "
        f"{n_params} params ({sum(t.numel() * t.element_size() for t in leaves) / 2**30:.2f}"
        f" GiB), drawn on the card in {time.perf_counter() - t0:.2f} s")

    forwards = counted_forwards(engine.runner)
    prompts = oracle_prompts(64, args.seed)
    cmp_prompts = [compare_prompt(None, "the claim with more evidence", prompts[2 * i][7:207],
                                  prompts[2 * i + 1][7:207]) for i in range(32)]
    choose_prompts = [p[:300] + "\nTopic:\n0. science\n1. sports\n2. politics\n3. art"
                      "\nAnswer:" for p in prompts[:32]]
    recs, _, _, _, emb = synth.make_filter_world(400, seed=args.seed)
    index = sem_index([r["claim"] for r in recs], emb, index="exact")
    query = recs[5]["claim"]
    engine.predicate(prompts[:2])                     # warm-up: cuBLAS, kernel load
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for _, mod in _KERNELS:
        mod.launches = 0
    forwards[0] = 0
    t0 = time.perf_counter()
    passes, scores = engine.predicate(prompts)
    wins = engine.compare(cmp_prompts)
    choice = engine.choose(choose_prompts, 4)
    hits, st = sem_search(index, query, emb, k=16, n_rerank=8,
                          rerank_model=EngineModel(engine), records=recs,
                          rerank_langex="{claim}")
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = {name: mod.launches for name, mod in _KERNELS}
    n_fwd = forwards[0]
    log(f"oracle path: {n_fwd} forward passes in {path_s:.2f} s, launches {launches}, "
        f"engine stats {engine.stats}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    assert n_fwd >= 5 and launches["flash_attention"] == cfg.num_layers * n_fwd, \
        (n_fwd, launches)
    assert passes.shape == (64,) and scores.dtype == np.float32
    assert np.isfinite(scores).all() and ((scores >= 0) & (scores <= 1)).all()
    assert wins.shape == (32,) and choice.shape == (32,)
    assert ((choice >= 0) & (choice < 4)).all()
    top16, _ = sem_search(index, query, emb, k=16)
    assert len(set(hits)) == 8 and set(hits) <= set(top16) and st["reranked"] == 8
    log(f"sem_search k=16 n_rerank=8: hits {hits} (embedding top-16 {top16}), "
        f"compare calls {st.get('compare_calls', 0)}, details "
        f"{ {k: v for k, v in st.items() if k != 'wall_s'} }")
    log(f"predicate: {int(passes.sum())}/64 pass, score range "
        f"[{scores.min():.4f}, {scores.max():.4f}]; compare: {int(wins.sum())}/32 prefer A; "
        f"choose: counts {np.bincount(choice, minlength=4).tolist()}")

    agreement(cfg, params, engine, prompts, cmp_prompts, args.seed)
    lk = engine._last_logits(prompts)
    assert np.array_equal(passes, lk[:, TOKENIZER.true_id] > lk[:, TOKENIZER.false_id])

    # timing: 32-prompt batches, and one forward pass under the profiler
    ntok = sum(min(len(TOKENIZER.encode(p)), 512) for p in prompts)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.predicate(prompts)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    log(f"predicate over 64 prompts ({ntok} prompt tokens, 2 batches): median wall "
        f"{wall * 1e3:.1f} ms of {[round(w * 1e3, 1) for w in walls]}, "
        f"{wall * 1e3 / 2:.1f} ms per 32-prompt batch, {ntok / wall:.0f} prompt tokens/s")
    seqs = [TOKENIZER.encode(p)[:512] for p in prompts[:32]]
    toks = TOKENIZER.pad_batch(seqs, max(16, max(len(q) for q in seqs)))
    fwd_ms, recs = profiled(lambda: engine.runner.logprobs(toks))
    dev = sorted(((e.self_device_time_total / 1e3, e.key) for e in recs), reverse=True)
    busy = sum(ms for ms, _ in dev)
    assert busy > 0, "the profiler recorded no device time for the forward"
    # the bf16 kernel by its symbol: a renamed kernel must not read 0 ms
    name = kfa.KERNEL_NAMES[torch.bfloat16]
    flash = sum(ms for ms, k in dev if name in k)
    assert flash > 0, f"the forward's profile names no {name}"
    log(f"forward: the profiler kept {sum(e.count for e in recs if name in e.key)} "
        f"{name} records of {cfg.num_layers} launches")
    # cuBLAS's GEMMs on Hopper are named nvjet_* (or *gemm*, *xmma*)
    gemm = sum(ms for ms, k in dev if any(w in k.lower() for w in
                                           ("nvjet", "gemm", "xmma", "cutlass")))
    log(f"forward [32, {toks.shape[1]}] under the profiler: wall {fwd_ms:.1f} ms, "
        f"device busy {busy:.2f} ms, idle share {1 - busy / fwd_ms:.4f}; "
        f"flash_attention {flash:.2f} ms (share of busy {flash / busy:.4f}), "
        f"GEMMs {gemm:.2f} ms ({gemm / busy:.4f}), rest {busy - flash - gemm:.2f} ms "
        f"({(busy - flash - gemm) / busy:.4f})")
    log("forward top kernels: " + "; ".join(f"{k[:60]} {ms:.2f} ms" for ms, k in dev[:12]))

    # the ops.rmsnorm entry at the oracle's activations, counted on its own
    dev = engine.runner.device
    x = [layers.embed(params["embed"], torch.from_numpy(TOKENIZER.pad_batch(
        [TOKENIZER.encode(p) for p in prompts[i:i + 32]])).to(dev)).to(cfg.activation_dtype)
        for i in (0, 32)]
    scale = params["final_norm"]["scale"]
    krn.launches = 0
    normed = [ops.rmsnorm(xb, scale, eps=cfg.norm_eps) for xb in x]
    torch.cuda.synchronize()
    rms_launches = krn.launches
    assert rms_launches == 2, rms_launches
    for xb, nb in zip(x, normed):
        assert bf16_ulps(nb, layers.rmsnorm({"scale": scale}, xb, cfg.norm_eps)) <= 1
    log(f"ops.rmsnorm entry at the oracle's activations {[list(t.shape) for t in x]} "
        f"bf16: {rms_launches} launches, within one ulp of the model's plain rmsnorm")
    launches["rmsnorm"] = rms_launches
    del engine, params, x, normed
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# the generate path: decode_attention, and prefill + decode at full width
# ---------------------------------------------------------------------------

GEN_SLOTS, GEN_MAX_SEQ, GEN_NEW = 32, 1024, 64
# Teacher-forced log-probs of the generate path, kernel path against the
# plain path (attn_impl="full") on the same weights, over 32 sequences x 64
# generated positions (prefill + 63 decode steps): in f32 through
# GEN_F32_LAYERS layers to 1e-4; in bf16 through 28 layers to
# GEN_BF16_LOGPROB_TOL, a limit set between the kernel path's reading and
# the readings of two gross faults of the plain path (PERF.md §6).
GEN_F32_LAYERS = 4
GEN_F32_LOGPROB_TOL = 1e-4
GEN_BF16_LOGPROB_TOL = 0.2
NEAR_TIE = 1e-4   # a top-1/top-2 log-prob margin under which greedy f32 paths may part


def decode_kernel_phase(args, bw, bf16) -> dict:
    """decode_attention against its plain version on the card, in f32 and
    bf16, at the generate path's shape and at ragged edges (window, many
    chunks a row, 1 to 16 q-heads a kv-head, small and odd head dims, S no
    multiple of a tile, misaligned k/v, lens 0, S - 1 and past S); two calls
    give identical bits and the merge's tickets end at 0; timed beside the
    bound and SDPA."""
    dev = torch.device("cuda")
    g = torch.Generator(device="cuda").manual_seed(args.seed + 5)
    cfg = get_config(ORACLE)
    B, S, H, HK, HD = GEN_SLOTS, GEN_MAX_SEQ, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    f32, b16 = torch.float32, torch.bfloat16

    def inputs(b, s, h, hk, hd, dt, window=0, edges=True, gen=g):
        q = torch.randn(b, 1, h, hd, device=dev, generator=gen).to(dt)
        k = torch.randn(b, s, hk, hd, device=dev, generator=gen).to(dt)
        v = torch.randn(b, s, hk, hd, device=dev, generator=gen).to(dt)
        lens = torch.randint(0, s, (b,), device=dev, generator=gen, dtype=torch.int32)
        if edges:   # 0, S - 1, past S and, with a window, a row that sees no key
            fixed = ([0, s - 1, s + 5] + ([s + window + 1] if window else []))[:b]
            lens[:len(fixed)] = torch.tensor(fixed, dtype=torch.int32, device=dev)
        return q, k, v, lens

    err = 0.0
    for shape, window in [((B, S, H, HK, HD), 0),       # the generate path's shape
                          ((8, S, H, HK, HD), 256),     # sliding window
                          ((2, 4096, 8, 2, HD), 0),     # many chunks a row
                          ((3, 700, 8, 1, HD), 0),      # 8 q-heads a kv-head
                          ((3, 700, 16, 1, HD), 0),     # 16: two blocks read it
                          ((3, 700, H, HK, 100), 0),    # hd 100: scalar loads
                          ((6, 300, 8, 8, 64), 0),      # Hk = H, hd 64
                          ((6, 77, 8, 2, 64), 0),
                          ((6, 129, 4, 2, 16), 0),      # hd 16
                          ((6, 300, 4, 1, 16), 40),
                          ((4, 500, 4, 2, 17), 7),      # hd 17
                          ("misaligned", 0)]:
        for dt in (f32, b16):
            if shape == "misaligned":   # k/v rows of 16-byte multiples, not aligned
                q, k, v, lens = inputs(4, 600, H, HK, HD, dt, window)
                k, v = (misaligned(k.shape, dt, g), misaligned(v.shape, dt, g))
            else:
                q, k, v, lens = inputs(*shape, dt, window)
            e = close_err(kda.decode_attention(q, k, v, lens, window=window),
                          ref.decode_attention_ref(q, k, v, lens, window=window),
                          ATTN_TOL[dt])
            bshkd = [k.shape[0], k.shape[1], q.shape[2], k.shape[2], k.shape[3]]
            log(f"decode_attention [b,s,h,hk,hd]={bshkd} {dt} window={window}"
                f"{' misaligned' if k.data_ptr() % 16 else ''}: "
                f"max abs err {e:.3g} (tol {ATTN_TOL[dt]} + rel)")
            err = max(err, e)
    # chunks merge in chunk order: two calls give identical bits; the last
    # block of a row resets its ticket, so a call after one with other lens
    # is right and the tickets end at 0
    q, k, v, lens = inputs(4, S, H, HK, HD, b16, edges=False)   # several chunks a row
    assert kda.chunk_for(4, HK, H, S, kda._sms(q.device)) < S
    first, again = (kda.decode_attention(q, k, v, lens) for _ in range(2))
    assert torch.equal(first.view(torch.int16), again.view(torch.int16)), "not deterministic"
    for ls in (torch.flip(lens, (0,)), lens):
        close_err(kda.decode_attention(q, k, v, ls), ref.decode_attention_ref(q, k, v, ls),
                  ATTN_TOL[b16])
    torch.cuda.synchronize()
    assert all(int(t.abs().sum()) == 0 for t in kda._TICKETS.values()), "a ticket was left set"
    log("decode_attention: two calls on the same inputs give identical bits; calls with "
        "other lens in between agree with the plain version; every ticket is back at 0")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    # the timed inputs from a generator of their own, drawn as
    # tools/kernel_ab.py draws them: both time the same lens
    gt = torch.Generator(device="cuda").manual_seed(args.seed)
    for dt in (b16, f32):
        q, k, v, lens = inputs(B, S, H, HK, HD, dt, edges=False, gen=gt)
        mask = (torch.arange(S, device=dev)[None, :] <= lens[:, None])[:, None, None, :]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ms, lib, ratios = interleaved_ms(
            lambda: kda.decode_attention(q, k, v, lens),
            lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True), 20)
        plain, pclock = plain_ms(lambda: ref.decode_attention_ref(q, k, v, lens), 5)
        lib_err = float((sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True).transpose(1, 2)
                         .float() - ref.decode_attention_ref(q, k, v, lens).float())
                        .abs().max())
        rows = int((lens.clamp(max=S - 1) + 1).sum())          # attended cache rows
        es = q.element_size()
        nbytes = rows * HK * HD * 2 * es + 2 * q.numel() * es + lens.numel() * 4
        flops = 4 * rows * H * HD
        bms, by = bound(nbytes, flops, bw, bf16)
        log(f"decode_attention q[{B},1,{H},{HD}] k/v[{B},{S},{HK},{HD}] {dt}, {rows} "
            f"attended rows, device time (profiler): kernel {ms:.4f} ms "
            f"({nbytes / ms / 1e6:.0f} GB/s, {bms / ms:.3f} of the {by} bound {bms:.4f} ms "
            f"at {bw / 1e9:.0f} GB/s), plain {plain:.4f} ms ({pclock}), SDPA (bool mask, GQA) "
            f"{lib:.4f} ms (its max abs err {lib_err:.3g}); median kernel / SDPA "
            f"{statistics.median(ratios):.3f} (each round: "
            + ", ".join(f"{r:.3f}" for r in ratios) + ")")
        if dt == b16:
            out["decode_attention"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms,
                bound_by=by, nbytes=nbytes, flops=flops, clock="profiler", plain_clock=pclock,
                shape=f"q[{B},1,{H},{HD}] k/v[{B},{S},{HK},{HD}] bf16, {rows} attended rows")
    r = out["decode_attention"]
    log(f"kernel decode_attention: {r['shape']} err={r['max_abs_err']:.3g} "
        f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
        f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) bytes={r['nbytes']} "
        f"flops={r['flops']}")
    torch.cuda.empty_cache()
    return out


class RecordedScheduler(ContinuousBatchScheduler):
    """The engine's scheduler, keeping each run and its finished requests so
    that a phase can check that none failed or was retried: the scheduler
    re-queues a request on RuntimeError and ends it as "" after
    max_retries, which a run would otherwise never show."""
    runs: list = []
    current = None

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        RecordedScheduler.current = self

    def run_to_completion(self, max_steps: int = 100_000):
        done = super().run_to_completion(max_steps)
        RecordedScheduler.runs.append((self, list(done)))
        return done


@contextlib.contextmanager
def recorded_runs():
    RecordedScheduler.runs = []
    saved = engine_mod.ContinuousBatchScheduler
    engine_mod.ContinuousBatchScheduler = RecordedScheduler
    try:
        yield RecordedScheduler.runs
    finally:
        engine_mod.ContinuousBatchScheduler = saved


def check_runs(runs, sizes=None) -> tuple[int, int, int]:
    """Every submitted request done (``sizes``: the requests of each run,
    where the caller knows them), none failed, none retried. -> (prefill
    steps, decode steps, generated tokens) over the runs."""
    if sizes is not None:
        assert [len(done) for _, done in runs] == list(sizes), \
            ([len(d) for _, d in runs], sizes)
    reqs = [r for _, done in runs for r in done]
    assert reqs and all(r.done and not r.failed for r in reqs), \
        [(r.rid, r.failed) for r in reqs]
    retries = sum(r.retries for r in reqs)
    assert retries == 0, f"{retries} retries: a RuntimeError was swallowed by the scheduler"
    return (sum(s.prefill_steps for s, _ in runs), sum(s.decode_steps for s, _ in runs),
            sum(len(r.out_tokens) for r in reqs))


def teacher_forced(runner, prompt: np.ndarray, out: list[int]) -> np.ndarray:
    """Log-probs [len(out), V] along ``out`` through slot 0 of ``runner``."""
    logits = [runner.prefill_into_slot(prompt, 0)]
    lens = np.zeros(runner.max_slots, np.int32)
    lens[0] = len(prompt)
    nxt = np.zeros(runner.max_slots, np.int32)
    for tok in out[:-1]:
        nxt[0] = tok
        logits.append(runner.decode(nxt, lens)[0])
        lens = lens + 1
    z = torch.from_numpy(np.stack(logits)).double()
    return torch.log_softmax(z, dim=-1).numpy()


def small_generate_cuda_vs_cpu(seed: int) -> None:
    """The smoke-size model (3 layers, d 64, f32) generating on the card
    against the same weights on the CPU, whose plain path the tests hold
    against JAX: the texts are identical (up to a near-tie the CPU's own
    log-probs show, should one part them), and the card's tokens
    teacher-forced through both give log-probs within 1e-5."""
    cfg = get_smoke(ORACLE).with_(vocab_size=TOKENIZER.vocab_size)
    prompts = oracle_prompts(6, seed + 12, 16, 200)
    gpu = InferenceEngine(cfg, seed=seed, max_slots=4, max_seq=256)
    with recorded_runs() as runs:
        n0 = kda.launches
        texts_gpu = gpu.generate(prompts, max_new_tokens=32)
        steps = check_runs(runs, [6])[1]
        assert kda.launches - n0 == cfg.num_layers * steps, (kda.launches - n0, steps)
        gpu_reqs = runs[0][1]
    repro_torch.set_device("cpu")
    try:
        cpu = InferenceEngine(cfg, gpu.runner.params, max_slots=4, max_seq=256)
        with recorded_runs() as runs:
            texts_cpu = cpu.generate(prompts, max_new_tokens=32)
            check_runs(runs, [6])
            cpu_reqs = {r.rid: r for r in runs[0][1]}
        err, parted = 0.0, []
        for r in gpu_reqs:
            lg = teacher_forced(gpu.runner, r.tokens, r.out_tokens)
            lc = teacher_forced(cpu.runner, r.tokens, r.out_tokens)
            err = max(err, float(np.abs(lg - lc).max()))
            c = cpu_reqs[r.rid].out_tokens
            if c != r.out_tokens:
                i = next(j for j, (a, b) in enumerate(zip(c, r.out_tokens)) if a != b)
                top2 = np.sort(lc[i])[-2:]
                assert c[:i] == r.out_tokens[:i] and top2[1] - top2[0] < NEAR_TIE, \
                    (r.rid, i, top2)
                parted.append((r.rid, i, float(top2[1] - top2[0])))
    finally:
        repro_torch.set_device(None)
    assert err <= 1e-5, err
    assert parted or texts_gpu == texts_cpu
    log(f"small generate ({cfg.num_layers} layers, d {cfg.d_model}, f32, 6 prompts x 32 "
        f"tokens): card texts == CPU texts: {texts_gpu == texts_cpu} (parted at near-ties: "
        f"{parted}); teacher-forced log-probs within {err:.3g}; {steps} decode steps")


def generate_phase(args) -> dict:
    """The generate path at full width, counted: sem_map over 64 records
    with 64 new tokens each, then sem_agg_hierarchical over the notes,
    through EngineModel -> InferenceEngine.generate -> the scheduler."""
    full = get_config(ORACLE)
    cfg = full.with_(vocab_size=TOKENIZER.vocab_size)
    assert cfg.attn_impl == "auto"   # the shipped default: the kernels on the card
    t0 = time.perf_counter()
    engine = InferenceEngine(cfg, seed=args.seed, max_slots=GEN_SLOTS, max_seq=GEN_MAX_SEQ)
    torch.cuda.synchronize()
    runner = engine.runner
    cache_b = sum(t.numel() * t.element_size() for t in flatten(runner.cache).values())
    log(f"generate engine {ORACLE} (vocab cut to {cfg.vocab_size}): {GEN_SLOTS} slots x "
        f"{GEN_MAX_SEQ} positions, KV cache {cache_b / 2**30:.2f} GiB, made in "
        f"{time.perf_counter() - t0:.2f} s; allocated on the card "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    records = [{"claim": p} for p in oracle_prompts(64, args.seed + 11)]
    model = EngineModel(engine, max_new_tokens=GEN_NEW)
    engine.generate(["warm-up: cuBLAS and the kernels load"], max_new_tokens=2)

    prefills, decodes = [], []
    prefill, decode = runner.prefill_into_slot, runner.decode

    def timed_prefill(tokens, slot):
        t = time.perf_counter()
        out = prefill(tokens, slot)          # returns numpy: the step has ended
        prefills.append((len(tokens), time.perf_counter() - t))
        assert np.isfinite(out).all()
        return out

    def timed_decode(tokens, lens):
        active = sum(r is not None for r in RecordedScheduler.current.slot_req)
        t = time.perf_counter()
        out = decode(tokens, lens)
        decodes.append((active, time.perf_counter() - t))
        assert np.isfinite(out).all()
        return out

    runner.prefill_into_slot, runner.decode = timed_prefill, timed_decode
    stats0 = dataclasses.replace(engine.stats)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with recorded_runs() as runs:
        for _, mod in _KERNELS:
            mod.launches = 0
        t0 = time.perf_counter()
        notes, st_map = sem_map(records, "a short note on {claim}", model)
        map_s = time.perf_counter() - t0
        map_tokens = engine.stats.generated_tokens - stats0.generated_tokens
        t0 = time.perf_counter()
        summary, st_agg = sem_agg_hierarchical(
            [{"note": n} for n in notes], "summarize {note}", model, fanout=8)
        agg_s = time.perf_counter() - t0
        launches = {name: mod.launches for name, mod in _KERNELS}
        n_prefill, n_decode, n_gen = check_runs(runs, [64, 8, 1])
    del runner.prefill_into_slot, runner.decode      # the class's methods again
    peak = torch.cuda.max_memory_allocated() / 2**30
    stats = {k: getattr(engine.stats, k) - getattr(stats0, k)
             for k in ("lm_calls", "generated_tokens", "prompt_tokens")}
    log(f"generate path: sem_map over 64 records {map_s:.2f} s ({map_tokens} tokens, "
        f"{map_tokens / map_s:.1f} generated tokens/s), sem_agg_hierarchical (fanout 8, "
        f"depth {st_agg['depth']}) {agg_s:.2f} s; {len(runs)} generate calls, {n_prefill} "
        f"prefills, {n_decode} decode steps ({[s.decode_steps for s, _ in runs]}), "
        f"launches {launches}, engine stats {stats}, peak memory {peak:.2f} GiB")
    assert launches["decode_attention"] == cfg.num_layers * n_decode, (launches, n_decode)
    assert launches["flash_attention"] == cfg.num_layers * n_prefill, (launches, n_prefill)
    assert stats == {"lm_calls": 73, "generated_tokens": n_gen,
                     "prompt_tokens": sum(len(r.tokens) for _, d in runs for r in d)}, stats
    assert len(notes) == 64 and all(isinstance(n, str) for n in notes)
    assert isinstance(summary, str) and st_agg["depth"] == 2
    lengths = [len(r.out_tokens) for r in runs[0][1]]
    log(f"sem_map generations: {map_tokens} tokens, per request min {min(lengths)} max "
        f"{max(lengths)}; the first two notes begin {[n[:24] for n in notes[:2]]}")

    sizes = [n for n, _ in prefills[:64]]
    near = [dt for n, dt in prefills[:64] if 448 <= n <= 512]
    ttft = statistics.median(near)
    step32 = [dt for a, dt in decodes if a == GEN_SLOTS]
    log(f"time to first token (prefill of 448..512 tokens, bucket 512; {len(near)} of the sem_map "
        f"prompts of {min(sizes)}..{max(sizes)} tokens): median {ttft * 1e3:.2f} ms of "
        f"[{min(near) * 1e3:.2f}, {max(near) * 1e3:.2f}]; decode step at {GEN_SLOTS} active "
        f"slots: median {statistics.median(step32) * 1e3:.2f} ms over {len(step32)} steps "
        f"({GEN_SLOTS / statistics.median(step32):.0f} tokens/s while all slots decode)")

    # one decode step at 32 active slots under the profiler
    toks = np.random.default_rng(args.seed).integers(0, 256, GEN_SLOTS).astype(np.int32)
    lens = np.full(GEN_SLOTS, 520, np.int32)
    decode(toks, lens)
    wall, recs = profiled(lambda: decode(toks, lens))
    dev = sorted(((e.self_device_time_total / 1e3, e.key, e.count) for e in recs),
                 reverse=True)
    busy = sum(ms for ms, _, _ in dev)
    assert busy > 0, "the profiler recorded no device time for the decode step"
    # every device function of the kernel, by its name's prefix: a renamed
    # kernel, or one that splits off a merge, must not read 0 ms
    attn = sum(ms for ms, k, _ in dev if kda.KERNEL_PREFIX in k)
    assert attn > 0, f"the decode step's profile names no {kda.KERNEL_PREFIX}*"
    gemm = sum(ms for ms, k, _ in dev if any(w in k.lower() for w in
                                              ("nvjet", "gemm", "xmma", "cutlass")))
    log(f"decode step [{GEN_SLOTS} slots, lens 520] under the profiler: wall {wall:.2f} ms,"
        f" device busy {busy:.3f} ms, idle share {1 - busy / wall:.4f}, "
        f"{sum(c for _, _, c in dev)} device ops; GEMMs {gemm:.3f} ms (share of busy "
        f"{gemm / busy:.4f}), decode_attention {attn:.3f} ms ({attn / busy:.4f}) in "
        f"{sum(c for _, k, c in dev if kda.KERNEL_PREFIX in k)} records of "
        f"{cfg.num_layers} launches, rest {busy - gemm - attn:.3f} ms "
        f"({(busy - gemm - attn) / busy:.4f})")
    log("decode step top kernels: " + "; ".join(
        f"{k[:60]} x{c} {ms:.3f} ms" for ms, k, c in dev[:8]))
    prompts = [r.tokens for r in sorted(runs[0][1], key=lambda r: r.rid)[:32]]
    return dict(engine=engine, prompts=prompts, launches=launches)


def _chunked_attend(q, k, v, mask, block: int = 128):
    """A second correct plain attention: the online softmax over 128-key
    blocks, p rounded to the V type per block (as the decode kernel does
    per 128-row tile)."""
    h = q.shape[2]
    k, v = attention._repeat_kv(k, h), attention._repeat_kv(v, h)
    b, sq, _, hd = q.shape
    mask = mask.expand(b, 1, sq, k.shape[1])
    m = torch.full((b, h, sq), ref.NEG_INF, device=q.device)
    l = torch.zeros((b, h, sq), device=q.device)
    o = torch.zeros((b, sq, h, hd), device=q.device)
    for s0 in range(0, k.shape[1], block):
        sc = torch.einsum("bqhd,bshd->bhqs", q.float(), k[:, s0:s0 + block].float()) \
            * ref.attn_scale(hd)
        sc = torch.where(mask[..., s0:s0 + block], sc, ref.NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha.transpose(1, 2)[..., None] + torch.einsum(
            "bhqs,bshd->bqhd", p.to(v.dtype).float(), v[:, s0:s0 + block].float())
        m = m_new
    return (o / l.clamp(min=1e-30).transpose(1, 2)[..., None]).to(v.dtype)


@torch.inference_mode()
def forced_decode(cfg, params, prompt: torch.Tensor, forced=None):
    """Prefill ``prompt`` [B, T0] into a fresh cache, then 63 decode steps:
    greedy when ``forced`` is None, else fed ``forced`` [B, 64].  ->
    (log-probs [B, 64, V] f32, the tokens fed [B, 64])."""
    b, t0 = prompt.shape
    cache = registry.init_cache(cfg, b, t0 + GEN_NEW, device=prompt.device)
    logits, _ = registry.prefill(cfg, params, prompt, cache, last_only=True)
    lps = [torch.log_softmax(logits[:, -1].float(), dim=-1)]
    toks = [lps[-1].argmax(-1) if forced is None else forced[:, 0]]
    for i in range(GEN_NEW - 1):
        logits, _ = registry.decode_step(cfg, params, toks[-1][:, None], cache, t0 + i)
        lps.append(torch.log_softmax(logits[:, 0].float(), dim=-1))
        toks.append(lps[-1].argmax(-1) if forced is None else forced[:, i + 1])
    return torch.stack(lps, 1), torch.stack(toks, 1)


def generate_agreement(gen: dict) -> None:
    """The kernel path of the generate path against the plain path
    (attn_impl="full") on the same weights, teacher-forced along the kernel
    path's own greedy tokens: 32 sem_map prompts cut to one length, 64
    generated positions each.  bf16 through 28 layers, f32 through
    GEN_F32_LAYERS; beside them a second correct plain path (the chunked
    online softmax) and two gross faults of the plain path."""
    engine = gen["engine"]
    cfg, params = engine.cfg, engine.runner.params
    t0 = min(len(p) for p in gen["prompts"])
    prompt = torch.from_numpy(np.stack([p[:t0] for p in gen["prompts"]]).astype(np.int64)).cuda()
    kn0 = (kda.launches, kfa.launches)
    lp = {}
    lp["kernel"], toks = forced_decode(cfg, params, prompt)
    assert (kda.launches - kn0[0], kfa.launches - kn0[1]) == \
        (cfg.num_layers * (GEN_NEW - 1), cfg.num_layers)
    plain_cfg = cfg.with_(attn_impl="full")
    lp["plain"], _ = forced_decode(plain_cfg, params, prompt, toks)
    controls = [("chunked plain", _chunked_attend, False),
                ("p in fp8", functools.partial(_faulty_attend, p_dtype=torch.float8_e4m3fn),
                 True),
                ("kv-head h % Hk", functools.partial(_faulty_attend, kv_head_mod=True), True)]
    for name, attend, _ in controls:
        with plain_attention(attend):
            lp[name], _ = forced_decode(plain_cfg, params, prompt, toks)
    assert all(bool(torch.isfinite(v).all()) for v in lp.values())
    dist = {k: float((v - lp["plain"]).abs().max()) for k, v in lp.items() if k != "plain"}
    # f32, a few layers, 8 sequences
    n = min(GEN_F32_LAYERS, cfg.num_layers)
    cfg32 = cfg.with_(num_layers=n, dtype="float32")
    p32 = {**params, "layers": {k: ({kk: vv[:n] for kk, vv in v.items()}
                                    if isinstance(v, dict) else v[:n])
                                for k, v in params["layers"].items()}}
    k32, toks32 = forced_decode(cfg32, p32, prompt[:8])
    f32_plain, _ = forced_decode(cfg32.with_(attn_impl="full"), p32, prompt[:8], toks32)
    d32 = float((k32 - f32_plain).abs().max())
    top2 = f32_plain.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 1e-3
    same = (k32.argmax(-1) == f32_plain.argmax(-1))[clear]
    log(f"generate agreement, teacher-forced over {prompt.shape[0]} sequences of {t0} prompt "
        f"tokens ({GEN_NEW} positions x {cfg.vocab_size} log-probs), max abs distance from "
        f"the plain path: bf16 {cfg.num_layers} layers (tol {GEN_BF16_LOGPROB_TOL}): "
        + ", ".join(f"{k} {d:.4g}" for k, d in dist.items())
        + f"; f32 {n} layers over 8 sequences (tol {GEN_F32_LOGPROB_TOL}): kernel {d32:.3g}, "
        f"argmax identical at {int(same.sum())}/{int(clear.sum())} positions whose plain "
        f"margin > 0.001")
    assert dist["kernel"] <= GEN_BF16_LOGPROB_TOL and dist["chunked plain"] <= \
        GEN_BF16_LOGPROB_TOL, dist
    assert all(dist[name] > GEN_BF16_LOGPROB_TOL for name, _, caught in controls if caught), \
        dist
    assert d32 <= GEN_F32_LOGPROB_TOL and bool(same.all()) and int(clear.sum()) > 0, d32
    del lp, k32, f32_plain
    torch.cuda.empty_cache()


def paged_phase(gen: dict, seed: int) -> int:
    """Paged decode against contiguous decode at full width: 8 rows, pages
    of 16 positions, 48 steps (3 pages a row) from an empty cache on the
    same random tokens; the paged steps' decode_attention launches are
    counted."""
    engine = gen["engine"]
    cfg, params = engine.cfg, engine.runner.params
    b, ps, steps, maxp = 8, 16, 48, 8
    toks = torch.from_numpy(np.random.default_rng(seed + 13).integers(
        0, 256, (b, steps)).astype(np.int64)).cuda()
    with torch.inference_mode():
        cache = registry.init_cache(cfg, b, maxp * ps)
        lp_c = [torch.log_softmax(registry.decode_step(cfg, params, toks[:, t:t + 1], cache,
                                                       t)[0][:, 0], dim=-1)
                for t in range(steps)]
    alloc = paged.PageAllocator(num_pages=b * maxp, page_size=ps, max_slots=b,
                                max_pages_per_slot=maxp)
    pages = paged.init_pages(cfg, b * maxp, ps)
    lens = np.zeros(b, np.int32)
    n0 = kda.launches
    lp_p = []
    for t in range(steps):
        for s in range(b):
            alloc.ensure(s, t + 1)
        logits, pages = paged.paged_decode_step(cfg, params, toks[:, t:t + 1], pages,
                                                alloc.table, lens)
        lp_p.append(torch.log_softmax(logits[:, 0], dim=-1))
        lens = lens + 1
    torch.cuda.synchronize()
    launches = kda.launches - n0
    d = float((torch.stack(lp_p) - torch.stack(lp_c)).abs().max())
    log(f"paged decode ({b} rows, {steps} steps, pages of {ps}): max abs log-prob distance "
        f"from contiguous decode {d:.3g} (tol 1e-6); decode_attention launches of the "
        f"paged steps {launches}")
    assert launches == cfg.num_layers * steps and d <= 1e-6, (launches, d)
    return launches


# The SemFrame main path (phase 14): benchmarks/pipeline_bench.py:16-30's
# pipeline and predicates over the paper's BioDEX size, 250 articles x 24,000
# reaction labels (the 1,000x of benchmarks/table3_biodex.py:54-56), at the
# E5-small width.
SF_LEFT, SF_LABELS = 250, 24_000
# The eager == lazy check (rule 4 off) runs the gold join twice on the host,
# ~38 x labels prompts to the simulated oracle each and no kernel: it joins
# the first SF_EQUALITY_LABELS labels, so that the phase stays well inside
# its time.
SF_EQUALITY_LABELS = 4_000
SF_SELECTIVE = "the {abstract} names a checkable claim"
SF_BROAD = "the {abstract} is written in English"
SF_JOIN = "the {abstract} reports the {reaction:right}"
SF_RANK = "the {abstract} reports the highest accuracy"
SF_TOPICS = (10_000, 8)   # records, groups; benchmarks/fig8_groupby.py:9 has 400, 5
# The cascades' targets.  At the BioDEX skew (2 true labels of 24,000 an
# article) the stats' finite-sample guard certifies no threshold at recall
# 0.9 from any sample the phase can afford, and the cascade then judges every
# pair; at 0.5 over a 20,000-pair sample both plans learn a finite tau_minus
# (and keep it under a 2e-7 perturbation of the planes), so the thresholds
# read from the card's planes decide what the oracle sees.  The group-by's
# accuracy target 0.8 sets its tau among the centre scores that tie at 1.0
# (at 0.9 it is inf).
SF_CASCADE = dict(recall_target=0.5, precision_target=0.5)
SF_CASCADE_SAMPLE = 20_000
SF_GROUP_ACCURACY = 0.8
# Rule 4 (inject_sim_prefilter) narrows a gold join to each left row's most
# similar quarter of the right rows, so by design it may drop true pairs
# (tests/test_plan.py holds it to a subset of the gold join): the lazy run
# that must equal the eager one switches it off.
AS_WRITTEN = {"prefilter_threshold": math.inf}
# The serving layer's setting: the retrieval cost model spreads an IVF build
# over the index registry's sessions, so a plan picks IVF (int8 from 8192
# rows) where one batch alone would not pay for the build.
SHARED = {"index_shared": True}


def biodex_world(n_labels: int, seed: int):
    """pipeline_bench's world: two true labels an article, a broad (0.85) and
    a selective (0.15) predicate, a rank value an article."""
    left, right, world, *_ = synth.make_join_world(
        SF_LEFT, n_labels, labels_per_left=2, seed=seed, cfg=SimConfig(dim=DIM))
    synth.add_phrase_predicate(world, left, "names a checkable claim", 0.15, seed=seed)
    synth.add_phrase_predicate(world, left, "is written in English", 0.85, seed=seed)
    for i, t in enumerate(left):
        world.rank_value[t["id"]] = float(i % 17) / 17.0
    return left, right, world


def sf_frame(records, world, stats_log: list, sample_size: int = 60) -> SemFrame:
    return SemFrame(records, Session(oracle=SimulatedModel(world, "oracle"),
                                     embedder=SimulatedEmbedder(world),
                                     sample_size=sample_size), stats_log)


def sf_pipeline(frame, labels):
    """filter(broad) -> filter(selective) -> join -> topk, eager or lazy."""
    return (frame.sem_filter(SF_BROAD).sem_filter(SF_SELECTIVE)
            .sem_join(labels, SF_JOIN).sem_topk(SF_RANK, 10))


def bill(stats_log: list) -> dict:
    return {k: sum(st.get(k, 0) for st in stats_log)
            for k in ("oracle_calls", "lm_calls", "cache_hits")}


def no_wall(stats_log: list) -> list[dict]:
    return [{k: v for k, v in st.items() if k != "wall_s"} for st in stats_log]


def retrieval_counts() -> dict:
    return {name: mod.launches for name, mod in _RETRIEVAL}


def counted(fn):
    """-> (fn(), wall s, retrieval kernel launches during the call)."""
    c0 = retrieval_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, {n: c - c0[n] for n, c in retrieval_counts().items()}


class Planes:
    """Stands in for the cascade operators' ``VectorIndex``: records each
    ``pairwise`` call's index rows, queries and score plane, or returns the
    given planes, in order, in the plane's place."""

    def __init__(self, replay=None):
        self.calls: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        calls, replay = self.calls, None if replay is None else list(replay)

        class Index(VectorIndex):
            def pairwise(self, queries):
                if replay is None:
                    out = super().pairwise(queries)
                else:
                    out = replay.pop(0)
                    assert out.shape == (len(queries), len(self.vectors)), out.shape
                calls.append((self.vectors, np.asarray(queries, np.float32), out))
                return out
        self.cls = Index

    @contextlib.contextmanager
    def installed(self):
        saved = sf_join.VectorIndex, sf_groupby.VectorIndex
        sf_join.VectorIndex = sf_groupby.VectorIndex = self.cls
        try:
            yield self
        finally:
            sf_join.VectorIndex, sf_groupby.VectorIndex = saved


def record(out: dict, name: str, fn, text: str = "", planes: Planes | None = None) -> None:
    """Run ``fn(stats_log)`` counted (under ``planes`` where given) into
    ``out[name]``: records, stats log without wall times, plan text, wall s,
    launches and the planes' calls."""
    slog: list = []
    with planes.installed() if planes else contextlib.nullcontext():
        frame, wall, n = counted(lambda: fn(slog))
    out[name] = dict(records=frame.records, log=no_wall(slog), text=text, wall=wall,
                     launches=n, busy_ms=None, planes=planes.calls if planes else None)


def cascade_runs(left, right, world, topics, replay: dict | None = None) -> dict:
    """The pipeline with a cascade join under each ``force_plan`` (each
    scores the left x right plane and the projected plane) and a cascade
    ``sem_group_by`` (its centre plane), their planes recorded, or replaced
    by ``replay[name]``'s."""
    out: dict = {}
    for plan in ("sim-filter", "project-sim-filter"):
        name = f"cascade {plan}"
        record(out, name, lambda slog: (
            sf_frame(left, world, slog, SF_CASCADE_SAMPLE).sem_filter(SF_BROAD)
            .sem_filter(SF_SELECTIVE).sem_join(right, SF_JOIN, force_plan=plan, **SF_CASCADE)),
            planes=Planes(replay and [c[2] for c in replay[name]]))
    recs, model, emb = topics
    name = "cascade group_by"
    record(out, name, lambda slog: SemFrame(recs, Session(oracle=model, embedder=emb), slog)
           .sem_group_by("topic of {paper}", SF_TOPICS[1], accuracy_target=SF_GROUP_ACCURACY),
           planes=Planes(replay and [c[2] for c in replay[name]]))
    return out


def semframe_device_runs(left, right, world, topics, profile: bool) -> dict:
    """The phase's gold calls that reach the card: the optimizer's default
    plan of the pipeline (rule 4's prefilter ranks each article's labels
    through an exact index), a lazy ``sem_sim_join`` whose index the plan
    picks, and gold ``sem_group_by`` (its centres scored through an exact
    index).  With ``profile`` the default plan runs under the profiler.
    -> per call: records, stats log without wall times, plan text, wall s,
    launches."""
    out: dict = {}
    plog: list = []
    lz = sf_pipeline(sf_frame(left, world, plog).lazy(), right)
    text = lz.explain()
    busy = None
    if profile:
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            frame, wall, n = counted(lz.collect)
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    else:
        frame, wall, n = counted(lz.collect)
    out["pipeline"] = dict(records=frame.records, log=no_wall(plog), text=text, wall=wall,
                           launches=n, busy_ms=busy, planes=None)

    def sim_join(slog):
        return sf_frame(left, world, slog).lazy().sem_sim_join(right, "abstract", "reaction", k=K)
    record(out, "sim_join", lambda slog: sim_join(slog).collect(**SHARED),
           sim_join([]).explain(**SHARED))
    recs, model, emb = topics
    record(out, "group_by", lambda slog: SemFrame(recs, Session(oracle=model, embedder=emb),
                                                  slog).sem_group_by("topic of {paper}",
                                                                     SF_TOPICS[1]))
    return out


def plane_changes(calls) -> str:
    """Each recorded plane against the plain version's on the same index rows
    and queries (within TOL); -> how many scores' quantile ranks differ, and
    some of those scores (kernel, plain)."""
    saved = ops.DEFAULT_IMPL
    ops.DEFAULT_IMPL = "ref"
    try:
        said = []
        for vectors, queries, got in calls:
            want = VectorIndex(vectors).pairwise(queries)
            err = float(np.abs(got - want).max())
            assert got.shape == want.shape and err <= TOL, (got.shape, want.shape, err)
            at = np.flatnonzero(quantile_calibrate(got).ravel()
                                != quantile_calibrate(want).ravel())
            said.append(f"plane {list(got.shape)}: max abs diff {err:.3g}, {len(at)} "
                        f"scores ranked otherwise, e.g. "
                        f"{[(float(got.flat[i]), float(want.flat[i])) for i in at[:3]]}")
        return "; ".join(said)
    finally:
        ops.DEFAULT_IMPL = saved


def same_records(got: list[dict], want: list[dict], what: str) -> None:
    """Identical records, but ``sim_score`` within TOL."""
    assert len(got) == len(want), f"{what}: {len(got)} records, plain path {len(want)}"
    for g, w in zip(got, want):
        assert g.keys() == w.keys(), (what, g, w)
        for key, v in g.items():
            ok = abs(v - w[key]) <= TOL if key == "sim_score" else v == w[key]
            assert ok, (what, key, g, w)


def semframe_phase(args, smi: str) -> None:
    """Phase 14, the SemFrame main path on the card: the pipeline eagerly and
    lazily, then the calls that reach the card (the lazy default plan, the
    cascade joins, a lazy ``sem_sim_join``, gold and cascade
    ``sem_group_by``), counted; the gold calls again through the plain
    versions, and the cascades through the plain versions on the kernels'
    planes."""
    t0 = time.perf_counter()
    left, right, world = biodex_world(SF_LABELS, args.seed)
    trecs, _, tmodel, temb = synth.make_topic_world(*SF_TOPICS, seed=args.seed)
    log(f"semframe ({smi}): {SF_LEFT} articles x {SF_LABELS} labels at width {DIM}, and "
        f"sem_group_by over make_topic_world({SF_TOPICS[0]}, {SF_TOPICS[1]}) (scaled up from "
        f"fig8_groupby's 400 records, 5 groups; its width stays make_topic_world's "
        f"{temb.dim}); worlds made in {time.perf_counter() - t0:.2f} s")
    log(f"cut: the eager == lazy check joins the first {SF_EQUALITY_LABELS} of the "
        f"{SF_LABELS} labels (two gold joins on the host, no kernel)")
    for _, mod in _KERNELS:
        mod.launches = 0

    labels = right[:SF_EQUALITY_LABELS]
    elog: list = []
    def eager_run():
        joined = (sf_frame(left, world, elog).sem_filter(SF_BROAD).sem_filter(SF_SELECTIVE)
                  .sem_join(labels, SF_JOIN))
        return joined, joined.sem_topk(SF_RANK, 10)
    (joined, eager), e_wall, e_n = counted(eager_run)
    alog: list = []
    lz = sf_pipeline(sf_frame(left, world, alog).lazy(), labels)
    a_text = lz.explain(**AS_WRITTEN)
    lazy, a_wall, a_n = counted(lambda: lz.collect(**AS_WRITTEN))
    log(f"semframe pipeline, lazy plan with rule 4 off:\n{a_text}")
    log(f"semframe pipeline eager ({SF_EQUALITY_LABELS} labels): {e_wall:.2f} s, "
        f"{len(joined)} joined pairs, {len(eager)} records, {bill(elog)}, launches {e_n}")
    log(f"semframe pipeline lazy (rule 4 off, {SF_EQUALITY_LABELS} labels): {a_wall:.2f} s, "
        f"{len(lazy)} records, {bill(alog)}, launches {a_n}")
    assert lazy.records == eager.records, "lazy records differ from eager"
    assert len(eager) == 10, len(eager)

    topics = (trecs, tmodel, temb)
    kern = semframe_device_runs(left, right, world, topics, profile=True)
    kern.update(cascade_runs(left, right, world, topics))
    launches = retrieval_counts()
    pipe = kern["pipeline"]
    log(f"semframe pipeline, lazy default plan:\n{pipe['text']}")
    assert all(world.join_truth.get((t["id"], t["right_id"])) for t in pipe["records"]), \
        "the default plan joined a pair that is not a true pair"
    join_st = next(st for st in pipe["log"] if st["operator"] == "sem_join_prefiltered")
    wall_ms = pipe["wall"] * 1e3
    idle = (f"device busy {pipe['busy_ms']:.2f} ms, idle share "
            f"{1 - pipe['busy_ms'] / wall_ms:.4f}") if pipe["busy_ms"] else \
        "the profiler recorded no device time (idle share not measured)"
    log(f"semframe pipeline lazy default plan (profiled): {pipe['wall']:.2f} s, "
        f"{len(pipe['records'])} records, {bill(pipe['log'])}, prefilter index "
        f"{join_st['index']}, k {join_st['prefilter_k']}, candidate pairs "
        f"{join_st['candidate_pairs']}, launches {pipe['launches']}; {idle}")
    for plan in ("sim-filter", "project-sim-filter"):
        c = kern[f"cascade {plan}"]
        st = c["log"][-1]
        assert st["operator"] == "sem_join" and st["plan"] == plan, st
        if st["tau_plus"] == math.inf:   # every kept pair was judged by the oracle
            assert all(world.join_truth.get((t["id"], t["right_id"])) for t in c["records"]), \
                f"cascade {plan} kept a pair that is not true"
        log(f"semframe cascade join {plan} ({SF_CASCADE}, sample {SF_CASCADE_SAMPLE}): "
            f"{c['wall']:.2f} s, {len(c['records'])} records, {bill(c['log'])}, tau_plus "
            f"{st['tau_plus']}, tau_minus {st['tau_minus']}, oracle region "
            f"{st['oracle_region']}, plan costs {st['plan_costs']}, launches {c['launches']}")
    sj = kern["sim_join"]
    sj_st = next(st for st in sj["log"] if st["operator"] == "sem_sim_join")
    log(f"semframe sem_sim_join lazy:\n{sj['text']}")
    log(f"semframe sem_sim_join: {sj['wall']:.2f} s, {len(sj['records'])} records, index "
        f"{sj_st['index']} quantize {sj_st.get('quantize')}, scored_vectors "
        f"{sj_st['scored_vectors']}, probed {sj_st['probed_clusters']}, scanned_bytes "
        f"{sj_st.get('scanned_bytes')}, launches {sj['launches']}")
    for name, op in (("group_by", "sem_group_by_gold"), ("cascade group_by", "sem_group_by")):
        gb = kern[name]
        st = gb["log"][-1]
        assert len(gb["records"]) == SF_TOPICS[0] and st["operator"] == op, st
        log(f"semframe {op}: {gb['wall']:.2f} s, {len(gb['records'])} records, "
            f"{len({t['group_label'] for t in gb['records']})} groups, {bill(gb['log'])}, "
            f"tau {st.get('tau')}, launches {gb['launches']}")
    log(f"semframe launches over the phase's kernel path: {launches}")
    chosen = {"exact": "similarity", "ivf": "cluster_scan"}[sj_st["index"]]
    if sj_st.get("quantize") == "int8":
        chosen = "cluster_scan_q"
    for name, k in kern.items():
        want = chosen if name == "sim_join" else "similarity"
        assert k["launches"][want] > 0, (name, want, k["launches"])

    # The gold calls through the plain versions must give the same records;
    # the cascades read thresholds from quantile ranks of their planes, and
    # two fp32 planes that agree to TOL rank near-equal scores otherwise, so
    # they run through the plain versions on the kernels' planes, which are
    # held to the plain versions' planes.
    saved = ops.DEFAULT_IMPL
    ops.DEFAULT_IMPL = "ref"
    try:
        before = retrieval_counts()
        plain = semframe_device_runs(left, right, world, topics, profile=False)
        plain.update(cascade_runs(left, right, world, topics,
                                  replay={n: k["planes"] for n, k in kern.items()
                                          if n.startswith("cascade")}))
        assert retrieval_counts() == before, "a kernel launched on the plain path"
    finally:
        ops.DEFAULT_IMPL = saved
    for name, k in kern.items():
        p = plain[name]
        same_records(k["records"], p["records"], name)
        assert k["log"] == p["log"], f"{name}: stats differ from the plain path's"
        assert k["text"] == p["text"], f"{name}: plan text differs from the plain path's"
        how = "on the kernels' planes; " + plane_changes(k["planes"]) if k["planes"] else ""
        log(f"semframe {name}: kernel path == plain path on the card (records, "
            f"{len(k['log'])} stats entries incl. bills and thresholds, plan text{how and '; '}"
            f"{how}), plain wall {p['wall']:.2f} s")


# The serving phases (15, 16): launch/serve.py's Gateway at full width over
# the oracle and the E5 embedder, then a continuous query over a growing
# table and the serving CLI as a user runs it.
SERVE_SESSIONS = 8          # over two tenants, through Gateway(max_inflight=4)
SERVE_RECORDS = 64          # records of 300-480 bytes a map -> filter pipeline
SERVE_DOCS = 20_000         # passages of 100-300 bytes the search sessions share
SERVE_MAP = "one-line gist of {doc}"           # launch/serve.py's engine pipeline
SERVE_FILTER = "the {doc} mentions a component"
# E5-small's pooled unit vectors, kernel path against the plain path
# (attn_impl="full") on the same weights: f32 sums in another order through
# 12 layers (7.45e-08 apart on the H100 at seed 0)
EMB_TOL = 1e-5
STREAM_ROWS = 200_000       # the table before the commits
STREAM_COMMITS, STREAM_DELTA = 4, 5_000   # 20,000 rows: a spill of 0.10, no retrain
STREAM_RECALL = 0.90
SERVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "serve_smoke")


def passages(n: int, seed: int, lo: int = 100, hi: int = 300) -> list[str]:
    """``n`` passages of ``lo``..``hi`` bytes of words, made from ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    for m in rng.integers(lo, hi + 1, n):
        body = " ".join(_WORDS[i] for i in rng.integers(0, len(_WORDS), int(m) // 3))
        out.append(body[:m].ljust(int(m), "."))
    return out


class TextCounter:
    """An embedder that keeps every text it is asked to embed, in order, and
    the size of each call."""

    def __init__(self, embedder):
        self.embedder = embedder
        self.texts: list[str] = []
        self.calls: list[int] = []

    @property
    def dim(self) -> int:
        return self.embedder.dim

    def embed(self, texts):
        self.texts.extend(texts)
        self.calls.append(len(texts))
        return self.embedder.embed(texts)


@contextlib.contextmanager
def attention_kinds():
    """Count ``flash_attention`` calls by (dtype, causal) while the block
    runs; the launch counter stays the kernel wrapper's own."""
    kinds: dict = {}
    real = kfa.flash_attention

    def spy(q, k, v, *, causal=True, window=0):
        key = f"{str(q.dtype).removeprefix('torch.')} {'causal' if causal else 'non-causal'}"
        kinds[key] = kinds.get(key, 0) + 1
        return real(q, k, v, causal=causal, window=window)
    kfa.flash_attention = spy
    try:
        yield kinds
    finally:
        kfa.flash_attention = real


def device_busy(fn) -> tuple[float, float | None, int]:
    """(wall s, device busy ms or None, device records) of one call of ``fn``
    under the profiler's CUDA activity (kernels, copies and memsets of every
    thread).  Busy is the union of the records' intervals, read from the raw
    records: building the profiler's event tree for the million launches of
    a served run takes minutes.  The call is not repeated: with no device
    record the busy time is None (not measured)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t1 = time.perf_counter()
    t2 = time.perf_counter()
    cuda = torch.autograd.DeviceType.CUDA
    spans = np.array([(e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                      if e.device_type() == cuda], np.int64).reshape(-1, 2)
    busy = union_ns(spans)
    log(f"profiler: stopped in {t2 - t1:.2f} s, {len(spans)} device records read in "
        f"{time.perf_counter() - t2:.2f} s")
    return wall, busy / 1e6 if len(spans) else None, len(spans)


def union_ns(spans: np.ndarray) -> int:
    """Length of the union of the [start, end) intervals in ``spans`` [n, 2]:
    each interval, in order of start, adds what reaches past every earlier end."""
    if not len(spans):
        return 0
    spans = spans[np.argsort(spans[:, 0], kind="stable")]
    start, end = spans[:, 0], spans[:, 1]
    reach = np.concatenate([[start[0]], np.maximum.accumulate(end)[:-1]])
    return int(np.maximum(end - np.maximum(start, reach), 0).sum())


def serving_phase(args, smi: str) -> dict:
    """Phase 15: launch/serve.py's Gateway at full width.  8 sessions over 2
    tenants: 4 run the engine pipeline (sem_map -> sem_filter) over 64
    records, two pairs sharing theirs; 4 run a lazy sem_search (k 10) over
    20,000 passages that E5-small embeds once through the IndexRegistry."""
    full = get_config(ORACLE)
    oracle_cfg = full.with_(vocab_size=TOKENIZER.vocab_size)
    proxy_cfg = oracle_cfg.with_(num_layers=4)
    assert oracle_cfg.attn_impl == E5_SMALL.attn_impl == "auto"
    log(f"cut: {ORACLE} vocab_size {full.vocab_size} -> {oracle_cfg.vocab_size} (oracle "
        f"and proxy); the proxy's num_layers {full.num_layers} -> 4")
    t0 = time.perf_counter()
    made = make_session(oracle_cfg, proxy_cfg, max_seq=512, seed=args.seed)
    # make_session's embedder is the reference's smoke default (E5_SMALL cut to
    # 2 layers, d 64); the phase serves E5_SMALL at its published widths
    embedder = Embedder(E5_SMALL, seed=args.seed + 2)
    oracle = CountingBackend(made.oracle._m)
    proxy = CountingBackend(made.proxy._m)
    texts = TextCounter(embedder)
    sess = Session(oracle=oracle, proxy=proxy, embedder=texts)
    torch.cuda.synchronize()
    e5 = E5_SMALL
    log(f"session: oracle {ORACLE} ({oracle_cfg.num_layers} layers, d {oracle_cfg.d_model}, "
        f"{oracle_cfg.dtype}), proxy ({proxy_cfg.num_layers} layers), embedder {e5.name} "
        f"({e5.num_layers} layers, d {e5.d_model}, {e5.num_heads} heads, ff {e5.d_ff}, "
        f"{e5.dtype}; it replaces make_session's 2-layer default) made in "
        f"{time.perf_counter() - t0:.2f} s; allocated on the card "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    recsets = [[{"id": f"r{s}-{i}", "doc": d}
                for i, d in enumerate(oracle_prompts(SERVE_RECORDS, args.seed + 15 + s))]
               for s in range(2)]
    docs = [{"id": i, "text": t} for i, t in enumerate(passages(SERVE_DOCS, args.seed + 17))]
    queries = [docs[997 * j]["text"][:80] for j in range(4)]
    oracle._m.engine.generate(["warm-up: cuBLAS and the kernels load"], max_new_tokens=2)
    embedder.embed(["warm-up"])
    forwards = counted_forwards(oracle._m.engine.runner)
    gw = Gateway(sess, max_inflight=4)
    try:
        def pipeline(i: int):
            if i % 2 == 0:       # the engine pipeline; sessions 0, 2 and 4, 6 share records
                return (SemFrame(recsets[i // 4], gw.session).lazy()
                        .sem_map(SERVE_MAP, out_column="gist").sem_filter(SERVE_FILTER))
            return (SemFrame(docs, gw.session).lazy()
                    .sem_search("text", queries[i // 2], k=K, index_kind="exact"))

        handles, rows = [], []

        def serve():
            handles.extend(gw.submit(pipeline(i), tenant=f"tenant{(i // 2) % 2}")
                           for i in range(SERVE_SESSIONS))
            rows.extend(h.result(timeout=900) for h in handles)

        for _, mod in _KERNELS:
            mod.launches = 0
        forwards[0] = 0
        torch.cuda.reset_peak_memory_stats()
        with recorded_runs() as runs, attention_kinds() as kinds:
            wall, busy, n_recs = device_busy(serve)
        launches = {name: mod.launches for name, mod in _KERNELS}
        snap = gw.snapshot()
        peak = torch.cuda.max_memory_allocated() / 2**30
        statuses = [h.status for h in handles]
        assert statuses == ["done"] * SERVE_SESSIONS, statuses
        assert snap["failed"] == 0 and snap["completed"] == SERVE_SESSIONS, snap
        n_prefill, n_decode, _ = check_runs(runs)
        for h in handles:
            log("serve session", json.dumps(h.summary()))
        idle = "not measured (the profiler kept no device record)" if busy is None else \
            f"{1 - busy / (wall * 1e3):.4f} (device busy {busy:.2f} ms of {wall * 1e3:.1f} ms, " \
            f"{n_recs} device records)"
        d = snap["dispatch"]
        log(f"served: {SERVE_SESSIONS}/{SERVE_SESSIONS} sessions in {wall:.2f} s under the "
            f"profiler ({SERVE_SESSIONS / wall:.4f} sessions/s, p50 {snap['p50_latency_s']} s, "
            f"p95 {snap['p95_latency_s']} s); device idle share {idle}; dispatcher fused "
            f"{d['fused_calls']} calls into {d['fused_batches']} batches ({d['backend_prompts']} "
            f"backend prompts for {d['requested_prompts']} requested, cross-session shared "
            f"{d['cross_shared']} + {d['cross_shared_embed']} embeds); cache {snap['cache']}; "
            f"registry builds {snap['index_builds']} hits {snap['index_hits']}; peak memory "
            f"{peak:.2f} GiB; {smi}")

        # the registry built the corpus index once; every text reached the
        # embedder and every prompt a model exactly once
        assert snap["index_builds"] == 1 and snap["index_hits"] >= 3, snap
        sent = [p for b in oracle.batches for p in b]
        assert len(sent) == len(set(sent)) == 4 * SERVE_RECORDS, (len(sent), len(set(sent)))
        assert not proxy.batches, "the gold pipeline reached the proxy"
        assert len(texts.texts) == len(set(texts.texts)) == SERVE_DOCS + len(queries)
        assert d["backend_prompts"] == len(sent) + len(texts.texts), d
        assert snap["cache"]["evictions"] == 0, snap["cache"]
        for a, b in ((0, 2), (4, 6)):
            assert rows[a] == rows[b], f"sessions {a} and {b} share a pipeline, not records"
        assert all(len(rows[i]) == K for i in (1, 3, 5, 7)), [len(r) for r in rows]

        # launches: E5 (f32 non-causal, 12 a batch of 64), the oracle's
        # prefills and scoring forwards (bf16 causal, 28 each), its decode steps
        e5_batches = sum(-(-n // 64) for n in texts.calls)
        log(f"serving launches {launches}; flash_attention by kind {kinds}; {n_prefill} "
            f"prefills, {n_decode} decode steps, {forwards[0]} scoring forwards, "
            f"{e5_batches} embedder batches")
        assert kinds.get("float32 non-causal") == e5.num_layers * e5_batches, kinds
        llm = str(oracle_cfg.activation_dtype).removeprefix("torch.")
        assert kinds.get(f"{llm} causal") == \
            oracle_cfg.num_layers * (n_prefill + forwards[0]), kinds
        assert launches["flash_attention"] == sum(kinds.values()), (launches, kinds)
        assert launches["decode_attention"] == oracle_cfg.num_layers * n_decode > 0, launches
        assert launches["similarity"] >= len(queries), launches

        # the embedder's kernel path against its plain path on the card
        dev = repro_torch.current_device()
        (index,) = gw.index_registry._indexes.values()
        kernel_vecs = torch.from_numpy(np.asarray(index.vectors)).to(dev)
        t0 = time.perf_counter()
        plain = Embedder(E5_SMALL.with_(attn_impl="full"), params=embedder.params)
        plain_vecs = torch.from_numpy(plain.embed([r["text"] for r in docs])).to(dev)
        plain_s = time.perf_counter() - t0
        err = float((kernel_vecs - plain_vecs).abs().max())
        log(f"E5-small over {SERVE_DOCS} passages: kernel path against the plain path "
            f"(attn_impl='full', {plain_s:.2f} s): max abs error {err:.3g} (limit {EMB_TOL})")
        assert err <= EMB_TOL, f"embeddings differ by {err} > {EMB_TOL}"
        qk = torch.from_numpy(embedder.embed(queries)).to(dev)
        qp = torch.from_numpy(plain.embed(queries)).to(dev)
        same = topk_agree(qk @ kernel_vecs.T, qp @ plain_vecs.T, K, 2 * EMB_TOL)
        # each search session's hits are the top-K of its query over the index
        scores = qk @ kernel_vecs.T
        top = torch.topk(scores, K, dim=1).values
        for j, i in enumerate((1, 3, 5, 7)):
            got = torch.tensor([r["id"] for r in rows[i]], device=scores.device)
            gap = float((scores[j, got] - top[j]).abs().max())
            assert gap <= TOL, f"session {i}: hits are not its query's top-{K} ({gap})"
        log(f"sem_search top-{K} ids: the kernel path's equal to the plain path's in {same} "
            f"of {len(queries)} queries (the rest within a near-tie of {2 * EMB_TOL})")
    finally:
        gw.close()
    return launches


def stream_phase(args, smi: str) -> dict:
    """Phase 16: a continuous sem_sim_join (k 10, fp32 IVF) of 256 queries
    over a CorpusTable of the phase-2 mixture through four commits of 5,000
    appended rows, then the serving CLI as subprocesses."""
    rows = STREAM_ROWS
    total = rows + STREAM_COMMITS * STREAM_DELTA
    t0 = time.perf_counter()
    corpus, queries = make_corpus(total, args.seed, NOISE)   # phase 2's centres
    emb = TextCounter(RowEmbedder(corpus, queries))
    table = CorpusTable([{"id": i, "text": f"c:{i}"} for i in range(rows)])
    qrecs = [{"qid": j, "q": f"q:{j}"} for j in range(N_QUERIES)]
    sess = Session(oracle=None, embedder=emb)
    log(f"stream table {rows} x {DIM} made in {time.perf_counter() - t0:.2f} s")
    # the shared cache keeps one row per embedded text: room for all of them
    gw = Gateway(sess, max_inflight=1, cache_capacity=2 * (total + N_QUERIES))
    sub = None
    torch.cuda.reset_peak_memory_stats()
    try:
        plan = (SemFrame(qrecs, sess).lazy()
                .sem_sim_join(table.lazy(sess), "q", "text", k=K, index_kind="ivf",
                              quantize="none"))
        for _, mod in _KERNELS:
            mod.launches = 0
        emissions, walls, embedded = [], [], []
        t0 = time.perf_counter()
        sub = gw.subscribe(plan)
        for c in range(STREAM_COMMITS + 1):
            if c:
                lo = rows + (c - 1) * STREAM_DELTA
                t0 = time.perf_counter()
                table.append([{"id": i, "text": f"c:{i}"} for i in range(lo, lo + STREAM_DELTA)])
            em = sub.poll(timeout=600)
            assert em is not None and em.error is None, em
            assert em.version == c + 1, (em.version, c)
            walls.append(time.perf_counter() - t0)
            emissions.append(em)
            embedded.append(len(emb.texts))
        launches = {name: mod.launches for name, mod in _KERNELS}
        snap = gw.snapshot()
        (index,) = gw.index_registry._indexes.values()
        log(f"stream: emissions at versions {[e.version for e in emissions]} in "
            f"{[round(w, 2) for w in walls]} s (the first builds the IVF index), texts "
            f"embedded after each {embedded}; registry builds {snap['index_builds']} updates "
            f"{snap['index_updates']} delta rows {snap['index_delta_rows']}; index "
            f"{index.describe()}; launches {launches}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {smi}")
        assert snap["index_builds"] == 1 and snap["index_updates"] == STREAM_COMMITS, snap
        assert snap["index_delta_rows"] == STREAM_COMMITS * STREAM_DELTA, snap
        assert index.retrains == 0 and index.delta_rows == STREAM_COMMITS * STREAM_DELTA
        assert embedded[0] == rows + N_QUERIES, embedded
        assert np.diff(embedded).tolist() == [STREAM_DELTA] * STREAM_COMMITS, embedded
        assert launches["cluster_scan"] > 0 and launches["similarity"] > 0, launches

        # recall@10 of each emission against an exact search over its snapshot
        dev = repro_torch.current_device()
        q = torch.from_numpy(queries).to(dev)
        recalls = []
        for c, em in enumerate(emissions):
            n = rows + c * STREAM_DELTA
            exact = torch.topk(q @ torch.from_numpy(corpus[:n]).to(dev).T, K, dim=1)
            ids = np.full((N_QUERIES, K), -1)
            for r in em.records:
                row = ids[r["qid"]]
                row[np.argmax(row < 0)] = r["right_id"]
            assert (ids >= 0).all() and (ids < n).all(), "an emission misses or outgrows rows"
            recalls.append(recall(exact.indices.cpu().numpy(), ids))
        log(f"stream recall@{K} per emission against exact: {recalls} (floor {STREAM_RECALL})")
        assert min(recalls) >= STREAM_RECALL, recalls

        # the kernel path against the plain path on the same index; the
        # search an emission runs passes the snapshot's cutoff (max_pos),
        # which sorts each query's whole candidate row on the host
        t0 = time.perf_counter()
        got_s, got_i = index.search(queries, K)
        free_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        index.search(queries, K, max_pos=len(index))
        cut_s = time.perf_counter() - t0
        log(f"stream index search of {N_QUERIES} queries: {free_s:.3f} s, with the "
            f"snapshot cutoff (max_pos) {cut_s:.3f} s")
        saved = ops.DEFAULT_IMPL
        ops.DEFAULT_IMPL = "ref"
        try:
            want_s, want_i = index.search(queries, K)
        finally:
            ops.DEFAULT_IMPL = saved
        same = (got_i == want_i).all(axis=1)
        gap = float(np.abs(got_s - want_s)[~same].max()) if (~same).any() else 0.0
        assert gap <= TOL, f"IVF top-{K} ids differ from the plain path beyond a near-tie ({gap})"
        log(f"stream index search: top-{K} ids identical to the plain path's in "
            f"{int(same.sum())} of {N_QUERIES} queries, max score difference "
            f"{float(np.abs(got_s - want_s).max()):.3g}")
    finally:
        if sub is not None:
            sub.cancel()
        gw.close()
    del corpus, emb, table
    cli_runs(smi)
    return launches


def cli_runs(smi: str) -> None:
    """``python -m repro_torch.launch.serve`` as a user runs it, on the card:
    the simulated backend with auditing and a metrics dump, then the engine
    backend at make_session's own defaults."""
    os.makedirs(SERVE_DIR, exist_ok=True)
    dump = os.path.join(SERVE_DIR, "metrics.txt")
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.path.join(root, "src")}
    for argv, n in ((["--sessions", "8", "--tenants", "2", "--records", "400", "--audit",
                      "--metrics-dump", dump], 8),
                    (["--backend", "engine", "--sessions", "4"], 4)):
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", *argv]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, env=env, cwd=root, capture_output=True, text=True,
                             timeout=600)
        wall = time.perf_counter() - t0
        lines = res.stdout.splitlines()
        log(f"$ python -m repro_torch.launch.serve {' '.join(argv)}  (exit {res.returncode}, "
            f"{wall:.1f} s)")
        for line in lines:
            if not line.startswith('[serve] {"sid"'):
                log("  " + line[:600])
        assert res.returncode == 0, res.stderr[-4000:]
        assert any(line.startswith(f"[serve] {n}/{n} sessions") for line in lines), lines
        sessions = [json.loads(line[len("[serve] "):]) for line in lines
                    if line.startswith('[serve] {"sid"')]
        assert [s["status"] for s in sessions] == ["done"] * n, sessions
        if "--audit" in argv:
            audit = next(line for line in lines if line.startswith("[serve] audit "))
            report = json.loads(audit[len("[serve] audit "):])
            assert any(c["audited"] > 0 for c in report["cascades"]), report
            with open(dump, encoding="utf-8") as fh:
                samples = parse_exposition(fh.read())
            log(f"  metrics exposition: {len(samples)} samples parse, e.g. "
                f"repro_gateway_sessions_total "
                f"{ {k: v for k, v in samples.items() if 'gateway_sessions' in k} }")
    log(f"serving CLI on {smi}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=1_000_000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA device; none is available")
    torch.manual_seed(args.seed)
    t_start = _LAP[0] = time.perf_counter()

    # 1. device + build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    sku, bw, fp32, bf16 = peaks(kind)
    log(f"device: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; peaks for {sku}: "
        f"{bw / 1e12} TB/s, {fp32 / 1e12} TFLOP/s fp32, {bf16 / 1e12} TFLOP/s bf16")
    build_s = _build.build()
    log(f"kernels built in {build_s:.2f} s; ptxas -v, per kernel instance:")
    for name in _build.SOURCES:
        for fn, used, spills in ptxas_report(name):
            log(f"  {name}: {fn}: {used}; {spills}")

    lap("1 device and build")

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

    lap("2 retrieval indexes")

    # 3. kernels against their plain versions
    kres = kernel_phase(args, indexes["exact"], indexes["ivf"], indexes["ivf_int8"],
                        queries, bw, fp32)
    lap("3 retrieval kernels")

    # 4. the main path, counted
    torch.cuda.reset_peak_memory_stats()
    results, launches = main_path(corpus_texts, query_texts, emb, indexes)
    log(f"main path launches: {launches}")
    assert all(launches[name] > 0 for name, _ in _RETRIEVAL), launches
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
    plain_path_agrees(query_texts, emb, indexes, results)
    for name, idx in indexes.items():
        breakdown(name, idx, query_texts, emb)
    assert rec["ivf"] >= 0.90, rec
    assert rec["ivf_int8"] >= rec["ivf"] - 0.01, rec
    del indexes, results
    torch.cuda.empty_cache()
    lap("4 retrieval main path")

    # 5. the recall floor on the hard corpus
    hard_recall(args)
    torch.cuda.empty_cache()
    lap("5 hard corpus")

    # 6. small end to end, card against CPU
    small_end_to_end()
    lap("6 small end to end")

    # 7. the oracle's kernels against their plain versions
    kres.update(oracle_kernel_phase(args, bw, fp32, bf16))
    lap("7 oracle kernels")

    # 8. the LLM oracle at full width, counted
    oracle_launches = oracle_phase(args)
    launches["flash_attention"] = oracle_launches["flash_attention"]
    launches["rmsnorm"] = oracle_launches["rmsnorm"]
    lap("8 oracle")

    # 9. the decode kernel against its plain version
    kres.update(decode_kernel_phase(args, bw, bf16))
    lap("9 decode kernel")

    # 10. small generate, card against CPU
    small_generate_cuda_vs_cpu(args.seed)
    lap("10 small generate")

    # 11. the generate path at full width, counted (earlier phases' engines
    # are freed first, so that its peak memory is its own)
    gc.collect()
    torch.cuda.empty_cache()
    gen = generate_phase(args)
    launches["decode_attention"] = gen["launches"]["decode_attention"]
    lap("11 generate path")

    # 12. the generate path's kernel path against its plain path
    generate_agreement(gen)
    lap("12 generate agreement")

    # 13. paged decode against contiguous decode
    paged_phase(gen, args.seed)
    del gen
    torch.cuda.empty_cache()
    lap("13 paged decode")

    # 14. the SemFrame main path: plan, optimizer and operators over the kernels
    semframe_phase(args, smi)
    lap("14 semframe")

    # 15. the serving gateway at full width over the oracle and the embedder
    gc.collect()
    torch.cuda.empty_cache()
    serving = {"15 serving": serving_phase(args, smi)}
    gc.collect()
    torch.cuda.empty_cache()
    lap("15 serving")

    # 16. a continuous query over a growing table, and the serving CLI
    serving["16 stream"] = stream_phase(args, smi)
    lap("16 stream and CLI")
    log(f"serving launches {json.dumps(serving)}")

    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(f"device: {smi}")
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": _SOURCES[name][0],
         "replaces": _SOURCES[name][1], "launches": launches[name],
         "max_abs_err": kres[name]["max_abs_err"], "ms": kres[name]["ms"],
         "plain_ms": kres[name]["plain_ms"], "bound_ms": kres[name]["bound_ms"],
         "bound_by": kres[name]["bound_by"], "library_ms": kres[name]["library_ms"],
         "clock": kres[name]["clock"], "plain_clock": kres[name]["plain_clock"]}
        for name, _ in _KERNELS]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
