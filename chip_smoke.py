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
                only; the kernel's row stays the oracle's bf16 shape), and
                at mixtral's long prefill (q [1,8192,48,128], k/v
                [1,8192,8,128], window 4096, bf16 and f32; the plain version
                one kv-head's group at a time); the
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
                past S, and mixtral's heads and window (k/v [8,8192,8,128],
                48 q-heads, window 4096, lens past it); two calls give identical bits and every merge ticket
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
                must print every session done;
 17. the transformer families at full width — the MoE and VLM layouts at
                their published widths and vocabularies, bf16, random weights
                drawn on the card from ``--seed``, depth the one cut, one
                family at a time (each freed before the next, its peak
                memory printed).  First the three smoke configs (f32)
                generating on the card against the CPU: identical tokens,
                teacher-forced log-probs within 1e-5.  mixtral-8x22b (8 of
                56 layers, 4096 window) as the oracle of ``EngineModel``:
                ``predicate`` over 32 prompts, ``sem_map`` over 16 records
                (32 new tokens, 16 slots) and one prompt of 6,000 bytes
                through prefill (bucket 8192) and 16 decode steps, past the
                window, then that prompt teacher-forced (one row, prefill at
                bucket 8192, 15 decode steps at lens 6001-6015) through the
                kernel path and the chunked plain path (``attn_impl=
                "chunked"``, replaying the kernel path's experts) to
                FAMILY_BF16_LOGPROB_TOL, while the plain path without the
                window must land beyond it; paged against contiguous decode
                (8 rows, pages of 16).  llama4-maverick (2 of 48 layers: one moe_interleave
                group, 1 dense + 1 MoE layer of 128 experts with the shared
                expert): 8 requests of 16 new tokens.  llama-3.2-vision-11b
                (whole: 40 self layers, 8 cross blocks, their tanh gates set
                to 0.5 from their zero init): 8 requests through the
                scheduler, each with its own ``extra["image_embeds"]`` [1,
                4096, 4096]; one prompt with two images must give two first
                logits.  Launch counters set to 0 around each run:
                ``flash_attention`` once a self-attention layer a prefill or
                forward, ``decode_attention`` once a self-attention layer a
                decode step, none from a cross block; every request done,
                none failed or retried.  Prefill ms by bucket, the decode
                step by active slots, generated tokens/s, one decode step
                under the profiler (idle share).  The kernel path against
                the plain path (``attn_impl="full"``), teacher-forced over
                16 positions of 8 prompts: bf16 at the phase's depth to
                FAMILY_BF16_LOGPROB_TOL beside a second correct plain path
                (for the MoE configs the plain paths replay the kernel
                path's expert choices, and a plain path that routes by
                itself is printed with the router choices that differ), f32
                to 1e-4 for mixtral cut to 2 layers and the VLM cut to one
                group (5 self layers + 1 cross block).
 18. the encoder-decoder, recurrent and hybrid families at full width —
                whisper-small, xlstm-125m and zamba2-7b at their published
                widths, vocabularies and depths, bf16, random weights drawn
                on the card from ``--seed``, one family at a time (each freed
                before the next, its peak memory printed); whisper and
                zamba2 under ``attn_impl="auto"`` (their configs pin
                ``"chunked"``), the first model paths at bf16 hd 64 and hd
                112.  First the three smoke configs (f32) generating on the
                card against the CPU (prompts of 1 and 2 tokens among them):
                identical tokens, teacher-forced log-probs within 1e-5; both
                attention kernels at zamba2's and whisper's shapes against
                their plain versions, timed beside SDPA.  xlstm-125m and
                zamba2-7b as the oracle of ``EngineModel``: ``predicate``
                over 32 prompts, ``sem_map`` over 16 records and a generate
                call over prompts of 1 and 2 tokens (32 new tokens, 16
                slots), every prompt prefilled at its true length; each
                request's first decode logits against the teacher-forced
                forward over prompt + token (REC_FIRST_STEP_BF16_TOL), the
                bucket-padded prefill of the same prompts beyond that limit
                (the control that sees the pad tokens in the state), and the
                same first step in f32 activations at the whole depth to
                1e-4, its padded control beyond.  whisper-small: 8 requests
                through the scheduler, each with its own
                ``extra["audio_frames"]`` [1, 1500, 768], 16 new tokens; one
                prompt with two recordings gives two first logits.  Launch
                counters: a whisper forward launches ``flash_attention`` 24
                times (12 encoder + 12 decoder layers) and a decode step
                ``decode_attention`` 12 (cross attention none), zamba2 13
                and 13 (the shared block's 81 // 6 applications), xlstm
                none.  The kernel path against the config's own
                ``"chunked"`` path, teacher-forced over 16 positions of 8
                prompts, beside a second plain path (``"full"``): bf16 at the
                whole depth to FAMILY_BF16_LOGPROB_TOL, f32 to 1e-4 cut to
                whisper's 2 + 2 layers and zamba2's first group (6 layers
                and one shared application).  Prefill ms by length (by
                bucket for whisper), the decode step by active slots,
                tokens/s, one decode step under the profiler (idle share).
 19. training at full width — first the ``flash_attention`` backward
                kernel against its plain version (autograd through the
                contract) at the training shape (q [2,512,24,128], k/v
                [2,512,8,128], bf16 and f32, causal) and at ragged edges (Sq
                and Sk no multiple of 64, a window, rows no key may see, H/Hk
                8 with hd 100, hd 64, misaligned rows): f32 within
                BWD_F32_TOL, bf16 within BWD_BF16_TOL, two calls bit for bit;
                a second correct backward written out in f32 within the bf16
                limit and two gross faults (D omitted, the GQA group sum
                dropped) beyond it; timed beside SDPA's backward and the
                bound.  Then llama3.2-3b at its catalog config (28 layers,
                d 3072, 24/8 heads, vocab 128256, bf16 params, remat,
                random weights from ``--seed``), the default AdamW (f32
                master and moments): the first step's loss, gradient norm
                and wq/wk/wv gradients through the kernel pair against the
                plain path (``attn_impl="full"``) on the card, beside a
                second correct plain path (``"chunked"``) and a kernel path
                whose attention output is detached (it must fail); one train
                step under the profiler (idle share, busy time by kernel
                family); then ``loop.run`` over ``SyntheticSource(seed)``: 3
                steps of 4 x 512 tokens in 2 microbatches, launch counters
                set to 0 around it: ``flash_attention`` 28 x 2 x 2 and its
                backward 28 x 2 a step; loss finite, weights moved; step
                time, tokens/s and peak memory.  Its 45 GB checkpoint (params,
                master weights, moments) is not written (the loop's saver
                records the save instead).  At 2
                of 28 layers (reduced): ``compress_grads`` (int8, error
                feedback), and a run checkpointed at step 2 (restored bit
                for bit) and resumed to step 3 against the same steps run
                straight (RESUME_TOL).
 20. the distribution layer — four ranks (processes) on the one card,
                gloo carrying their CUDA tensors (NCCL refuses two ranks on
                one device), weights drawn from ``--seed`` on every rank:
                (a) context-parallel decode of llama3.2-3b (28 layers, bf16,
                vocab cut to 384) under ``activation_rules`` of a (1, 4)
                mesh, a cache of 16,384 positions (4,096 a rank, as
                ``DTensor``s), lens 4095, 4096, 9000 and 16,000, 8
                ``registry.decode_step``s against the whole cache through
                ``decode_attention`` on rank 0: log-probs within
                GEN_BF16_LOGPROB_TOL, f32 at 4 layers within 1e-4, the
                layer-0 caches rebuilt from the shards bit for bit,
                ``decode_attention`` 0 launches (the control 28 a step);
                (a') the same over a (2, 1, 2) ("pod", "data", "model")
                mesh under the "default" rules, which cut the cache stack
                [28, 4, 4096, 8, 128] over pod (14 layers a pod), data and
                model, while the attention cuts the batch over (pod, data):
                4 steps from lens 2045, 2047, 100 and 4000 against the
                one-process decode on the whole cache on rank 0, the same
                limits, the first and last layers gathered back bit for bit
                where nothing was written; (b)
                one mixtral-8x22b MoE layer expert parallel over (1, 4), two
                experts a rank, x [4, 512, 6144], against ``moe_ffn``:
                routes identical, bf16 within MOE_BF16_TOL of the largest
                output entry (a wrong shard offset beyond), f32 and the aux
                losses within 1e-5; (c) llama3.2-3b as 4 pipeline stages of
                7, 4 microbatches of [8, 512] tokens: logits against
                ``registry.forward`` (bf16; f32 at 8 layers), the loss and
                each leaf's gradient against ``loss_fn`` (f32 params and
                activations at 8 layers; at 28 in bf16 both the pipeline's
                and ``loss_fn``'s against the gradients of f32 copies of the
                same params, a wrong-stage control beyond the limit), 7
                ``flash_attention`` launches
                a microbatch a stage; (d) the sharded train step over (2, 2)
                at 4 layers (the cut), 2 steps of 4 x 512 against the
                single-process step (f32 activations: loss, params and each
                step's grad norm; bf16 printed), a planted fault (gradients
                unsummed over "data") beyond the grad-norm limit,
                ``flash_attention`` 2 x 4 and its backward 4 launches a step
                on every rank, each rank's share of the param and state
                bytes and its peak memory in a step; (d') the same over
                the (2, 1, 2) pod mesh, the layer stack cut over pod (2
                layers a pod), the planted fault gathering each layer from
                the other pod; (e) a 2-layer
                full-width checkpoint saved from a (4,) mesh and restored
                on (2, 2) by ``restore_sharded``, each rank's shards bit
                for bit; (f) ``python -m repro_torch.launch.train
                --num-processes 2 --coordinator ...`` as two processes,
                each process's final metrics against a one-process run of
                its shard.
 21. the launch/ tooling — the cost counter and the roofline
                (``launch/hlo_analysis.py``, ``roofline.py``, ``dryrun.py``,
                ``hlo_debug.py``) on three llama3.2-3b steps at its catalog
                config: phase 19's train step (4 x 512 tokens, 2
                microbatches), a 512-token prefill and a decode step of 32
                slots at 1024 positions.  (a) Each traced on meta tensors
                (``dryrun.build_cell``); (b) run on the card under
                ``CostMode``: FLOPs and bytes outside ``attn_core`` equal to
                the meta trace's exactly, each kernel's charges equal to its
                ``cost()`` at the launched shapes and its count to its
                launch counter (train: 112 forward, 56 backward); (c) one
                uncounted run under the profiler: wall, busy, idle share,
                t_compute, t_memory, bottleneck, the roofline step time and
                ``mfu_measured`` (model FLOPs over the bf16 peak times the
                wall); (d) hlo_debug's top 20 rows of the train step; (e)
                the meta trace's predicted peak memory beside
                ``max_memory_allocated`` (printed only).

Phases 15 and 16's launch counts are printed on a line of their own,
``serving launches {...}``, and each family of phases 17 and 18 its numbers
on a line ``<config> on <card>, <power limit>: {...}``.  The second-to-last
line of output is ``{"kernels": [...]}``, whose ``clock`` says how ``ms``
and ``library_ms`` were timed ("profiler": device time; "events": CUDA
events, host launch gaps included) and ``plain_clock`` the same of
``plain_ms``; the last is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import ast
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as tdist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

import repro_torch  # noqa: E402
from repro_torch.common import flatten, tree_to, unflatten  # noqa: E402
from repro_torch.configs import ShapeCell, get_config, get_smoke  # noqa: E402
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
from repro_torch.engine import runner as runner_mod  # noqa: E402
from repro_torch.engine.runner import ModelRunner  # noqa: E402
from repro_torch.engine.scheduler import ContinuousBatchScheduler, Request  # noqa: E402
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
from repro_torch.launch import dryrun, hlo_analysis, hlo_debug, roofline  # noqa: E402
from repro_torch.models import attention, layers, registry, transformer  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.data.pipeline import SyntheticSource, packed_batch  # noqa: E402
from repro_torch.train import grad_compress, loop as train_loop  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import trainstep  # noqa: E402
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


_RETRIEVAL = (("similarity", ksim), ("cluster_scan", kivf), ("cluster_scan_q", kivfq))
# every kernel: (name, its wrapper's module, the module's launch counter)
_KERNELS = tuple((n, m, "launches") for n, m in _RETRIEVAL) + (
    ("flash_attention", kfa, "launches"), ("rmsnorm", krn, "launches"),
    ("decode_attention", kda, "launches"),
    ("flash_attention_bwd", kfa, "backward_launches"))
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
                                 "src/repro/kernels/decode_attention.py:55"),
            # the gradient of flash_attention, which the Pallas kernel lacks
            "flash_attention_bwd": ("src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                                    "src/repro/kernels/flash_attention.py:64")}

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


def kernel_launches() -> dict:
    """Every kernel's launch count."""
    return {name: getattr(mod, attr) for name, mod, attr in _KERNELS}


def zero_launches() -> None:
    """Set every kernel's launch count to 0."""
    for _, mod, attr in _KERNELS:
        setattr(mod, attr, 0)


def free_card() -> None:
    """Return the memory of freed tensors to the card."""
    gc.collect()
    torch.cuda.empty_cache()


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


def interleaved_ms(kernel, library, reps: int) -> tuple[float, float, list[float], str]:
    """``device_ms`` of ``kernel`` and of ``library`` in turns over ROUNDS
    rounds, so that a drift of the card's clocks reaches both: -> (median
    kernel ms, median library ms, the ratio of each round, the clock).  A
    round in which the profiler kept no record of either side is left out
    of the medians and ratios and reported.  With no round left (deep into
    the run the profiler can stop keeping records altogether) both sides
    are timed again in turns by CUDA events, host launch gaps included,
    and the clock says "events"."""
    ks, ls = [], []
    for r in range(ROUNDS):
        a, b = device_ms(kernel, reps), device_ms(library, reps)
        if a is None or b is None:
            log(f"interleaved_ms: round {r + 1} of {ROUNDS} left out, the profiler kept no "
                f"record of the {'kernel' if a is None else 'library call'}")
            continue
        ks.append(a)
        ls.append(b)
    clock = "profiler"
    if not ks:
        log(f"interleaved_ms: the profiler kept no record in any of {ROUNDS} rounds; both "
            f"sides timed by CUDA events instead")
        for _ in range(ROUNDS):
            ks.append(cuda_ms(kernel, reps))
            ls.append(cuda_ms(library, reps))
        clock = "events"
    return statistics.median(ks), statistics.median(ls), [a / b for a, b in zip(ks, ls)], clock


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
        ms, lib, ratios, clock = interleaved_ms(run, lib_fn, reps)
    else:
        ms, lib, ratios, clock = device_ms(run, reps), None, [], "profiler"
        assert ms is not None, f"{name}: the profiler kept no record"
    plain, pclock = plain_ms(plain_fn, 3)
    bms, by = roofline.bound(nbytes, flops, hbm_bw=bw, peak=fp32)
    log(f"{name} {shape}, device time (profiler): kernel {ms:.4f} ms "
        f"({nbytes / ms / 1e6:.0f} GB/s, {flops / ms / 1e9:.1f} TFLOP/s, {bms / ms:.3f} of "
        f"the {by} bound {bms:.4f} ms), plain {plain:.4f} ms ({pclock}), {lib_name} "
        + (f"{lib:.4f} ms; median kernel / library {statistics.median(ratios):.3f} (each "
           "round: " + ", ".join(f"{r:.3f}" for r in ratios) + ")" if lib is not None
           else "not timed"))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms,
                bound_by=by, nbytes=nbytes, flops=flops, clock=clock, plain_clock=pclock,
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
    ms1, lib1, r1, _ = interleaved_ms(lambda: ksim.similarity(q1, c),
                                   lambda: torch.matmul(norm(q1, dim=1), norm(c, dim=1).T), 10)
    log(f"similarity q[1,{DIM}] x c[{nc},{DIM}] (sem_search's shape), device time (profiler): "
        f"kernel {ms1:.4f} ms ({4 * DIM * nc / ms1 / 1e6:.0f} GB/s of corpus), F.normalize + "
        f"matmul {lib1:.4f} ms, median kernel / library {statistics.median(r1):.3f}")
    out["similarity"] = retrieval_row(
        "similarity", f"q[{nq},{DIM}] x c[{nc},{DIM}]", err, lambda: ksim.similarity(q, c),
        lambda: ref.similarity_ref(q, c),
        lambda: torch.matmul(norm(q, dim=1), norm(c, dim=1).T), "F.normalize + matmul", 10,
        *ksim.cost(nq, nc, DIM)[::-1], bw, fp32)

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
        uniq = torch.unique(probes.long())
        # the scan's cost(): the valid rows of each distinct (block, cluster)
        # pair scored once against the block's 8 queries; the valid rows and
        # mask rows of the distinct probed clusters, the queries and probe ids
        # read once, the plane written once
        flops, nbytes = (kivf if name == "cluster_scan" else kivfq).cost(
            qp.shape[0], DIM, L, probes, sizes)
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
        ms1, lib1_ms, r1, _ = interleaved_ms(run1, lib1, 5)
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
    zero_launches()
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
    launches = kernel_launches()
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


def tensor_core_ops(symbol: str, library: str = "flash_attention",
                    ops: tuple[str, ...] = ("HGMMA", "HMMA")) -> dict[str, int]:
    """The tensor-core instructions (HGMMA: wgmma; HMMA: mma.sync; those in
    ``ops``) in the SASS of each instance of the kernel ``symbol`` in the
    built ``library``, by ``cuobjdump -sass``."""
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build.library_path(library))],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            if symbol in fn:
                counts[fn] = 0
        elif fn in counts and any(op in line for op in ops):
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
    # mixtral's prefill of the long prompt: 48/8 heads (6 a kv-head) at its
    # 8192 bucket under its 4096 window; the plain version runs one kv-head's
    # group at a time, which keeps its score plane at 1.6 GB
    mix = get_config(MIXTRAL)
    h, hk, hd, w = mix.num_heads, mix.num_kv_heads, mix.hd, mix.sliding_window
    grp = h // hk
    for dt in (b16, f32):
        q, k, v = qkv(1, 8192, 8192, h, hk, hd, dt)
        got = kfa.flash_attention(q, k, v, causal=True, window=w)
        e = max(close_err(got[:, :, j * grp:(j + 1) * grp],
                          ref.flash_attention_ref(q[:, :, j * grp:(j + 1) * grp],
                                                  k[:, :, j:j + 1], v[:, :, j:j + 1],
                                                  causal=True, window=w), ATTN_TOL[dt])
                for j in range(hk))
        log(f"flash_attention [b,sq,sk,h,hk,hd]={[1, 8192, 8192, h, hk, hd]} {dt} causal=True "
            f"window={w} (mixtral's long prefill): max abs err {e:.3g} (tol {ATTN_TOL[dt]} + rel)")
        err = max(err, e)
        del q, k, v, got
    tc = tensor_core_ops(kfa.KERNEL_NAMES[b16])
    log(f"flash_attention bf16 SASS (cuobjdump -sass): tensor-core instructions per "
        f"instance {tc}")
    assert tc and all(n > 0 for n in tc.values()), f"no HGMMA/HMMA in the bf16 kernel: {tc}"

    sdpa = torch.nn.functional.scaled_dot_product_attention
    for dt in (b16, f32):
        q, k, v = qkv(B, S, S, H, HK, HD, dt)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ms, lib, ratios, clock = interleaved_ms(
            lambda: kfa.flash_attention(q, k, v, causal=True),
            lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True), 10)
        plain, pclock = plain_ms(lambda: ref.flash_attention_ref(q, k, v, causal=True), 3)
        ev = cuda_ms(lambda: kfa.flash_attention(q, k, v, causal=True), 10)
        flops, nbytes = kfa.cost(B, S, S, H, HK, HD, causal=True, itemsize=q.element_size())
        bms, by = roofline.bound(nbytes, flops, hbm_bw=bw, peak=bf16 if dt == b16 else fp32)
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
                bound_by=by, nbytes=nbytes, flops=flops, clock=clock, plain_clock=pclock,
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
    ms, lib, ratios, clock = interleaved_ms(
        lambda: krn.rmsnorm(x, sc, eps=1e-5),
        lambda: torch.nn.functional.rms_norm(x, (D,), sc16, eps=1e-5), 20)
    plain, pclock = plain_ms(lambda: ref.rmsnorm_ref(x, sc, eps=1e-5), 10)
    flops, nbytes = krn.cost(B * S, D, itemsize=x.element_size())
    bms, by = roofline.bound(nbytes, flops, hbm_bw=bw, peak=fp32)
    out["rmsnorm"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                          bound_ms=bms, bound_by=by, nbytes=nbytes, flops=flops,
                          clock=clock, plain_clock=pclock,
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
    ms, lib, ratios, clock = interleaved_ms(lambda: kfa.flash_attention(q, k, v, causal=False),
                                     lambda: sdpa(qt, kt, vt), 10)
    plain, pclock = plain_ms(lambda: ref.flash_attention_ref(q, k, v, causal=False), 5)
    flops, nbytes = kfa.cost(b, s, s, h, hk, hd, causal=False, itemsize=4)
    bms, by = roofline.bound(nbytes, flops, hbm_bw=bw, peak=fp32)
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

    zero_launches()
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
    launches = kernel_launches()
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
                          ((8, 8192, 48, 8, 128), 4096),  # mixtral's heads and window
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
        ms, lib, ratios, clock = interleaved_ms(
            lambda: kda.decode_attention(q, k, v, lens),
            lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True), 20)
        plain, pclock = plain_ms(lambda: ref.decode_attention_ref(q, k, v, lens), 5)
        lib_err = float((sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True).transpose(1, 2)
                         .float() - ref.decode_attention_ref(q, k, v, lens).float())
                        .abs().max())
        rows = int((lens.clamp(max=S - 1) + 1).sum())          # attended cache rows
        flops, nbytes = kda.cost(B, S, H, HK, HD, lens, itemsize=q.element_size())
        bms, by = roofline.bound(nbytes, flops, hbm_bw=bw, peak=bf16)
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
                bound_by=by, nbytes=nbytes, flops=flops, clock=clock, plain_clock=pclock,
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
    """The runs of RecordedScheduler while the block runs.  On exit the class
    lets go of them (the caller's list keeps them), so that no scheduler,
    and through it no runner's weights, outlives its phase."""
    RecordedScheduler.runs = []
    saved = engine_mod.ContinuousBatchScheduler
    engine_mod.ContinuousBatchScheduler = RecordedScheduler
    try:
        yield RecordedScheduler.runs
    finally:
        engine_mod.ContinuousBatchScheduler = saved
        RecordedScheduler.runs, RecordedScheduler.current = [], None


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


@contextlib.contextmanager
def timed_steps(runner):
    """Time the runner's steps while the block runs: -> (prefills, decodes),
    lists of (prompt tokens, s) and (active slots, s).  Each step returns
    numpy, so it has ended on the card when its clock stops; its output must
    be finite.  The active slots are those of RecordedScheduler.current."""
    prefills, decodes = [], []
    prefill, decode = runner.prefill_into_slot, runner.decode

    def timed_prefill(tokens, slot, extra=None):
        t = time.perf_counter()
        out = prefill(tokens, slot, extra)
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
    try:
        yield prefills, decodes
    finally:
        del runner.prefill_into_slot, runner.decode      # the class's methods again


def teacher_forced(runner, prompt: np.ndarray, out: list[int], extra=None) -> np.ndarray:
    """Log-probs [len(out), V] along ``out`` through slot 0 of ``runner``."""
    logits = [runner.prefill_into_slot(prompt, 0, extra)]
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

    stats0 = dataclasses.replace(engine.stats)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with recorded_runs() as runs, timed_steps(runner) as (prefills, decodes):
        zero_launches()
        t0 = time.perf_counter()
        notes, st_map = sem_map(records, "a short note on {claim}", model)
        map_s = time.perf_counter() - t0
        map_tokens = engine.stats.generated_tokens - stats0.generated_tokens
        t0 = time.perf_counter()
        summary, st_agg = sem_agg_hierarchical(
            [{"note": n} for n in notes], "summarize {note}", model, fanout=8)
        agg_s = time.perf_counter() - t0
        launches = kernel_launches()
        n_prefill, n_decode, n_gen = check_runs(runs, [64, 8, 1])
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
    runner.decode(toks, lens)
    wall, recs = profiled(lambda: runner.decode(toks, lens))
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


def cut_depth(params: dict, depth: dict[str, int]) -> dict:
    """``params`` with each stack named in ``depth`` cut to its first
    ``depth[stack]`` layers (views, no copy)."""
    def cut(tree, n):
        return {k: cut(v, n) if isinstance(v, dict) else v[:n] for k, v in tree.items()}
    return {**params, **{stack: cut(params[stack], n) for stack, n in depth.items()}}


@torch.inference_mode()
def forced_decode(cfg, params, prompt: torch.Tensor, forced=None, *, steps: int = GEN_NEW,
                  extra=None, bucket: int = 0):
    """Prefill ``prompt`` [B, T0] (with ``extra``, the VLM's images) into a
    fresh cache, then ``steps - 1`` decode steps: greedy when ``forced`` is
    None, else fed ``forced`` [B, steps].  With ``bucket`` the prompt is
    padded with zeros to ``bucket`` positions, as the runner pads a prefill.
    -> (log-probs [B, steps, V] f32, the tokens fed [B, steps])."""
    b, t0 = prompt.shape
    cache = registry.init_cache(cfg, b, max(bucket, t0 + steps), device=prompt.device)
    if bucket:
        padded = torch.nn.functional.pad(prompt, (0, bucket - t0))
        logits, _ = registry.prefill(cfg, params, padded, cache, extra=extra)
        logits = logits[:, :t0]
    else:
        logits, _ = registry.prefill(cfg, params, prompt, cache, extra=extra, last_only=True)
    lps = [torch.log_softmax(logits[:, -1].float(), dim=-1)]
    toks = [lps[-1].argmax(-1) if forced is None else forced[:, 0]]
    for i in range(steps - 1):
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
    p32 = cut_depth(params, {"layers": n})
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
    zero_launches()

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

        zero_launches()
        forwards[0] = 0
        torch.cuda.reset_peak_memory_stats()
        with recorded_runs() as runs, attention_kinds() as kinds:
            wall, busy, n_recs = device_busy(serve)
        launches = kernel_launches()
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
        zero_launches()
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
        launches = kernel_launches()
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


# ---------------------------------------------------------------------------
# Phase 17: the transformer families at full width (MoE and VLM layouts)
# ---------------------------------------------------------------------------

MIXTRAL, MAVERICK, VISION = ("mixtral-8x22b", "llama4-maverick-400b-a17b",
                             "llama-3.2-vision-11b")
# Depth is the one cut: published widths and vocabularies, bf16, random
# weights from --seed.  mixtral 8 of 56 layers (40.9 GB of weights);
# maverick 2 of 48, one moe_interleave group (1 dense + 1 MoE layer of 128
# experts with the shared expert, 37.1 GB); the VLM whole (40 self layers +
# 8 cross blocks, 23.0 GB).  The whole mixtral (281 GB) and maverick do not
# fit one 80 GB card.
FAMILY_LAYERS = {MIXTRAL: 8, MAVERICK: 2, VISION: 40}
# The f32 agreement runs over the first layers of the drawn weights: mixtral 2
# layers, the VLM one group (5 self layers + 1 cross block).  Maverick's one
# group would cast each 128-expert weight to f32 (21.5 GB a tensor) beside
# its 37.1 GB: its f32 check is the small config's.
FAMILY_F32_STACKS = {MIXTRAL: {"layers": 2}, VISION: {"layers": 5, "cross_layers": 1}}
FAMILY_POSITIONS = 16   # teacher-forced positions of the agreement (prefill + 15 steps)
FAMILY_NEW = 16         # new tokens of maverick's and the VLM's requests
LONG_PROMPT_BYTES = 6000   # mixtral: prefill at bucket 8192, decode past the 4096 window
# bf16 agreement of the kernel path with the plain path, teacher-forced: phase
# 12's limit, set there between the kernel path's reading and two gross faults.
# A router whose top choices nearly tie can pick another expert on the other
# path's rounding, which moves that token by a whole expert's difference and is
# no fault of an attention kernel: for the MoE configs the plain paths replay
# the kernel path's expert choices (each layer's own probabilities give the
# gates) and are held to the limits, and the distance of a plain path that
# routes by itself is printed with the count of router choices that differ.
FAMILY_BF16_LOGPROB_TOL = GEN_BF16_LOGPROB_TOL


@contextlib.contextmanager
def recorded_routes():
    """The expert ids [B, S, k] of every MoE layer call, in call order, while
    the block runs.  The patch holds because ``moe_ffn`` looks up the
    module-level ``route`` at each call."""
    ids, route = [], moe_mod.route

    def recording(params, x, *, cfg):
        out = route(params, x, cfg=cfg)
        ids.append(out[3])
        return out

    moe_mod.route = recording
    try:
        yield ids
    finally:
        moe_mod.route = route


@contextlib.contextmanager
def replayed_routes(ids: list):
    """Every MoE layer call takes the next experts of ``ids`` (another run's,
    in call order) in place of its own top-k; its gates are its own
    probabilities at those experts, renormalized as the router does.  As in
    :func:`recorded_routes`, the patch holds because ``moe_ffn`` looks up the
    module-level ``route`` at each call."""
    calls, route = iter(ids), moe_mod.route

    def replaying(params, x, *, cfg):
        logits, probs = route(params, x, cfg=cfg)[:2]
        idx = next(calls)
        gates = probs.gather(-1, idx)
        if cfg.experts_per_token > 1:
            gates = gates / gates.sum(dim=-1, keepdim=True)
        return (logits, probs, gates, idx) + moe_mod.assign_slots(idx, cfg=cfg)

    moe_mod.route = replaying
    try:
        yield
    finally:
        moe_mod.route = route
    assert next(calls, None) is None, "a replayed run made fewer MoE calls"


def route_flips(a: list, b: list) -> tuple[int, int]:
    """(router choices that differ, choices) between two runs' routes."""
    assert len(a) == len(b), (len(a), len(b))
    return (sum(int((x != y).sum()) for x, y in zip(a, b)),
            sum(x.numel() for x in a))


def family_engine(name: str, seed: int, *, max_slots: int, max_seq: int) -> InferenceEngine:
    """The family's engine at its published widths and vocabulary, cut to
    FAMILY_LAYERS, its bf16 weights drawn on the card from ``seed``."""
    full = get_config(name)
    cfg = full.with_(num_layers=FAMILY_LAYERS[name])
    assert cfg.attn_impl == "auto"   # the shipped default: the kernels on the card
    t0 = time.perf_counter()
    engine = InferenceEngine(cfg, seed=seed, max_slots=max_slots, max_seq=max_seq)
    torch.cuda.synchronize()
    leaves = list(flatten(engine.runner.params).values())
    cache = flatten(engine.runner.cache).values()
    log(f"cut: {name} depth {full.num_layers} -> {cfg.num_layers} layers "
        f"({transformer.layer_layout(cfg)})")
    log(f"{name}: d {cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads}, hd {cfg.hd}, "
        f"ff {cfg.d_ff}, vocab {cfg.vocab_size}, experts {cfg.num_experts} top "
        f"{cfg.experts_per_token}, window {cfg.sliding_window}, {cfg.dtype}: "
        f"{sum(t.numel() for t in leaves)} params "
        f"({sum(t.numel() * t.element_size() for t in leaves) / 1e9:.1f} GB) drawn on the card "
        f"in {time.perf_counter() - t0:.2f} s; {max_slots} slots x {max_seq} positions, "
        f"KV cache {sum(t.numel() * t.element_size() for t in cache) / 2**30:.2f} GiB")
    return engine


def family_timings(name, runner, prefills, decodes, gen_tokens: int, run_s: float,
                   seed: int) -> dict:
    """Print the family's prefill ms at each bucket (at each length for a
    recurrent family, which the runner prefills at its true length), the
    decode step at its active slots, generated tokens/s and one decode step
    (all slots, as the runner always steps) under the profiler, whose
    ``decode_attention`` time must be above 0 where the family attends."""
    recurrent = runner.cfg.family in registry.RECURRENT
    by_bucket: dict[int, list[float]] = {}
    for n, dt in prefills:
        key = n if recurrent else min(runner_mod._bucket(n), runner.max_seq)
        by_bucket.setdefault(key, []).append(dt * 1e3)
    by_active: dict[int, list[float]] = {}
    for a, dt in decodes:
        by_active.setdefault(a, []).append(dt * 1e3)
    lens_v = min(520, runner.max_seq - 1)
    toks = np.random.default_rng(seed).integers(0, 256, runner.max_slots).astype(np.int32)
    lens = np.full(runner.max_slots, lens_v, np.int32)
    runner.decode(toks, lens)
    wall, recs = profiled(lambda: runner.decode(toks, lens))
    busy = sum(e.self_device_time_total for e in recs) / 1e3
    attn = sum(e.self_device_time_total for e in recs if kda.KERNEL_PREFIX in e.key) / 1e3
    attends = runner.cfg.family != "ssm" and runner.cfg.attn_impl in ("auto", "pallas")
    if recs:   # deep into the run the profiler can keep no record at all
        assert (attn > 0) == attends, \
            f"{name}: the decode step's profile reads {attn} ms of {kda.KERNEL_PREFIX}*"
    else:
        log(f"{name}: the profiler kept no device record of the decode step: busy, idle share "
            f"and decode_attention time not measured (the launch counters hold the kernel)")
    out = {"prefill_ms": {b: statistics.median(v) for b, v in sorted(by_bucket.items())},
           "decode_ms": {a: statistics.median(v) for a, v in sorted(by_active.items())},
           "tokens_per_s": gen_tokens / run_s,
           "idle_share": 1 - busy / wall if recs else None}
    log(f"{name}: prefill ms by {'length' if recurrent else 'bucket'} (median, count) "
        + ", ".join(f"{b}: {statistics.median(v):.2f} x{len(v)}"
                    for b, v in sorted(by_bucket.items()))
        + "; decode step ms by active slots (median, count) "
        + ", ".join(f"{a}: {statistics.median(v):.2f} x{len(v)}"
                    for a, v in sorted(by_active.items()))
        + f"; {gen_tokens} generated tokens in {run_s:.2f} s ({out['tokens_per_s']:.1f} "
        f"tokens/s); one decode step [{runner.max_slots} slots, lens {lens_v}] under the "
        f"profiler: wall {wall:.2f} ms, device busy {busy:.3f} ms, idle share "
        f"{out['idle_share']}, decode_attention {attn:.3f} ms")
    return out


def family_agreement(engine, prompt: torch.Tensor, extra=None, extra32=None) -> dict:
    """The family's kernel path against its plain path (attn_impl="full") on
    the card, teacher-forced along the kernel path's greedy tokens over
    FAMILY_POSITIONS positions: bf16 at the phase's depth, with a second
    correct plain path (the chunked online softmax) beside it, to
    FAMILY_BF16_LOGPROB_TOL; f32 over FAMILY_F32_STACKS to
    GEN_F32_LOGPROB_TOL.  For the MoE configs the plain paths replay the
    kernel path's expert choices, and a plain path that routes by itself is
    printed beside them with the router choices that differ."""
    cfg, params = engine.cfg, engine.runner.params
    name, steps = cfg.name, FAMILY_POSITIONS

    def paths(cfg, params, prompt, extra, controls: bool) -> dict:
        plain = cfg.with_(attn_impl="full")
        n0 = (kda.launches, kfa.launches)
        lp = {}
        with recorded_routes() as routes:
            lp["kernel"], toks = forced_decode(cfg, params, prompt, steps=steps, extra=extra)
        assert (kda.launches - n0[0], kfa.launches - n0[1]) == \
            (cfg.num_layers * (steps - 1), cfg.num_layers), name
        runs = [("plain", None)] + ([("chunked plain", _chunked_attend)] if controls else [])
        for path, attend in runs:
            with contextlib.ExitStack() as stack:
                if attend is not None:
                    stack.enter_context(plain_attention(attend))
                if cfg.is_moe:
                    stack.enter_context(replayed_routes(routes))
                lp[path], _ = forced_decode(plain, params, prompt, toks, steps=steps,
                                            extra=extra)
        dist = {path: float((lp[path] - lp["plain"]).abs().max()) for path in lp
                if path != "plain"}
        if cfg.is_moe:   # the plain path routing by itself
            with recorded_routes() as own:
                free, _ = forced_decode(plain, params, prompt, toks, steps=steps,
                                        extra=extra)
            dist["kernel, plain routing by itself"] = float((lp["kernel"] - free).abs().max())
            dist["router choices that differ"], dist["router choices"] = \
                route_flips(routes, own)
        assert all(bool(torch.isfinite(v).all()) for v in lp.values()), name
        return dist

    out = {"bf16": paths(cfg, params, prompt, extra, True)}
    log(f"{name} agreement, bf16, {cfg.num_layers} layers, {prompt.shape[0]} sequences of "
        f"{prompt.shape[1]} tokens x {steps} positions, max abs log-prob distance from the "
        f"plain path{' (which replays the kernel path' + chr(39) + 's experts)' if cfg.is_moe else ''}"
        f" (limit {FAMILY_BF16_LOGPROB_TOL}): {out['bf16']}")
    assert out["bf16"]["kernel"] <= FAMILY_BF16_LOGPROB_TOL and \
        out["bf16"]["chunked plain"] <= FAMILY_BF16_LOGPROB_TOL, (name, out)
    stacks = FAMILY_F32_STACKS.get(name)
    if stacks:
        cfg32 = cfg.with_(num_layers=stacks["layers"], dtype="float32")
        out["f32"] = paths(cfg32, cut_depth(params, stacks), prompt, extra32, False)
        log(f"{name} agreement, f32, {stacks} (tol {GEN_F32_LOGPROB_TOL}): {out['f32']}")
        assert out["f32"]["kernel"] <= GEN_F32_LOGPROB_TOL, (name, out)
    free_card()
    return out


def long_agreement(engine, prompt: np.ndarray) -> dict:
    """The long prompt, one row, through the kernel path and the plain path,
    teacher-forced along the kernel path's greedy tokens: the prefill padded
    to its bucket as the runner pads it, then FAMILY_POSITIONS - 1 decode
    steps at lens past the window.  The plain path is attn_impl="chunked":
    the online softmax over KV blocks in prefill (it builds no S x S score
    plane) and ``gqa_attend`` under the window mask in decode; it replays
    the kernel path's experts.  The plain path without the window, a kernel
    that ignored it, must land beyond the limit: the check tells a window
    fault at these positions."""
    cfg, params = engine.cfg, engine.runner.params
    steps, t0 = FAMILY_POSITIONS, len(prompt)
    bucket = min(runner_mod._bucket(t0), engine.runner.max_seq)
    assert t0 > cfg.sliding_window > 0, (t0, cfg.sliding_window)
    toks = torch.from_numpy(np.asarray(prompt, np.int64))[None].to(engine.runner.device)
    n0 = (kda.launches, kfa.launches)
    with recorded_routes() as routes:
        lp, forced = forced_decode(cfg, params, toks, steps=steps, bucket=bucket)
    n1 = (kda.launches, kfa.launches)
    assert (n1[0] - n0[0], n1[1] - n0[1]) == (cfg.num_layers * (steps - 1), cfg.num_layers)
    dist = {}
    for path, plain in (("kernel", cfg.with_(attn_impl="chunked")),
                        ("plain without the window",
                         cfg.with_(attn_impl="chunked", sliding_window=0))):
        with replayed_routes(routes):
            other, _ = forced_decode(plain, params, toks, forced, steps=steps, bucket=bucket)
        assert bool(torch.isfinite(other).all()), path
        dist[path] = float((lp - other).abs().max())
    assert (kda.launches, kfa.launches) == n1, "the plain path launched a kernel"
    assert bool(torch.isfinite(lp).all())
    log(f"{cfg.name} long prompt, bf16, {cfg.num_layers} layers: {t0} tokens prefilled at "
        f"bucket {bucket}, {steps - 1} decode steps at lens {t0}..{t0 + steps - 2} under window "
        f"{cfg.sliding_window}, teacher-forced; max abs log-prob distance of the kernel path "
        f"from the chunked plain path replaying its experts {dist['kernel']:.4g} (limit "
        f"{FAMILY_BF16_LOGPROB_TOL}); of the plain path without the window "
        f"{dist['plain without the window']:.4g} (must exceed the limit)")
    assert dist["kernel"] <= FAMILY_BF16_LOGPROB_TOL < dist["plain without the window"], dist
    del lp, forced, routes
    free_card()
    return dist


def agreement_prompts(seed: int, n: int = 8) -> torch.Tensor:
    """``n`` oracle prompts cut to one length, as token ids on the card."""
    toks = [TOKENIZER.encode(p) for p in oracle_prompts(n, seed)]
    t0 = min(len(t) for t in toks)
    return torch.tensor([t[:t0] for t in toks], dtype=torch.int64, device="cuda")


def mixtral_run(args) -> dict:
    """mixtral-8x22b (8 layers) as the oracle of EngineModel: predicate over
    32 prompts, sem_map over 16 records (32 new tokens, 16 slots), one
    prompt of about LONG_PROMPT_BYTES bytes through prefill (bucket 8192)
    and 16 decode steps past the 4096 window, and teacher-forced through
    the kernel path and the chunked plain path; paged against contiguous
    decode; the kernel path against the plain path."""
    t_start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    engine = family_engine(MIXTRAL, args.seed, max_slots=16, max_seq=8192)
    cfg, runner = engine.cfg, engine.runner
    model = EngineModel(engine, max_new_tokens=32)
    engine.generate(["warm-up: cuBLAS and the kernels load"], max_new_tokens=2)
    prompts = oracle_prompts(32, args.seed + 17)
    records = [{"claim": p} for p in oracle_prompts(16, args.seed + 18)]
    long_prompt = oracle_prompts(1, args.seed + 19, LONG_PROMPT_BYTES, LONG_PROMPT_BYTES)[0]
    with recorded_runs() as runs, timed_steps(runner) as (prefills, decodes):
        zero_launches()
        t0 = time.perf_counter()
        passes, scores = model.predicate(prompts)
        pred_s = time.perf_counter() - t0
        n_pred = kernel_launches()
        t0 = time.perf_counter()
        notes, _ = sem_map(records, "a short note on {claim}", model)
        engine.generate([long_prompt], max_new_tokens=16)
        run_s = time.perf_counter() - t0
        launches = kernel_launches()
        n_prefill, n_decode, n_gen = check_runs(runs, [16, 1])
    assert passes.shape == (32,) and np.isfinite(scores).all()
    assert len(notes) == 16 and all(isinstance(n, str) for n in notes)
    long = runs[1][1][0]
    assert len(long.tokens) > cfg.sliding_window + 1 and \
        runs[1][0].decode_steps == len(long.out_tokens) - 1
    assert n_pred["flash_attention"] == cfg.num_layers and n_pred["decode_attention"] == 0
    assert launches["flash_attention"] == cfg.num_layers * (1 + n_prefill), launches
    assert launches["decode_attention"] == cfg.num_layers * n_decode, (launches, n_decode)
    log(f"{MIXTRAL}: predicate over 32 prompts {pred_s * 1e3:.1f} ms (one forward); sem_map "
        f"over 16 records and the {len(long.tokens)}-token prompt ({len(long.out_tokens)} "
        f"tokens past position {len(long.tokens)}, window {cfg.sliding_window}): {n_prefill} "
        f"prefills, {n_decode} decode steps, launches {launches}")
    out = family_timings(MIXTRAL, runner, prefills, decodes, n_gen, run_s, args.seed)
    out["launches"] = launches
    out["long_agreement"] = long_agreement(engine, long.tokens)
    out["paged_launches"] = paged_phase({"engine": engine}, args.seed)
    out["agreement"] = family_agreement(engine, agreement_prompts(args.seed + 20))
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["wall_s"] = time.perf_counter() - t_start
    log(f"{MIXTRAL}: peak memory {out['peak_gib']:.2f} GiB; wall {out['wall_s']:.1f} s")
    del engine, runner, model
    free_card()
    return out


def maverick_run(args) -> dict:
    """llama4-maverick, one moe_interleave group: 8 requests generating
    FAMILY_NEW tokens each; the kernel path against the plain path."""
    t_start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    engine = family_engine(MAVERICK, args.seed, max_slots=8, max_seq=1024)
    cfg, runner = engine.cfg, engine.runner
    engine.generate(["warm-up: cuBLAS and the kernels load"], max_new_tokens=2)
    prompts = oracle_prompts(8, args.seed + 21)
    with recorded_runs() as runs, timed_steps(runner) as (prefills, decodes):
        zero_launches()
        t0 = time.perf_counter()
        texts = engine.generate(prompts, max_new_tokens=FAMILY_NEW)
        run_s = time.perf_counter() - t0
        launches = kernel_launches()
        n_prefill, n_decode, n_gen = check_runs(runs, [8])
    assert len(texts) == 8 and all(isinstance(t, str) for t in texts)
    assert launches["flash_attention"] == cfg.num_layers * n_prefill, launches
    assert launches["decode_attention"] == cfg.num_layers * n_decode, (launches, n_decode)
    log(f"{MAVERICK}: 8 requests x {FAMILY_NEW} new tokens: {n_prefill} prefills, {n_decode} "
        f"decode steps, launches {launches}")
    out = family_timings(MAVERICK, runner, prefills, decodes, n_gen, run_s, args.seed)
    out["launches"] = launches
    out["agreement"] = family_agreement(engine, agreement_prompts(args.seed + 22))
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["wall_s"] = time.perf_counter() - t_start
    log(f"{MAVERICK}: peak memory {out['peak_gib']:.2f} GiB; wall {out['wall_s']:.1f} s")
    del engine, runner
    free_card()
    return out


def drawn(shape: tuple, seed: int, dtype=torch.bfloat16) -> torch.Tensor:
    """A standard normal tensor of ``shape`` drawn on the card from ``seed``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


def images(cfg, n: int, seed: int, dtype=torch.bfloat16) -> torch.Tensor:
    """``n`` image embeddings [n, num_image_tokens, d] drawn on the card."""
    return drawn((n, cfg.num_image_tokens, cfg.d_model), seed, dtype)


def set_cross_gates(params, value: float) -> None:
    """The cross blocks' tanh gates are zeros at init, which makes every
    cross block the identity: set them so that the image counts."""
    for gate in ("attn_gate", "ffn_gate"):
        params["cross_layers"][gate].fill_(value)


def vision_run(args) -> dict:
    """llama-3.2-vision-11b, whole: 8 requests through the scheduler, each
    with its own image (extra["image_embeds"] [1, 4096, 4096] bf16); the
    same prompt with two images gives two first logits; the kernel path
    against the plain path."""
    t_start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    engine = family_engine(VISION, args.seed, max_slots=8, max_seq=1024)
    cfg, runner = engine.cfg, engine.runner
    set_cross_gates(runner.params, 0.5)
    imgs = images(cfg, 8, args.seed + 23)
    prompts = [np.asarray(TOKENIZER.encode(p), np.int32)
               for p in oracle_prompts(8, args.seed + 24)]
    runner.prefill_into_slot(prompts[0][:16], 0, {"image_embeds": imgs[:1]})   # warm-up
    with recorded_runs() as runs, timed_steps(runner) as (prefills, decodes):
        zero_launches()
        sched = RecordedScheduler(runner, sampler=engine.sampler)
        for i, p in enumerate(prompts):
            sched.submit(Request(rid=i, tokens=p, max_new_tokens=FAMILY_NEW,
                                 stop_id=TOKENIZER.eos_id,
                                 extra={"image_embeds": imgs[i:i + 1]}))
        t0 = time.perf_counter()
        sched.run_to_completion()
        run_s = time.perf_counter() - t0
        launches = kernel_launches()
        n_prefill, n_decode, n_gen = check_runs(runs, [8])
    assert launches["flash_attention"] == cfg.num_layers * n_prefill, launches
    assert launches["decode_attention"] == cfg.num_layers * n_decode, (launches, n_decode)
    a = runner.prefill_into_slot(prompts[0], 0, {"image_embeds": imgs[:1]})
    b = runner.prefill_into_slot(prompts[0], 0, {"image_embeds": imgs[1:2]})
    d_img = float(np.abs(a - b).max())
    log(f"{VISION}: 8 requests x {FAMILY_NEW} new tokens, one image each: {n_prefill} "
        f"prefills, {n_decode} decode steps, launches {launches} (the "
        f"{transformer.layer_layout(cfg)['cross']} cross blocks launch none); one prompt, "
        f"two images: first logits {d_img:.4g} apart")
    assert d_img > 1e-3, d_img
    out = family_timings(VISION, runner, prefills, decodes, n_gen, run_s, args.seed)
    out["launches"] = launches
    prompt = agreement_prompts(args.seed + 25)
    b_ = prompt.shape[0]
    out["agreement"] = family_agreement(
        engine, prompt, {"image_embeds": images(cfg, b_, args.seed + 26)},
        {"image_embeds": images(cfg, b_, args.seed + 26, torch.float32)})
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["wall_s"] = time.perf_counter() - t_start
    log(f"{VISION}: peak memory {out['peak_gib']:.2f} GiB; wall {out['wall_s']:.1f} s")
    del engine, runner, imgs
    free_card()
    return out


def small_cuda_vs_cpu(cfg, seed: int, toks: list, per_step: tuple[int, int],
                      extra=lambda i: None, prepare=lambda params: None) -> None:
    """A smoke config (f32) generating on the card against the same weights
    on the CPU, whose plain path the tests hold against JAX: the requests
    ``toks`` (``extra(i)`` each) through 3 slots, 12 new tokens each; the
    tokens are identical (up to a near-tie the CPU's own log-probs show),
    the card's tokens teacher-forced through both give log-probs within
    1e-5, and each prefill launches ``flash_attention`` and each decode
    step ``decode_attention`` as ``per_step`` says.  ``prepare`` edits the
    drawn weights first."""
    name = cfg.name
    gpu = InferenceEngine(cfg, seed=seed, max_slots=3, max_seq=64)
    prepare(gpu.runner.params)

    def run(runner):
        with recorded_runs() as runs:
            sched = RecordedScheduler(runner)
            for i, t in enumerate(toks):
                sched.submit(Request(rid=i, tokens=t, max_new_tokens=12, extra=extra(i)))
            sched.run_to_completion()
            steps = check_runs(runs, [len(toks)])
        return {r.rid: r for r in runs[0][1]}, steps

    n0 = kernel_launches()
    got, (n_pre, n_dec, _) = run(gpu.runner)
    n1 = kernel_launches()
    assert (n1["flash_attention"] - n0["flash_attention"],
            n1["decode_attention"] - n0["decode_attention"]) == \
        (per_step[0] * n_pre, per_step[1] * n_dec), (name, n0, n1)
    repro_torch.set_device("cpu")
    try:
        cpu = ModelRunner(cfg, tree_to(gpu.runner.params, torch.device("cpu")),
                          max_slots=3, max_seq=64)
        want, _ = run(cpu)
        err, parted = 0.0, []
        for rid, r in got.items():
            lg = teacher_forced(gpu.runner, r.tokens, r.out_tokens, extra(rid))
            lc = teacher_forced(cpu, r.tokens, r.out_tokens, extra(rid))
            err = max(err, float(np.abs(lg - lc).max()))
            c = want[rid].out_tokens
            if c != r.out_tokens:
                i = next(j for j, (x, y) in enumerate(zip(c, r.out_tokens)) if x != y)
                top2 = np.sort(lc[i])[-2:]
                assert c[:i] == r.out_tokens[:i] and top2[1] - top2[0] < NEAR_TIE, \
                    (name, rid, i, top2)
                parted.append((rid, i, float(top2[1] - top2[0])))
    finally:
        repro_torch.set_device(None)
    assert err <= 1e-5, (name, err)
    log(f"small {name} ({cfg.family}, {cfg.num_layers} layers, d {cfg.d_model}, f32, attn_impl "
        f"{cfg.attn_impl}, {len(toks)} requests of {sorted(len(t) for t in toks)} tokens x 12): "
        f"card tokens == CPU tokens except at near-ties {parted}; teacher-forced log-probs "
        f"within {err:.3g}; {n_pre} prefills, {n_dec} decode steps")


def small_families_cuda_vs_cpu(seed: int) -> None:
    """The three smoke configs of phase 17 through small_cuda_vs_cpu: 5
    requests each (the VLM's each with its own image, its cross gates set
    to 0.5), ``flash_attention`` once a self-attention layer a prefill,
    ``decode_attention`` once a decode step."""
    for name in (MIXTRAL, MAVERICK, VISION):
        cfg = get_smoke(name)
        rng = np.random.default_rng(seed + 27)
        toks = [rng.integers(1, cfg.vocab_size, int(rng.integers(3, 30))).astype(np.int32)
                for _ in range(5)]
        vlm = cfg.family == "vlm"
        imgs = images(cfg, 5, seed + 28, torch.float32) if vlm else None
        small_cuda_vs_cpu(
            cfg, seed, toks, (cfg.num_layers, cfg.num_layers),
            extra=lambda i: None if imgs is None else {"image_embeds": imgs[i:i + 1]},
            prepare=lambda params: set_cross_gates(params, 0.5) if vlm else None)


def families_phase(args, smi: str) -> dict:
    """Phase 17: the MoE and VLM layouts at full width, one family at a
    time, each freed before the next."""
    free_card()
    small_families_cuda_vs_cpu(args.seed)
    out = {}
    for name, run in ((MIXTRAL, mixtral_run), (MAVERICK, maverick_run),
                      (VISION, vision_run)):
        out[name] = run(args)
        free_card()
        log(f"{name} on {smi}: {json.dumps(out[name])}")
    return out


# ---------------------------------------------------------------------------
# Phase 18: the recurrent and encoder-decoder families at full width
# ---------------------------------------------------------------------------

WHISPER, XLSTM, ZAMBA = "whisper-small", "xlstm-125m", "zamba2-7b"
# Published widths, vocabularies and depths, bf16, random weights from --seed:
# whisper-small 12 + 12 layers, xlstm-125m 12 blocks (9 mLSTM, 3 sLSTM),
# zamba2-7b 81 Mamba2 layers with 13 applications of one shared attention
# block.  whisper and zamba2 pin attn_impl="chunked" in their configs; this
# phase serves them under "auto", the kernel path, and holds that path to
# their "chunked" one.
REC_PREDICATES, REC_RECORDS, REC_NEW, REC_SLOTS = 32, 16, 32, 16
REC_SHORT = ["", "a"]          # prompts of 1 and 2 tokens (BOS; BOS + one byte)
# A served request's first decode step (bf16, in a batch of 16 slots) against
# the teacher-forced forward (another batch): through zamba2's 81 layers two
# correct bf16 computations part by up to 0.203 (the same forward alone and
# in a batch of two: 0.155, tools/recurrent_drift.py), while the pad tokens
# of a bucket-padded prefill move the step by 2.9 (xlstm) to 6.9 (zamba2)
# (this phase on an NVIDIA H100 80GB HBM3 at 700.00 W).  The limit sits
# between them; the sharp check is the same step in f32 activations at the
# whole depth, to GEN_F32_LOGPROB_TOL (measured 2e-5 to 4e-5 there).
REC_FIRST_STEP_BF16_TOL = 0.5
WHISPER_REQUESTS, WHISPER_NEW = 8, 16
# the f32 agreement's cut: whisper 2 + 2 layers; zamba2 one group (6 Mamba2
# layers and one application of the shared block: 2 layers hold no attention)
REC_F32_CUT = {WHISPER: ({"enc_layers": 2, "dec_layers": 2},
                         dict(num_layers=2, encoder_layers=2)),
               ZAMBA: ({"mamba_layers": 6}, dict(num_layers=6))}


def rec_config(name: str):
    """The config at its published size, on the kernel path."""
    cfg = get_config(name)
    return cfg if cfg.family == "ssm" else cfg.with_(attn_impl="auto")


def rec_launches(cfg) -> tuple[int, int]:
    """(flash_attention launches of one forward, decode_attention launches
    of one decode step) on the kernel path: whisper-small 12 encoder + 12
    decoder layers and 12 (its cross attention launches none), zamba2-7b
    the shared block's 81 // 6 = 13 applications twice, xlstm none."""
    if cfg.family == "audio":
        return cfg.encoder_layers + cfg.num_layers, cfg.num_layers
    if cfg.family == "hybrid":
        return (cfg.num_layers // cfg.attn_every,) * 2
    return 0, 0


def frames(cfg, n: int, seed: int, dtype=torch.bfloat16) -> torch.Tensor:
    """``n`` stub audio-frame embeddings [n, num_audio_frames, d] on the card."""
    return drawn((n, cfg.num_audio_frames, cfg.d_model), seed, dtype)


def rec_engine(name: str, seed: int, *, max_slots: int, max_seq: int) -> InferenceEngine:
    cfg = rec_config(name)
    t0 = time.perf_counter()
    engine = InferenceEngine(cfg, seed=seed, max_slots=max_slots, max_seq=max_seq)
    torch.cuda.synchronize()
    leaves = list(flatten(engine.runner.params).values())
    cache = flatten(engine.runner.cache).values()
    log(f"{name} ({cfg.family}): {cfg.num_layers} layers, d {cfg.d_model}, heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads}, hd {cfg.hd}, ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, attn_impl {cfg.attn_impl}, {cfg.dtype}: "
        f"{sum(t.numel() for t in leaves)} params "
        f"({sum(t.numel() * t.element_size() for t in leaves) / 1e9:.2f} GB) drawn on the card "
        f"in {time.perf_counter() - t0:.2f} s; {max_slots} slots x {max_seq} positions, "
        f"cache {sum(t.numel() * t.element_size() for t in cache) / 2**30:.2f} GiB")
    return engine


@contextlib.contextmanager
def first_decodes(runner):
    """[(request, logits [V])] of each request's first decode step, as the
    runner gave them in the run (the slots of RecordedScheduler.current)."""
    got, decode = [], runner.decode

    def recording(tokens, lens):
        fresh = [(i, r) for i, r in enumerate(RecordedScheduler.current.slot_req)
                 if r is not None and len(r.out_tokens) == 1]
        out = decode(tokens, lens)
        got.extend((r, out[i].copy()) for i, r in fresh)
        return out

    runner.decode = recording
    try:
        yield got
    finally:
        runner.decode = decode


@torch.inference_mode()
def first_step_agreement(engine, first: list) -> dict:
    """Each request's first decode logits, after the runner's true-length
    prefill, against the teacher-forced forward over its prompt and first
    token (one right-padded batch: the model is causal), to
    REC_FIRST_STEP_BF16_TOL.  The control: the same prompts prefilled at
    their bucket, as the reference's runner pads them, and stepped with the
    same token, must land beyond that limit (the pad tokens enter the
    state)."""
    cfg, params = engine.cfg, engine.runner.params
    seqs = [np.append(r.tokens, r.out_tokens[0]) for r, _ in first]
    toks = np.zeros((len(seqs), max(len(q) for q in seqs)), np.int64)
    for i, q in enumerate(seqs):
        toks[i, :len(q)] = q
    logits, _ = registry.forward(cfg, params, torch.from_numpy(toks).cuda())
    last = torch.tensor([len(q) - 1 for q in seqs], device="cuda")
    want = torch.log_softmax(logits[torch.arange(len(seqs), device="cuda"), last], dim=-1)
    del logits
    got = torch.log_softmax(torch.from_numpy(np.stack([lg for _, lg in first])).cuda(), -1)
    padded = []
    for i, (r, _) in enumerate(first):
        prompt = torch.from_numpy(np.asarray(r.tokens, np.int64))[None].cuda()
        fed = torch.tensor([[r.out_tokens[0]] * 2], device="cuda")
        bucket = min(runner_mod._bucket(len(r.tokens)), engine.runner.max_seq)
        lp, _ = forced_decode(cfg, params, prompt, fed, steps=2, bucket=bucket)
        padded.append(float((lp[0, 1] - want[i]).abs().max()))
    out = {"requests": len(first), "true_length": float((got - want).abs().max()),
           "bucket_padded": max(padded)}
    log(f"{cfg.name}: first decode step of {len(first)} requests (prompts of "
        f"{sorted(len(r.tokens) for r, _ in first)} tokens) against the teacher-forced "
        f"forward over prompt + token, max abs log-prob distance: true-length prefill "
        f"{out['true_length']:.4g} (limit {REC_FIRST_STEP_BF16_TOL}); the control, each "
        f"prompt prefilled at its bucket, {out['bucket_padded']:.4g} (must exceed the "
        f"limit; per request {[round(p, 3) for p in padded]})")
    assert out["true_length"] <= REC_FIRST_STEP_BF16_TOL < out["bucket_padded"], out
    return out


@torch.inference_mode()
def first_step_f32(engine, seed: int) -> dict:
    """The runner's true-length prefill and first decode step at the whole
    depth in f32 activations (the same bf16 weights), one slot: prompts of
    1, 2 and two oracle prompts' tokens, each stepped with its greedy
    token, against the teacher-forced forward over prompt + token, to
    GEN_F32_LOGPROB_TOL; the bucket-padded control must land beyond it."""
    cfg = engine.cfg.with_(dtype="float32")
    params = engine.runner.params
    runner = ModelRunner(cfg, params, max_slots=1, max_seq=engine.runner.max_seq)
    prompts = [TOKENIZER.encode(p) for p in REC_SHORT + oracle_prompts(2, seed)]
    true_len, padded = [], []
    for p in prompts:
        tok = int(np.argmax(runner.prefill_into_slot(np.asarray(p, np.int32), 0)))
        step = runner.decode(np.asarray([tok], np.int32), np.asarray([len(p)], np.int32))[0]
        seq = torch.tensor([p + [tok]], device="cuda")
        want = torch.log_softmax(registry.forward(cfg, params, seq)[0][0, -1], -1)
        got = torch.log_softmax(torch.from_numpy(step).cuda(), -1)
        true_len.append(float((got - want).abs().max()))
        lp, _ = forced_decode(cfg, params, seq[:, :-1], torch.tensor([[tok, tok]], device="cuda"),
                              steps=2, bucket=min(runner_mod._bucket(len(p)), runner.max_seq))
        padded.append(float((lp[0, 1] - want).abs().max()))
    out = {"true_length": max(true_len), "bucket_padded": min(padded)}
    log(f"{cfg.name}, f32 activations, {cfg.num_layers} layers: first decode step after the "
        f"runner's true-length prefill of {[len(p) for p in prompts]} tokens against the "
        f"teacher-forced forward, max abs log-prob distance {[f'{d:.3g}' for d in true_len]} "
        f"(limit {GEN_F32_LOGPROB_TOL}); bucket-padded {[f'{d:.3g}' for d in padded]} (each "
        f"must exceed it)")
    assert out["true_length"] <= GEN_F32_LOGPROB_TOL < out["bucket_padded"], out
    del runner
    free_card()
    return out


@torch.inference_mode()
def launch_counts(engine, prompt: torch.Tensor, extra=None) -> dict:
    """One forward and one decode step on the kernel path, counted against
    rec_launches."""
    cfg, params = engine.cfg, engine.runner.params
    zero_launches()
    registry.forward(cfg, params, prompt, extra=extra)
    fwd = kernel_launches()
    cache = registry.init_cache(cfg, prompt.shape[0], prompt.shape[1] + 1,
                                device=prompt.device)
    registry.prefill(cfg, params, prompt, cache, extra=extra, last_only=True)
    zero_launches()
    registry.decode_step(cfg, params, prompt[:, -1:], cache, prompt.shape[1])
    step = kernel_launches()
    n_fwd, n_step = rec_launches(cfg)
    zeros = {n: 0 for n, _, _ in _KERNELS}
    assert fwd == {**zeros, "flash_attention": n_fwd}, (cfg.name, fwd)
    assert step == {**zeros, "decode_attention": n_step}, (cfg.name, step)
    log(f"{cfg.name}: one forward [{prompt.shape[0]}, {prompt.shape[1]}] launches "
        f"flash_attention {n_fwd} times, one decode step decode_attention {n_step} times, "
        f"nothing else")
    return {"forward": n_fwd, "decode_step": n_step}


def rec_agreement(engine, prompt: torch.Tensor, extra=None, extra32=None) -> dict:
    """The kernel path (attn_impl="auto") against the config's own plain path
    ("chunked"), teacher-forced along the kernel path's greedy tokens over
    FAMILY_POSITIONS positions, with a second correct plain path ("full")
    beside it: bf16 at the whole depth to FAMILY_BF16_LOGPROB_TOL, f32 at
    REC_F32_CUT to GEN_F32_LOGPROB_TOL."""
    cfg, params = engine.cfg, engine.runner.params
    steps = FAMILY_POSITIONS

    def paths(cfg, params, extra) -> dict:
        n_fwd, n_step = rec_launches(cfg)
        n0 = (kfa.launches, kda.launches)
        lp = {}
        lp["kernel"], toks = forced_decode(cfg, params, prompt, steps=steps, extra=extra)
        n1 = (kfa.launches, kda.launches)
        assert (n1[0] - n0[0], n1[1] - n0[1]) == (n_fwd, n_step * (steps - 1)), (cfg.name, n1)
        for path in ("chunked", "full"):
            lp[path], _ = forced_decode(cfg.with_(attn_impl=path), params, prompt, toks,
                                        steps=steps, extra=extra)
        assert (kfa.launches, kda.launches) == n1, "a plain path launched a kernel"
        assert all(bool(torch.isfinite(v).all()) for v in lp.values()), cfg.name
        return {p: float((lp[p] - lp["chunked"]).abs().max()) for p in ("kernel", "full")}

    out = {"bf16": paths(cfg, params, extra)}
    log(f"{cfg.name} agreement, bf16, {cfg.num_layers} layers, {prompt.shape[0]} sequences of "
        f"{prompt.shape[1]} tokens x {steps} positions, max abs log-prob distance from the "
        f"config's own chunked path (limit {FAMILY_BF16_LOGPROB_TOL}): {out['bf16']}")
    assert max(out["bf16"].values()) <= FAMILY_BF16_LOGPROB_TOL, out
    depth, kw = REC_F32_CUT[cfg.name]
    out["f32"] = paths(cfg.with_(dtype="float32", **kw), cut_depth(params, depth), extra32)
    log(f"{cfg.name} agreement, f32, cut to {kw} (limit {GEN_F32_LOGPROB_TOL}): {out['f32']}")
    assert max(out["f32"].values()) <= GEN_F32_LOGPROB_TOL, out
    free_card()
    return out


def recurrent_oracle_run(name: str, args) -> dict:
    """xlstm-125m or zamba2-7b as the oracle of EngineModel: predicate over
    REC_PREDICATES prompts; sem_map over REC_RECORDS records and a generate
    call over REC_SHORT (REC_NEW new tokens, REC_SLOTS slots), counted;
    each request's first decode step against the teacher-forced forward,
    with the bucket-padded control; zamba2's kernel path against its plain
    path."""
    t_start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    engine = rec_engine(name, args.seed, max_slots=REC_SLOTS, max_seq=1024)
    cfg, runner = engine.cfg, engine.runner
    model = EngineModel(engine, max_new_tokens=REC_NEW)
    engine.generate(["warm-up: cuBLAS and the kernels load"], max_new_tokens=2)
    prompts = oracle_prompts(REC_PREDICATES, args.seed + 30)
    records = [{"claim": p} for p in oracle_prompts(REC_RECORDS, args.seed + 31, 40, 480)]
    n_fwd, n_step = rec_launches(cfg)
    with recorded_runs() as runs, timed_steps(runner) as (prefills, decodes), \
            first_decodes(runner) as first:
        zero_launches()
        t0 = time.perf_counter()
        passes, scores = model.predicate(prompts)
        pred_s = time.perf_counter() - t0
        n_pred = kernel_launches()
        t0 = time.perf_counter()
        notes, _ = sem_map(records, "a short note on {claim}", model)
        short = model.generate(REC_SHORT)
        run_s = time.perf_counter() - t0
        launches = kernel_launches()
        n_prefill, n_decode, n_gen = check_runs(runs, [REC_RECORDS, len(REC_SHORT)])
    assert passes.shape == (REC_PREDICATES,) and np.isfinite(scores).all()
    assert len(notes) == REC_RECORDS and len(short) == len(REC_SHORT)
    lengths = sorted(len(r.tokens) for _, done in runs for r in done)
    assert lengths[:2] == [1, 2], lengths
    assert n_pred["flash_attention"] == n_fwd and n_pred["decode_attention"] == 0, n_pred
    assert launches["flash_attention"] == n_fwd * (1 + n_prefill), launches
    assert launches["decode_attention"] == n_step * n_decode, (launches, n_decode)
    log(f"{name}: predicate over {REC_PREDICATES} prompts {pred_s * 1e3:.1f} ms (one forward, "
        f"{int(passes.sum())} pass); sem_map over {REC_RECORDS} records and {len(REC_SHORT)} "
        f"short prompts ({n_prefill} prefills at true lengths {lengths}, {n_decode} decode "
        f"steps), launches {launches}")
    out = family_timings(name, runner, prefills, decodes, n_gen, run_s, args.seed)
    out["launches"] = launches
    out["first_step"] = first_step_agreement(engine, first)
    out["first_step_f32"] = first_step_f32(engine, args.seed + 39)
    prompt = agreement_prompts(args.seed + 32)
    if n_fwd:
        out["launch_counts"] = launch_counts(engine, prompt)
        out["agreement"] = rec_agreement(engine, prompt)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["wall_s"] = time.perf_counter() - t_start
    log(f"{name}: peak memory {out['peak_gib']:.2f} GiB; wall {out['wall_s']:.1f} s")
    del engine, runner, model, first
    free_card()
    return out


def whisper_run(args) -> dict:
    """whisper-small through the scheduler: WHISPER_REQUESTS requests, each
    with its own extra["audio_frames"] [1, 1500, 768], WHISPER_NEW new
    tokens each, counted; one prompt with two recordings gives two first
    logits; the kernel path against its plain path."""
    t_start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    engine = rec_engine(WHISPER, args.seed, max_slots=WHISPER_REQUESTS, max_seq=1024)
    cfg, runner = engine.cfg, engine.runner
    audio = frames(cfg, WHISPER_REQUESTS, args.seed + 33)
    prompts = [np.asarray(TOKENIZER.encode(p), np.int32)
               for p in oracle_prompts(WHISPER_REQUESTS, args.seed + 34)]
    runner.prefill_into_slot(prompts[0][:16], 0, {"audio_frames": audio[:1]})   # warm-up
    n_fwd, n_step = rec_launches(cfg)
    with recorded_runs() as runs, timed_steps(runner) as (prefills, decodes):
        zero_launches()
        sched = RecordedScheduler(runner, sampler=engine.sampler)
        for i, p in enumerate(prompts):
            sched.submit(Request(rid=i, tokens=p, max_new_tokens=WHISPER_NEW,
                                 stop_id=TOKENIZER.eos_id,
                                 extra={"audio_frames": audio[i:i + 1]}))
        t0 = time.perf_counter()
        sched.run_to_completion()
        run_s = time.perf_counter() - t0
        launches = kernel_launches()
        n_prefill, n_decode, n_gen = check_runs(runs, [WHISPER_REQUESTS])
    assert launches["flash_attention"] == n_fwd * n_prefill, launches
    assert launches["decode_attention"] == n_step * n_decode, (launches, n_decode)
    a = runner.prefill_into_slot(prompts[0], 0, {"audio_frames": audio[:1]})
    b = runner.prefill_into_slot(prompts[0], 0, {"audio_frames": audio[1:2]})
    d_audio = float(np.abs(a - b).max())
    log(f"{WHISPER}: {WHISPER_REQUESTS} requests x {WHISPER_NEW} new tokens, one recording "
        f"each: {n_prefill} prefills, {n_decode} decode steps, launches {launches}; one "
        f"prompt, two recordings: first logits {d_audio:.4g} apart")
    assert d_audio > 1e-3, d_audio
    out = family_timings(WHISPER, runner, prefills, decodes, n_gen, run_s, args.seed)
    out["launches"] = launches
    prompt = agreement_prompts(args.seed + 35)
    b_ = prompt.shape[0]
    out["launch_counts"] = launch_counts(engine, prompt, {"audio_frames": audio[:b_]})
    out["agreement"] = rec_agreement(
        engine, prompt, {"audio_frames": audio[:b_]},
        {"audio_frames": frames(cfg, b_, args.seed + 33, torch.float32)})
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["wall_s"] = time.perf_counter() - t_start
    log(f"{WHISPER}: peak memory {out['peak_gib']:.2f} GiB; wall {out['wall_s']:.1f} s")
    del engine, runner, audio
    free_card()
    return out


def rec_kernel_rows(args, bw, bf16) -> None:
    """Both attention kernels at the shapes these families give them, bf16,
    against their plain versions (ATTN_TOL) and timed beside SDPA by
    profiler device time (printed only: the kernels line keeps the
    oracle's shapes): zamba2's prefill (hd 112, which the kernels zero-pad
    to 128) and decode step, whisper's encoder (non-causal, 1500 frames) and
    decode step."""
    g = torch.Generator(device="cuda").manual_seed(args.seed + 36)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b16 = torch.bfloat16
    z, w = get_config(ZAMBA), get_config(WHISPER)

    def rnd(*shape):
        return torch.randn(shape, device="cuda", generator=g).to(b16)

    for label, (b, s, h, hd), causal in (
            (f"{ZAMBA} prefill", (8, 512, z.num_heads, z.hd), True),
            (f"{WHISPER} encoder", (8, w.num_audio_frames, w.num_heads, w.hd), False)):
        q, k, v = rnd(b, s, h, hd), rnd(b, s, h, hd), rnd(b, s, h, hd)
        e = close_err(kfa.flash_attention(q, k, v, causal=causal),
                      ref.flash_attention_ref(q, k, v, causal=causal), ATTN_TOL[b16])
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ms, lib, ratios, clock = interleaved_ms(lambda: kfa.flash_attention(q, k, v, causal=causal),
                                         lambda: sdpa(qt, kt, vt, is_causal=causal), 10)
        flops, nbytes = kfa.cost(b, s, s, h, h, hd, causal=causal)
        bms, by = roofline.bound(nbytes, flops, hbm_bw=bw, peak=bf16)
        log(f"flash_attention {label} q/k/v[{b},{s},{h},{hd}] bf16 causal={causal}: max abs "
            f"err {e:.3g} (tol {ATTN_TOL[b16]} + rel); device time (profiler) kernel "
            f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, {bms / ms:.3f} of the {by} bound "
            f"{bms:.4f} ms), SDPA {lib:.4f} ms; median kernel / SDPA "
            f"{statistics.median(ratios):.3f}")
        del q, k, v, qt, kt, vt
    for label, (b, s, h, hd) in ((f"{ZAMBA} decode", (REC_SLOTS, 1024, z.num_heads, z.hd)),
                                 (f"{WHISPER} decode", (WHISPER_REQUESTS, 1024, w.num_heads,
                                                        w.hd))):
        q, k, v = rnd(b, 1, h, hd), rnd(b, s, h, hd), rnd(b, s, h, hd)
        lens = torch.randint(0, 600, (b,), device="cuda", generator=g, dtype=torch.int32)
        e = close_err(kda.decode_attention(q, k, v, lens),
                      ref.decode_attention_ref(q, k, v, lens), ATTN_TOL[b16])
        mask = (torch.arange(s, device="cuda")[None, :] <= lens[:, None])[:, None, None, :]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ms, lib, ratios, clock = interleaved_ms(lambda: kda.decode_attention(q, k, v, lens),
                                         lambda: sdpa(qt, kt, vt, attn_mask=mask), 20)
        rows = int((lens + 1).sum())
        flops, nbytes = kda.cost(b, s, h, h, hd, lens)
        bms, by = roofline.bound(nbytes, flops, hbm_bw=bw, peak=bf16)
        log(f"decode_attention {label} q[{b},1,{h},{hd}] k/v[{b},{s},{h},{hd}] bf16, {rows} "
            f"attended rows: max abs err {e:.3g}; device time (profiler) kernel {ms:.4f} ms "
            f"({nbytes / ms / 1e6:.0f} GB/s, {bms / ms:.3f} of the {by} bound {bms:.4f} ms), "
            f"SDPA (bool mask) {lib:.4f} ms; median kernel / SDPA "
            f"{statistics.median(ratios):.3f}")
        del q, k, v, qt, kt, vt
    free_card()


def small_recurrent_cuda_vs_cpu(seed: int) -> None:
    """The three smoke configs of phase 18 on the kernel path through
    small_cuda_vs_cpu: prompts of 1, 2 and three random lengths (whisper's
    each with its own frames), the kernels launched as rec_launches
    says."""
    for name in (WHISPER, XLSTM, ZAMBA):
        cfg = get_smoke(name)
        cfg = cfg if cfg.family == "ssm" else cfg.with_(attn_impl="auto")
        rng = np.random.default_rng(seed + 37)
        toks = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
                for n in [1, 2] + rng.integers(3, 30, 3).tolist()]
        audio = frames(cfg, 5, seed + 38, torch.float32) if cfg.family == "audio" else None
        small_cuda_vs_cpu(
            cfg, seed, toks, rec_launches(cfg),
            extra=lambda i: None if audio is None else {"audio_frames": audio[i:i + 1]})


def recurrent_phase(args, smi: str, bw, bf16) -> dict:
    """Phase 18: the encoder-decoder, recurrent and hybrid families at full
    width, one at a time, each freed before the next."""
    free_card()
    small_recurrent_cuda_vs_cpu(args.seed)
    rec_kernel_rows(args, bw, bf16)
    out = {}
    for name, run in ((XLSTM, functools.partial(recurrent_oracle_run, XLSTM)),
                      (ZAMBA, functools.partial(recurrent_oracle_run, ZAMBA)),
                      (WHISPER, whisper_run)):
        out[name] = run(args)
        free_card()
        log(f"{name} on {smi}: {json.dumps(out[name])}")
    return out


# ---------------------------------------------------------------------------
# Phase 19: training at full width, through the attention kernel pair
# ---------------------------------------------------------------------------

TRAIN = "llama3.2-3b"
# The loop of the run: batch 4 x 512 tokens, two microbatches of 2 (so each
# attention call is q [2,512,24,128], k/v [2,512,8,128]), 3 steps, the default
# OptimizerConfig (f32 master weights and moments), remat on (the config's).
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 4, 512, 2, 3
TRAIN_REDUCED_LAYERS = 2   # compress_grads and checkpoint/resume: 2 of 28 layers
TRAIN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "train_smoke")
# The backward kernel against its plain version (autograd through the
# contract), by the largest |got - want| / (1 + |want|): f32 within 1e-4 (five
# products in another order: 5.5e-6 read on the H100); bf16 within
# BWD_BF16_TOL, set between the kernel's reading (0.0143 over the cases, and
# 0.0135 for a second correct backward written out in f32: the plain version
# rounds dP and each q-head's dK/dV to bf16) and two gross faults of the
# backward (D omitted 9.3; the GQA group sum dropped 4.2), which must land
# beyond it.
BWD_F32_TOL = 1e-4
BWD_BF16_TOL = 5e-2
# The first step's kernel path against the plain path (attn_impl="full") on
# the card, same weights and batch: the loss, the global gradient norm
# (relative) and each of wq/wk/wv's gradients (largest |diff| over the plain
# path's largest |value|).  Two correct bf16 paths part by rounding through
# 28 layers: on the H100 at seed 0 the kernel path read 0.00124, 4.5e-5 and
# 0.0070 and a second correct plain path ("chunked") 0.00081, 3.1e-5 and
# 0.0059, while a kernel path whose attention output is detached (no
# gradient reaches wq/wk/wv) read 0.87 in the norm and 1.0 in the gradients
# and must land beyond the limits.
TRAIN_LOSS_TOL = 0.01
TRAIN_GNORM_TOL = 1e-3
TRAIN_GRAD_TOL = 0.03
# The reduced-depth run resumed from its step-2 checkpoint against the same
# steps run straight: the last step's loss (the embedding's backward on the
# card sums with atomics, so two runs may part in the last bits; on the H100
# they have read the same loss).
RESUME_TOL = 1e-3


def bwd_err(got, want) -> float:
    """The smallest tol for which every element is within tol + tol * |want|."""
    g, w = got.float(), want.float()
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
    assert bool(torch.isfinite(g).all()), "non-finite gradient"
    return float(((g - w).abs() / (1 + w.abs())).max())


def manual_bwd(q, k, v, dout, *, causal: bool, window: int, no_d: bool = False,
               no_group_sum: bool = False):
    """The attention gradient written out in f32 (a second correct backward),
    or with one gross fault: D = rowsum(dO * O) left out of dS, or each
    kv-head's dK/dV taken from the first q-head of its group alone."""
    b, sq, h, hd = q.shape
    sk, hk = k.shape[1], k.shape[2]
    grp = h // hk
    kr, vr = (t.repeat_interleave(grp, dim=2).float() for t in (k, v))
    qf, gf = q.float(), dout.float()
    scale = ref.attn_scale(hd)
    pos_q, pos_k = torch.arange(sq, device=q.device), torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = pos_q[:, None] >= pos_k[None, :]
    if window:
        mask = mask & (pos_q[:, None] - pos_k[None, :] < window)
    s = torch.einsum("bqhd,bshd->bhqs", qf, kr) * scale
    p = torch.softmax(torch.where(mask, s, ref.NEG_INF), dim=-1)
    pv = p.to(v.dtype).float()
    o = torch.einsum("bhqs,bshd->bqhd", pv, vr)
    dp = torch.einsum("bqhd,bshd->bhqs", gf, vr)
    d = 0.0 if no_d else (gf * o).sum(-1).transpose(1, 2)[..., None]
    ds = torch.where(mask, p * (dp - d), 0.0)
    dq = torch.einsum("bhqs,bshd->bqhd", ds, kr) * scale
    dk = (torch.einsum("bhqs,bqhd->bshd", ds, qf) * scale).view(b, sk, hk, grp, hd)
    dv = torch.einsum("bhqs,bqhd->bshd", pv, gf).view(b, sk, hk, grp, hd)
    dk, dv = (t[:, :, :, 0] if no_group_sum else t.sum(3) for t in (dk, dv))
    return tuple(t.to(q.dtype) for t in (dq, dk, dv))


def attention_bwd_phase(args, bw, fp32, bf16) -> dict:
    """The flash_attention backward kernel against its plain version at the
    training shape and at ragged edges, bit-stable, beside two gross faults;
    timed beside SDPA's backward and the bound."""
    g = torch.Generator(device="cuda").manual_seed(args.seed + 40)
    cfg = get_config(TRAIN)
    mb = TRAIN_BATCH // TRAIN_MICRO
    H, HK, HD = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    f32, b16 = torch.float32, torch.bfloat16
    tol = {f32: BWD_F32_TOL, b16: BWD_BF16_TOL}

    def inputs(b, sq, sk, h, hk, hd, dt):
        return (torch.randn(b, sq, h, hd, device="cuda", generator=g).to(dt),
                torch.randn(b, sk, hk, hd, device="cuda", generator=g).to(dt),
                torch.randn(b, sk, hk, hd, device="cuda", generator=g).to(dt),
                torch.randn(b, sq, h, hd, device="cuda", generator=g).to(dt))

    worst, worst_abs = {f32: 0.0, b16: 0.0}, 0.0
    for shape, dt, causal, window in [
            ((mb, TRAIN_SEQ, TRAIN_SEQ, H, HK, HD), b16, True, 0),   # the training shape
            ((mb, TRAIN_SEQ, TRAIN_SEQ, H, HK, HD), f32, True, 0),
            ((2, 129, 191, H, HK, HD), b16, True, 0),     # Sq, Sk no multiple of 64
            ((2, 191, 129, H, HK, HD), f32, True, 0),
            ((2, 300, 300, H, HK, HD), b16, True, 64),    # sliding window
            ((2, 256, 100, 8, 2, HD), b16, True, 32),     # rows no key may see
            ((2, 256, 100, 8, 2, HD), f32, False, 32),
            ((2, 200, 200, 8, 1, 100), b16, True, 0),     # H/Hk 8, hd 100
            ((2, 200, 200, 8, 1, 100), f32, False, 0),
            ((3, 77, 77, 8, 4, 64), b16, False, 0),       # hd 64, odd S, no mask
            ((2, 200, 200, 16, 1, 64), b16, True, 0),     # H/Hk 16: two q-heads a block
            ((3, 77, 77, 8, 4, 64), f32, True, 16),
            ("misaligned", b16, True, 0), ("misaligned", f32, True, 8)]:
        if shape == "misaligned":
            shape = (2, 96, 96, 4, 2, HD)
            q, k, v, dout = (misaligned(s_, dt, g) for s_ in
                             ((2, 96, 4, HD), (2, 96, 2, HD), (2, 96, 2, HD), (2, 96, 4, HD)))
        else:
            q, k, v, dout = inputs(*shape, dt)
        out, st = kfa.flash_attention(q, k, v, causal=causal, window=window,
                                      return_stats=True)
        got = kfa.flash_attention_bwd(q, k, v, out, dout, causal=causal, window=window,
                                      stats=st)
        again = kfa.flash_attention_bwd(q, k, v, out, dout, causal=causal, window=window,
                                        stats=st)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again)), "two calls differ"
        want = ref.flash_attention_bwd_ref(q, k, v, out, dout, causal=causal, window=window)
        errs = [bwd_err(a, b) for a, b in zip(got, want)]
        log(f"flash_attention backward [b,sq,sk,h,hk,hd]={list(shape)} {dt} causal={causal} "
            f"window={window}{' misaligned' if q.data_ptr() % 16 else ''}: dq/dk/dv "
            f"|diff|/(1+|plain|) {errs[0]:.3g}/{errs[1]:.3g}/{errs[2]:.3g} (limit {tol[dt]}); "
            f"two calls identical")
        assert max(errs) <= tol[dt], (shape, dt, errs)
        worst[dt] = max(worst[dt], max(errs))
        if dt == b16:
            worst_abs = max([worst_abs] + [float((a.float() - b.float()).abs().max())
                                           for a, b in zip(got, want)])

    # the limit against a second correct backward and two gross faults, at the
    # training shape in bf16
    shape = (mb, TRAIN_SEQ, TRAIN_SEQ, H, HK, HD)
    q, k, v, dout = inputs(*shape, b16)
    out, st = kfa.flash_attention(q, k, v, causal=True, return_stats=True)
    m, l_ = ref.flash_attention_stats_ref(q, k, v, causal=True)
    m_err = float(((st[0] - m).abs() / (1 + m.abs())).max())
    l_err = float(((st[1] - l_) / l_).abs().max())
    log(f"flash_attention bf16 forward's saved statistics at the training shape against "
        f"flash_attention_stats_ref: m |diff|/(1+|plain|) {m_err:.3g}, l relative {l_err:.3g} "
        f"(limits 1e-5, 1e-4)")
    assert m_err <= 1e-5 and l_err <= 1e-4, (m_err, l_err)
    got = kfa.flash_attention_bwd(q, k, v, out, dout, causal=True, stats=st)
    want = ref.flash_attention_bwd_ref(q, k, v, out, dout, causal=True)
    rows = {"kernel": got, "f32 written out (correct)": manual_bwd(q, k, v, dout, causal=True,
                                                                  window=0)}
    faults = {"D omitted": manual_bwd(q, k, v, dout, causal=True, window=0, no_d=True),
              "GQA group sum dropped": manual_bwd(q, k, v, dout, causal=True, window=0,
                                                  no_group_sum=True)}
    for name, grads in {**rows, **faults}.items():
        e = max(bwd_err(a, b) for a, b in zip(grads, want))
        log(f"flash_attention backward bf16 training shape, {name}: max |diff|/(1+|plain|) "
            f"{e:.4g} (limit {BWD_BF16_TOL})")
        assert (e > BWD_BF16_TOL) == (name in faults), (name, e)

    # timing: the kernel in turns with SDPA's backward (one autograd call
    # over SDPA's graph, GQA), the plain version, the bound
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                                enable_gqa=True)
    dout_t = dout.transpose(1, 2)
    ms, lib, ratios, clock = interleaved_ms(
        lambda: kfa.flash_attention_bwd(q, k, v, out, dout, causal=True, stats=st),
        lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dout_t, retain_graph=True), 10)
    plain, pclock = plain_ms(
        lambda: ref.flash_attention_bwd_ref(q, k, v, out, dout, causal=True), 3)
    ev = cuda_ms(lambda: kfa.flash_attention_bwd(q, k, v, out, dout, causal=True, stats=st), 10)
    # the call's kernels one by one, and the tensor cores in the SASS of each
    # bf16 kernel that computes a product
    _, recs = profiled(lambda: kfa.flash_attention_bwd(q, k, v, out, dout, causal=True,
                                                       stats=st))
    split = {n: sum(e.self_device_time_total for e in recs if n in e.key) / 1e3
             for n in kfa.BWD_KERNEL_NAMES[b16]}
    log("flash_attention backward bf16, its kernels in one call (profiler): "
        + ", ".join(f"{n} {t:.4f} ms" for n, t in split.items()))
    hgmma = {n: tensor_core_ops(n, "flash_attention_bwd", ("HGMMA",))
             for n in kfa.BWD_KERNEL_NAMES[b16]}
    log(f"flash_attention backward bf16 SASS (cuobjdump -sass): HGMMA per instance {hgmma}")
    assert all(c and all(n > 0 for n in c.values()) for c in hgmma.values()), \
        f"no HGMMA in a bf16 backward kernel: {hgmma}"
    # S, dP, dV, dK, dQ over the unmasked pairs; q, k, v, out, dout in, dq, dk, dv out
    flops, nbytes = kfa.backward_cost(mb, TRAIN_SEQ, TRAIN_SEQ, H, HK, HD, causal=True,
                                      itemsize=q.element_size())
    bms, by = roofline.bound(nbytes, flops, hbm_bw=bw, peak=bf16)
    log(f"flash_attention backward: largest |diff|/(1+|plain|) over the cases f32 "
        f"{worst[f32]:.3g}, bf16 {worst[b16]:.3g}; largest bf16 |diff| {worst_abs:.3g}")
    log(f"flash_attention backward q[{mb},{TRAIN_SEQ},{H},{HD}] k/v[{mb},{TRAIN_SEQ},{HK},{HD}] "
        f"bf16 causal, device time (profiler): kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
        f"TFLOP/s, {bms / ms:.3f} of the {by} bound {bms:.4f} ms), plain {plain:.4f} ms "
        f"({pclock}), SDPA backward {lib:.4f} ms; median kernel / SDPA "
        f"{statistics.median(ratios):.3f} (each round: "
        + ", ".join(f"{r:.3f}" for r in ratios) + f"); kernel by CUDA events {ev:.4f} ms")
    del q, k, v, dout, out, st, got, want, rows, faults, qt, kt, vt, sdpa_out
    free_card()
    return {"flash_attention_bwd": dict(
        max_abs_err=worst_abs, ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms,
        bound_by=by, nbytes=nbytes, flops=flops, clock=clock, plain_clock=pclock,
        shape=f"q[{mb},{TRAIN_SEQ},{H},{HD}] k/v[{mb},{TRAIN_SEQ},{HK},{HD}] bf16 causal")}


def train_batch(seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The loop's first batch (step 0 of SyntheticSource(seed)) on the card."""
    b = packed_batch(SyntheticSource(seed=seed), 0, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                     seed=seed)
    return torch.from_numpy(b["tokens"]).cuda(), torch.from_numpy(b["labels"]).cuda()


@contextlib.contextmanager
def detached_attention():
    """The kernel path with its attention output detached: no gradient
    reaches wq/wk/wv (the control that the gradient check must catch)."""
    saved = ops.flash_attention

    def detached(*a, **kw):
        return saved(*a, **kw).detach()

    ops.flash_attention = detached
    try:
        yield
    finally:
        ops.flash_attention = saved


def profiled_train_step(cfg, ocfg, seed: int) -> dict:
    """One train step (make_train_step, the loop's own step) after one
    warm-up step, under the profiler: wall, device busy, idle share and the
    busy time by kernel family."""
    params = registry.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed))
    state = opt.init_state(params, ocfg)
    step = trainstep.make_train_step(cfg, ocfg, microbatches=TRAIN_MICRO)
    toks, labels = train_batch(seed)
    batch = {"tokens": toks, "labels": labels}
    step(params, state, batch)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    del params, state, step
    free_card()
    # the raw device records, as device_busy reads them (no event tree)
    cuda = torch.autograd.DeviceType.CUDA
    recs = [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda]
    if not recs:   # deep into the run the profiler can keep no record at all
        log(f"{TRAIN} one train step: wall {wall:.1f} ms; the profiler kept no device record, "
            f"so busy time, idle share and the kernel families are not measured")
        return {"wall_ms": wall, "busy_ms": None}
    busy = union_ns(np.array([r[1:] for r in recs], np.int64)) / 1e6
    by_name: dict[str, list] = {}
    for name, a, b in recs:
        by_name.setdefault(name, []).append((b - a) / 1e6)
    fam = {"flash_attention backward": ("flash_attention_bwd",),
           "flash_attention forward": (kfa.KERNEL_NAMES[torch.bfloat16],),
           "GEMMs": ("nvjet", "gemm", "xmma", "cutlass")}
    out = {k: sum(sum(v) for n, v in by_name.items() if any(w in n.lower() for w in words))
           for k, words in fam.items()}
    out["rest"] = busy - sum(out.values())
    log(f"{TRAIN} one train step [{TRAIN_BATCH}, {TRAIN_SEQ}] under the profiler: wall "
        f"{wall:.1f} ms, device busy {busy:.1f} ms (the union of {len(recs)} device records), "
        f"idle share {1 - busy / wall:.4f}; "
        + ", ".join(f"{k} {v:.1f} ms ({v / busy:.4f})" for k, v in out.items()))
    top = sorted(((sum(v), n, len(v)) for n, v in by_name.items()), reverse=True)[:14]
    log("train step top device records: "
        + "; ".join(f"{n[:50]} x{c} {ms:.2f} ms" for ms, n, c in top))
    return {"wall_ms": wall, "busy_ms": busy, "idle": 1 - busy / wall, **out}


def watched(params) -> dict:
    """Host copies of a few whole leaves: layer 0's wq and the embedding's
    first 1024 rows (the byte tokens' among them)."""
    return {"wq[0]": params["layers"]["attn"]["wq"][0].cpu().clone(),
            "embedding[:1024]": params["embed"]["embedding"][:1024].cpu().clone()}


def train_first_step(cfg, seed: int) -> dict:
    """One step's loss, global gradient norm and wq/wk/wv gradients through
    the kernel pair against the plain path on the card, same weights and
    batch; each launch count checked."""
    params = registry.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed))
    toks, labels = train_batch(seed)
    out, grads = {}, {}
    paths = [("kernel", cfg), ("full", cfg.with_(attn_impl="full")),
             ("chunked", cfg.with_(attn_impl="chunked", attn_q_chunk=128)),
             ("kernel, output detached", cfg)]
    for name, c in paths:
        zero_launches()
        ctx = detached_attention() if "detached" in name else contextlib.nullcontext()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ctx:
            loss, metrics, g = trainstep.grads_and_loss(c, params, toks, labels,
                                                        microbatches=TRAIN_MICRO)
            gnorm = opt.global_norm(g)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = kernel_launches()
        want = (2 * 2 * cfg.num_layers, 2 * cfg.num_layers) if name == "kernel" else \
            (2 * 2 * cfg.num_layers, 0) if "detached" in name else (0, 0)
        assert (n["flash_attention"], n["flash_attention_bwd"]) == want, (name, n)
        out[name] = {"loss": float(loss), "grad_norm": float(gnorm), "wall_s": wall,
                     "launches": [n["flash_attention"], n["flash_attention_bwd"]]}
        grads[name] = {w: g["layers"]["attn"][w].clone() for w in ("wq", "wk", "wv")}
        del g
        free_card()
    plain = out["full"]
    for name in ("kernel", "chunked", "kernel, output detached"):
        r = out[name]
        r["d_loss"] = abs(r["loss"] - plain["loss"])
        r["d_grad_norm"] = abs(r["grad_norm"] - plain["grad_norm"]) / plain["grad_norm"]
        r["d_grads"] = {w: float((grads[name][w] - grads["full"][w]).abs().max()
                                 / grads["full"][w].abs().max()) for w in grads[name]}
        log(f"{TRAIN} first step, {name} against the plain path (full): loss {r['loss']:.6f} "
            f"(plain {plain['loss']:.6f}, |diff| {r['d_loss']:.3g}, limit {TRAIN_LOSS_TOL}), "
            f"grad_norm {r['grad_norm']:.5g} (rel diff {r['d_grad_norm']:.3g}, limit "
            f"{TRAIN_GNORM_TOL}), wq/wk/wv max |diff| / max |plain| "
            + "/".join(f"{v:.3g}" for v in r["d_grads"].values())
            + f" (limit {TRAIN_GRAD_TOL}); launches fwd/bwd {r['launches']}; "
            f"{r['wall_s']:.2f} s")
    for name in ("kernel", "chunked"):
        r = out[name]
        assert r["d_loss"] <= TRAIN_LOSS_TOL and r["d_grad_norm"] <= TRAIN_GNORM_TOL, r
        assert max(r["d_grads"].values()) <= TRAIN_GRAD_TOL, r
    ctl = out["kernel, output detached"]
    assert max(ctl["d_grads"].values()) > TRAIN_GRAD_TOL and \
        ctl["d_grad_norm"] > TRAIN_GNORM_TOL, "the detached control passed the checks"
    head = watched(params)
    del params, grads
    free_card()
    return {"paths": out, "head": head}


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


class SaveRecorder:
    """A saver for ``loop.run`` that writes nothing: it records the steps it
    was asked to save and checks a few of the params it was handed (the
    full-width checkpoint is 45 GB, so the phase writes checkpoints at reduced
    depth only)."""

    def __init__(self, check=None):
        self.steps, self.check = [], check

    def save(self, step, trees, extra_meta=None):
        self.steps.append(step)
        if self.check:
            self.check(trees)

    def wait(self):
        pass


class KeptCheckpointer(ckpt.AsyncCheckpointer):
    """``AsyncCheckpointer`` that also keeps a host copy of what it saved
    last, to hold the loop's restore against."""

    def save(self, step, trees, extra_meta=None):
        super().save(step, trees, extra_meta)
        self.kept = {n: {p: v.detach().cpu().clone() for p, v in flatten(t).items()}
                     for n, t in trees.items()}


@contextlib.contextmanager
def checked_restore(kept: dict, restored: list):
    """The loop's own checkpoint load (``ckpt.load``, which ``loop.run``
    calls to resume), each restored tensor held bit for bit against the host
    snapshot ``kept`` that was saved; (step, load seconds) go to
    ``restored``."""
    real = ckpt.load

    def load(ckpt_dir, step=None):
        t0 = time.perf_counter()
        n, trees = real(ckpt_dir, step)
        restored.append((n, time.perf_counter() - t0))
        for name, flat in kept.items():
            back = flatten(trees[name])
            assert sorted(back) == sorted(flat), name
            assert all(same_bits(back[p], t) for p, t in flat.items()), name
        return n, trees

    ckpt.load = load
    try:
        yield
    finally:
        ckpt.load = real


def timed_run(cfg, ocfg, loop, saver) -> tuple[dict, list]:
    """``loop.run`` with a log line every step: (final metrics, the wall
    seconds of each step, read at each log line, which waits for the
    step's metrics)."""
    stamps = [time.perf_counter()]

    def logged(line):
        stamps.append(time.perf_counter())
        log(f"  {line}")

    m = train_loop.run(cfg, ocfg, loop, log=logged, saver=saver)
    return m, [b - a for a, b in zip(stamps, stamps[1:])]


def reduced_runs(cfg, ocfg, seed: int) -> dict:
    """At TRAIN_REDUCED_LAYERS layers: compress_grads, and a run checkpointed
    at step 2 and resumed to step 3 against the same 3 steps straight."""
    cfg = cfg.with_(num_layers=TRAIN_REDUCED_LAYERS)
    base = dict(steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                microbatches=TRAIN_MICRO, log_every=1, seed=seed, keep=1)
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    out = {}
    plain, _ = timed_run(cfg, ocfg, train_loop.LoopConfig(
        ckpt_dir=os.path.join(TRAIN_DIR, "straight"), ckpt_every=10**9, **base), SaveRecorder())
    comp, _ = timed_run(cfg, ocfg, train_loop.LoopConfig(
        ckpt_dir=os.path.join(TRAIN_DIR, "compress"), ckpt_every=10**9, compress_grads=True,
        **base), SaveRecorder())
    assert np.isfinite(comp["loss"]) and np.isfinite(comp["grad_norm"]), comp
    log(f"{TRAIN} at {cfg.num_layers} layers, {TRAIN_STEPS} steps: loss {plain['loss']:.6f} "
        f"grad_norm {plain['grad_norm']:.5g}; with compress_grads (int8, error feedback): loss "
        f"{comp['loss']:.6f} grad_norm {comp['grad_norm']:.5g}")
    d = os.path.join(TRAIN_DIR, "resume")
    saver = KeptCheckpointer(d, keep=1)
    t0 = time.perf_counter()
    timed_run(cfg, ocfg, train_loop.LoopConfig(ckpt_dir=d, ckpt_every=2,
                                               **{**base, "steps": 2}), saver)
    saved_s = time.perf_counter() - t0
    step_dir = os.path.join(d, f"step_{2:08d}")
    nbytes = sum(os.path.getsize(os.path.join(step_dir, f)) for f in os.listdir(step_dir))
    restored = []
    with checked_restore(saver.kept, restored):
        resumed, _ = timed_run(cfg, ocfg, train_loop.LoopConfig(ckpt_dir=d, ckpt_every=10**9,
                                                                **base), SaveRecorder())
    assert [n for n, _ in restored] == [2], restored
    del saver
    d_loss = abs(resumed["loss"] - plain["loss"])
    log(f"{TRAIN} at {cfg.num_layers} layers: 2 steps and the checkpoint of step 2 "
        f"({nbytes / 2**30:.2f} GiB) in {saved_s:.1f} s; the loop's restore loaded it in "
        f"{restored[0][1]:.1f} s, every tensor bit for bit as saved; resumed to step {resumed['last_step']}: loss "
        f"{resumed['loss']:.6f} against {plain['loss']:.6f} straight (|diff| {d_loss:.3g}, "
        f"limit {RESUME_TOL}: the embedding's backward on the card sums with atomics)")
    assert resumed["last_step"] == TRAIN_STEPS and d_loss <= RESUME_TOL, (resumed, plain)
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    out.update(straight=plain, compress=comp, resumed=resumed, ckpt_gib=nbytes / 2**30)
    return out


def train_phase(args, smi: str) -> dict:
    """Phase 19: llama3.2-3b at full width trains TRAIN_STEPS steps through
    ``loop.run`` on the card, its attention through the kernel pair."""
    free_card()
    cfg = get_config(TRAIN)
    assert cfg.remat and cfg.attn_impl == "auto"
    ocfg = opt.OptimizerConfig()
    res = train_first_step(cfg, args.seed)
    head = res.pop("head")
    lap("19 first step against the plain path")
    res["profile"] = profiled_train_step(cfg, ocfg, args.seed)
    lap("19 profiled step")

    def changed(trees):
        """How many of the watched bf16 weights the steps changed, and how
        far their f32 master copies moved."""
        now = watched(trees["params"])
        master = {"wq[0]": trees["opt_state"]["master"]["layers"]["attn"]["wq"][0],
                  "embedding[:1024]": trees["opt_state"]["master"]["embed"]["embedding"][:1024]}
        res["changed"] = {k: int((now[k] != head[k]).sum()) for k in now}
        res["master_moved"] = {k: float((master[k].cpu() - head[k].float()).abs().max())
                               for k in master}

    loop = train_loop.LoopConfig(steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                                 microbatches=TRAIN_MICRO, log_every=1, seed=args.seed,
                                 ckpt_dir=os.path.join(TRAIN_DIR, "full"),
                                 ckpt_every=10**9)
    saver = SaveRecorder(changed)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    m, step_s = timed_run(cfg, ocfg, loop, saver)
    launches = kernel_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    assert launches["flash_attention"] == TRAIN_STEPS * 2 * TRAIN_MICRO * cfg.num_layers, launches
    assert launches["flash_attention_bwd"] == TRAIN_STEPS * TRAIN_MICRO * cfg.num_layers, launches
    assert saver.steps == [TRAIN_STEPS], saver.steps
    assert np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]), m
    assert all(v > 0 for v in res["changed"].values()), res["changed"]
    assert all(v > 0 for v in res["master_moved"].values()), res["master_moved"]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steady = statistics.median(step_s[1:])
    res.update(loss=m["loss"], grad_norm=m["grad_norm"], step_s=step_s, peak_gib=peak,
               tokens_per_s=tokens / steady, launches={k: launches[k] for k in
                                                       ("flash_attention", "flash_attention_bwd")})
    log(f"{TRAIN} on {smi}: {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens "
        f"({TRAIN_MICRO} microbatches, remat, f32 master and moments): step wall "
        + ", ".join(f"{s:.3f}" for s in step_s) + f" s (the first includes warm-up), "
        f"{tokens / steady:.0f} tokens/s at the median of the later steps, peak memory "
        f"{peak:.2f} GiB; loss {m['loss']:.5f}, grad_norm {m['grad_norm']:.4g}; bf16 weights "
        f"changed {res['changed']}, their f32 master copies moved up to {res['master_moved']}; "
        f"launches {res['launches']}")
    free_card()
    lap("19 loop.run at full width")
    res["reduced"] = reduced_runs(cfg, ocfg, args.seed)
    free_card()
    return res


# ---------------------------------------------------------------------------
# Phase 20: the distribution layer, four ranks on the one card
# ---------------------------------------------------------------------------

DIST_RANKS = 4            # processes on the one card; gloo carries their CUDA tensors
DIST_DEVICE = "cuda"
DIST_TIMEOUT = 300        # s for the whole world (and each collective)
DIST_ARCH = "llama3.2-3b"
DIST_VOCAB = 384          # the vocabulary cut of phase 8
DIST_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "dist_smoke")
# (a) context-parallel decode: the cache's 16,384 positions, 4,096 a rank
CP_BATCH, CP_SEQ, CP_STEPS = 4, 16384, 8
CP_LENS = (4095, 4096, 9000, 16000)    # on and across the shard edges
CP_F32_LAYERS = 4
CP_F32_TOL = 1e-4
# (b) one MoE layer of mixtral-8x22b.  bf16: within MOE_BF16_TOL of the
# output's largest entry; a wrong shard offset (each rank holding its
# neighbour's experts) must land beyond it.  f32: MOE_F32_TOL of the largest
# entry, the aux losses within MOE_F32_TOL.
MOE_ARCH, MOE_ROWS = "mixtral-8x22b", (4, 512)
MOE_BF16_TOL, MOE_F32_TOL = 1e-2, 1e-5
# (c) the pipeline: 28 layers over 4 stages of 7
PP_TOKENS, PP_MICRO, PP_F32_LAYERS = (8, 512), 4, 8
PP_F32_TOL, PP_LOSS_TOL, PP_GRAD_TOL = 1e-4, 1e-3, 1e-2
# bf16 at the whole depth: both the pipeline's and the control's gradients
# against those of f32 copies of the same bf16 params (f32 activations)
PP_BF16_GRAD_TOL = 2e-2
# (d) the sharded train step (the reference test's bounds); (e) restore
TS_LAYERS, TS_STEPS, TS_BATCH = 4, 2, (4, 512)
TS_LOSS_TOL, TS_PARAM_TOL, TS_GNORM_TOL = 1e-3, 5e-3, 1e-4   # the last relative
RS_LAYERS = 2
# (a') and (d'): the (2, 1, 2) ("pod", "data", "model") mesh, whose "default"
# rules cut every layer stack over pod.  (a') the decode cache [L, 4, 4096,
# 8, 128] over pod, data (1) and model: 2,048 positions a rank, lens on and
# across the sequence shards' edge
POD_MESH = ((2, 1, 2), ("pod", "data", "model"))
CP_POD_SEQ, CP_POD_STEPS = 4096, 4
CP_POD_LENS = (2045, 2047, 100, 4000)


def dist_gen(seed: int) -> torch.Generator:
    return torch.Generator(device=DIST_DEVICE).manual_seed(seed)


def cp_cache(cfg, sh, seed: int, local: bool, seq: int = CP_SEQ) -> dict:
    """The decode cache's K and V, drawn layer by layer on the card from the
    seed: each rank's shard as ``DTensor``s (``local``; the layers of its
    layer shard where the spec cuts the stack's layers) or the whole."""
    shape = (cfg.num_layers, CP_BATCH, seq, cfg.num_kv_heads, cfg.hd)
    mine = sh.local_slices(shape)
    layers = range(cfg.num_layers)[mine[0]] if local else range(cfg.num_layers)
    out = {}
    for j, name in enumerate(("k", "v")):
        t = torch.empty(sh.shard_shape(shape) if local else shape, dtype=cfg.activation_dtype,
                        device=DIST_DEVICE)
        for slot, layer in enumerate(layers):
            full = torch.randn(shape[1:], generator=dist_gen(seed * 1000 + 2 * layer + j),
                               device=DIST_DEVICE, dtype=cfg.activation_dtype)
            t[slot] = full[mine[1:]] if local else full
        out[name] = sh.dtensor(t, shape) if local else t
    return {"self": out}


@torch.no_grad()
def cp_steps(cfg, params, cache, seed: int, rows=slice(None), lens=CP_LENS,
             steps: int = CP_STEPS) -> tuple[torch.Tensor, float]:
    """``steps`` ``registry.decode_step``s from ``lens`` of the batch
    ``rows``: (log-probs [b, steps, V] f32, wall s a step)."""
    toks = torch.randint(0, cfg.vocab_size, (steps, CP_BATCH, 1),
                         generator=dist_gen(seed + 7), device=DIST_DEVICE)[:, rows]
    lens = torch.tensor(lens, dtype=torch.int32, device=DIST_DEVICE)[rows]
    out = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        logits, cache = registry.decode_step(cfg, params, toks[i], cache, lens + i)
        out.append(torch.log_softmax(logits.float(), dim=-1))
    torch.cuda.synchronize()
    return torch.cat(out, dim=1), (time.perf_counter() - t0) / steps


def cp_rank(params, rank: int, seed: int) -> dict:
    """(a) context-parallel decode of llama3.2-3b over a (1, 4) mesh, the
    cache's sequence over ``model``; rank 0 runs the same steps on the whole
    cache through ``decode_attention`` as the control."""
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh((1, DIST_RANKS), ("data", "model"))
    base = get_config(DIST_ARCH).with_(vocab_size=DIST_VOCAB, decode_cp=True)
    res = {}
    for dt, cfg, p in (("bf16", base, params),
                       ("f32", base.with_(num_layers=CP_F32_LAYERS, dtype="float32"),
                        cut_depth(params, {"layers": CP_F32_LAYERS}))):
        shape = (cfg.num_layers, CP_BATCH, CP_SEQ, cfg.num_kv_heads, cfg.hd)
        spec = shd.resolve_pspec(shape, ("layers", "batch", "kv_seq", "kv_heads", "qkv"), mesh,
                                 "serve_replicated")
        sh = shd.NamedSharding(mesh, spec)
        cache = cp_cache(cfg, sh, seed, local=True)
        zero_launches()
        with shd.activation_rules(mesh, "serve_replicated"):
            got, step_s = cp_steps(cfg, p, cache, seed)
        launches = kernel_launches()
        k, v = (cache["self"][n].to_local() for n in ("k", "v"))
        layer0 = shd.NamedSharding(mesh, shd.P(*spec[1:]))
        k0, v0 = layer0.gather(k[0]), layer0.gather(v[0])
        r = {"spec": str(spec), "local_layer_shape": list(k.shape[1:]),
             "local_cache_gib": 2 * k.numel() * k.element_size() / 2**30,
             "step_ms": step_s * 1e3, "decode_attention": launches["decode_attention"],
             "flash_attention": launches["flash_attention"]}
        del cache, k, v
        if rank == 0:
            whole = cp_cache(cfg, sh, seed, local=False)
            zero_launches()
            want, wstep = cp_steps(cfg, p, whole, seed)     # no rules: the ordinary path
            r.update(control_step_ms=wstep * 1e3,
                     control_decode_attention=kernel_launches()["decode_attention"],
                     logprob_err=float((got - want).abs().max()),
                     layer0_bits_equal=same_bits(k0, whole["self"]["k"][0])
                     and same_bits(v0, whole["self"]["v"][0]))
            del whole
        res[dt] = r
        free_card()
        tdist.barrier()
    return res


def cp_pod_rank(params, rank: int, seed: int) -> dict:
    """(a') context-parallel decode of llama3.2-3b over the (2, 1, 2) pod
    mesh under the "default" rules: the cache stacks cut over pod (half the
    layers a pod), data and model (the sequence), while the attention's
    layer spec cuts the batch over (pod, data), so each layer's rows move
    from the owner pod and each new token back.  Rank 0 runs the same steps
    in one process on the whole cache as the control; after the steps each
    stack's first and last layer (one on each pod) are gathered back and
    held to the control's: bit for bit where nothing was written."""
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh(*POD_MESH)
    base = get_config(DIST_ARCH).with_(vocab_size=DIST_VOCAB, decode_cp=True)
    res = {}
    for dt, cfg, p in (("bf16", base, params),
                       ("f32", base.with_(num_layers=CP_F32_LAYERS, dtype="float32"),
                        cut_depth(params, {"layers": CP_F32_LAYERS}))):
        shape = (cfg.num_layers, CP_BATCH, CP_POD_SEQ, cfg.num_kv_heads, cfg.hd)
        spec = shd.resolve_pspec(shape, ("layers", "batch", "kv_seq", "kv_heads", "qkv"), mesh,
                                 "default")
        sh = shd.NamedSharding(mesh, spec)
        rows_sh = shd.NamedSharding(mesh, shd.resolve_pspec((CP_BATCH, 1), ("batch", None),
                                                            mesh, "default"))
        rows = rows_sh.local_slices((CP_BATCH, 1))[0]
        cache = cp_cache(cfg, sh, seed, local=True, seq=CP_POD_SEQ)
        zero_launches()
        with shd.activation_rules(mesh, "default"):
            got, step_s = cp_steps(cfg, p, cache, seed, rows, CP_POD_LENS, CP_POD_STEPS)
        launches = kernel_launches()
        got = shd.NamedSharding(mesh, shd.P(rows_sh.spec[0], None, None)).gather(got)
        layer_sh = shd.NamedSharding(mesh, shd.P(*spec[1:]))
        per = cfg.num_layers // shd.mesh_sizes(mesh)["pod"]
        ends = {}
        for layer in (0, cfg.num_layers - 1):
            at = {"pod": layer // per}
            ends[layer] = [layer_sh.gather(cache["self"][n].to_local()[layer % per], at=at)
                           for n in ("k", "v")]
        k = cache["self"]["k"].to_local()
        r = {"spec": str(spec), "attention_rows": [rows.start, rows.stop],
             "local_stack_shape": list(k.shape),
             "local_cache_gib": 2 * k.numel() * k.element_size() / 2**30,
             "step_ms": step_s * 1e3, "decode_attention": launches["decode_attention"],
             "flash_attention": launches["flash_attention"]}
        del cache, k
        if rank == 0:
            whole = cp_cache(cfg, sh, seed, local=False, seq=CP_POD_SEQ)
            zero_launches()
            want, wstep = cp_steps(cfg, p, whole, seed, lens=CP_POD_LENS, steps=CP_POD_STEPS)
            written = torch.zeros(CP_BATCH, CP_POD_SEQ, dtype=torch.bool, device=DIST_DEVICE)
            for i in range(CP_POD_STEPS):
                written[torch.arange(CP_BATCH, device=DIST_DEVICE),
                        torch.tensor(CP_POD_LENS, device=DIST_DEVICE) + i] = True
            same, werr = True, 0.0
            for layer, kv in ends.items():
                for t, n in zip(kv, ("k", "v")):
                    w = whole["self"][n][layer]
                    same = same and same_bits(t[~written], w[~written])
                    werr = max(werr, float((t[written].float() - w[written].float()).abs().max()))
            r.update(control_step_ms=wstep * 1e3,
                     control_decode_attention=kernel_launches()["decode_attention"],
                     logprob_err=float((got - want).abs().max()),
                     unwritten_bits_equal=same, written_err=werr)
            del whole
        res[dt] = r
        del ends
        free_card()
        tdist.barrier()
    return res


def expert_params(cfg, experts, seed: int) -> dict:
    """One MoE layer's router and the listed experts' weights, each expert
    drawn on the card from its own seed at the stack's fan-in scale (the
    whole layer on rank 0, two experts on each rank)."""
    specs = moe_mod.moe_spec(cfg)
    out = {"router": specs[("router",)].materialize(dist_gen(seed))}
    for j, name in enumerate(("w_gate", "w_up", "w_down")):
        s = specs[(name,)]
        scale = 1.0 / math.sqrt(math.prod(s.shape[:-1]))
        out[name] = torch.stack([
            (torch.randn(s.shape[1:], generator=dist_gen(seed * 100 + 3 * e + j + 1),
                         device=DIST_DEVICE) * scale).to(s.dtype) for e in experts])
    return out


@torch.no_grad()
def moe_rank(rank: int, seed: int) -> dict:
    """(b) one mixtral-8x22b MoE layer, expert parallel over (1, 4): two
    experts a rank, against ``moe_ffn`` on rank 0."""
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_test_mesh
    cfg = get_config(MOE_ARCH)
    mesh = make_test_mesh((1, DIST_RANKS), ("data", "model"))
    per = cfg.num_experts // DIST_RANKS
    mine = expert_params(cfg, range(rank * per, (rank + 1) * per), seed)
    nxt = (rank + 1) % DIST_RANKS
    wrong = expert_params(cfg, range(nxt * per, (nxt + 1) * per), seed)
    x = torch.randn(*MOE_ROWS, cfg.d_model, generator=dist_gen(seed + 3), device=DIST_DEVICE)
    res = {"local_expert_gib": sum(mine[k].numel() * mine[k].element_size()
                                   for k in ("w_gate", "w_up", "w_down")) / 2**30}
    ids = moe_mod.route(mine, x.to(cfg.activation_dtype), cfg=cfg)[3]
    ids0 = ids.clone()
    tdist.broadcast(ids0, src=0)
    flips = torch.tensor(float((ids != ids0).sum()), device=DIST_DEVICE)
    tdist.all_reduce(flips)
    res["route_flips_across_ranks"] = float(flips)
    out = {}
    for dt in ("bf16", "f32"):
        xd = x.to(torch.bfloat16 if dt == "bf16" else torch.float32)
        c = cfg.with_(dtype="bfloat16" if dt == "bf16" else "float32")
        with shd.activation_rules(mesh, "default"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y, aux = moe_mod.moe_ffn(mine, xd, cfg=c)
            torch.cuda.synchronize()
            out[dt] = (y, aux, time.perf_counter() - t0)
            if dt == "bf16":
                yw, _ = moe_mod.moe_ffn(wrong, xd, cfg=c)
    del mine, wrong
    free_card()
    if rank == 0:
        whole = expert_params(cfg, range(cfg.num_experts), seed)
        res["control_ids_equal"] = bool(torch.equal(
            moe_mod.route(whole, x.to(cfg.activation_dtype), cfg=cfg)[3], ids))
        for dt, (y, aux, wall) in out.items():
            xd = x.to(torch.bfloat16 if dt == "bf16" else torch.float32)
            c = cfg.with_(dtype="bfloat16" if dt == "bf16" else "float32")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            yc, auxc = moe_mod.moe_ffn(whole, xd, cfg=c)
            torch.cuda.synchronize()
            scale = float(yc.float().abs().max())
            res[dt] = {"rel_err": float((y.float() - yc.float()).abs().max()) / scale,
                       "lb_err": float((aux["moe_lb"] - auxc["moe_lb"]).abs()),
                       "z_err": float((aux["moe_z"] - auxc["moe_z"]).abs()),
                       "ms": wall * 1e3, "control_ms": (time.perf_counter() - t0) * 1e3}
            if dt == "bf16":
                res[dt]["wrong_offset_rel_err"] = float((yw.float() - yc.float()).abs().max()) \
                    / scale
        del whole
    tdist.barrier()
    return res


def stage_rows(params: dict, rows: slice) -> dict:
    """``params`` with the layer stack cut to ``rows`` (views)."""
    def cut(tree):
        return {k: cut(v) if isinstance(v, dict) else v[rows] for k, v in tree.items()}
    return {**params, "layers": cut(params["layers"])}


def rel_errs(got: dict, want: dict, per: int, shift: int = 0) -> dict:
    """{leaf[stage s]: max |got - want| / max |want|}: ``got`` holds each
    stage's gradients (stage s's layer slice under its stage), ``want``
    the whole; ``shift`` holds stage s against stage s + shift's slice (a
    wrong-stage control: layer leaves only)."""
    out = {}
    for (path, s), g in got.items():
        if path[0] != "layers" and shift:
            continue
        w = want[path]
        if path[0] == "layers":
            t = (s + shift) % DIST_RANKS
            w = w[t * per:(t + 1) * per]
        w = w.float()
        out["/".join(path) + (f"[stage {s}]" if path[0] == "layers" else "")] = float(
            (g.float() - w).abs().max()) / max(float(w.abs().max()), 1e-30)
    return out


def whole_grads(cfg, params, tokens, labels, cast) -> tuple[float, dict]:
    """``loss_fn`` and its gradients on one rank, of the leaves ``cast``
    from the params."""
    full = {k: cast(v).requires_grad_() for k, v in flatten(params).items()}
    wl, _ = trainstep.loss_fn(cfg, unflatten(full), tokens, labels)
    wg = dict(zip(full, torch.autograd.grad(wl, list(full.values()))))
    return wl.item(), wg


def pp_grads(cfg, mesh, params, rows, tokens, labels, rank: int, pairs: list,
             cast, f32_witness: bool = False) -> dict:
    """``make_pp_loss`` and its gradients on this rank's stage (leaves
    ``cast`` from the params), each stage's layer gradients sent to rank 0,
    which holds them and the others against ``loss_fn``'s on the whole
    params: {loss, control_loss, grad_rel_err, worst leaf} on rank 0.
    ``f32_witness``: rank 0 also holds both (the pipeline's and the
    control's) against the gradients of f32 copies of the same params in
    f32 activations, and the pipeline's stage s against stage s + 1's f32
    slice (a wrong-stage control)."""
    from repro_torch.dist.pipeline_parallel import make_pp_loss
    leaves = {k: cast(v).requires_grad_() for k, v in flatten(stage_rows(params, rows)).items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = make_pp_loss(cfg, mesh, n_micro=PP_MICRO)(unflatten(leaves), tokens, labels)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    torch.cuda.synchronize()
    res = {"loss": loss.item(), "loss_and_grads_ms": (time.perf_counter() - t0) * 1e3}
    del leaves, loss
    per = rows.stop - rows.start
    if rank > 0:
        for path in sorted(grads):
            if path[0] == "layers":
                tdist.broadcast(grads[path].contiguous(), src=rank, group=pairs[rank - 1])
        return res
    got = {}
    for s in range(DIST_RANKS):
        for path in sorted(grads):
            if path[0] != "layers" and s > 0:
                continue
            g = grads[path]
            if s > 0:
                g = torch.empty_like(g)
                tdist.broadcast(g, src=s, group=pairs[s - 1])
            got[(path, s)] = g
    del grads
    if f32_witness:       # first, while the card holds the least
        c32 = cfg.with_(dtype="float32")
        _, w32 = whole_grads(c32, params, tokens, labels, lambda t: t.detach().float())
        free_card()
    res["control_loss"], wg = whole_grads(cfg, params, tokens, labels, cast)
    worst = rel_errs(got, wg, per)
    res["grad_rel_err"] = max(worst.values())
    res["grad_worst_leaf"] = max(worst, key=worst.get)
    if f32_witness:
        ctl = rel_errs({(p, 0): g for p, g in wg.items()}, w32, cfg.num_layers)
        for name, errs in (("pp_vs_f32", rel_errs(got, w32, per)), ("control_vs_f32", ctl),
                           ("wrong_stage_vs_f32", rel_errs(got, w32, per, shift=1))):
            res[name] = max(errs.values())
            res[name + "_worst"] = max(errs, key=errs.get)
            res[name + "_embedding"] = errs.get("embed/embedding")
    return res


def pp_rank(params, rank: int, seed: int) -> dict:
    """(c) llama3.2-3b's 28 layers as 4 pipeline stages of 7: the logits,
    the loss and each stage's gradients against the single-device forward
    and ``loss_fn`` on rank 0.  The gradients twice: of f32 copies of the
    params in f32 activations at PP_F32_LAYERS (held to PP_GRAD_TOL: the
    same sums in another order), and of the bf16 params in bf16 at the
    whole depth, where both the pipeline's and the control's are held
    against the gradients of f32 copies of those bf16 params (PP_BF16_GRAD_TOL,
    with a wrong-stage control beyond it)."""
    from repro_torch.dist.pipeline_parallel import pp_forward
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh((DIST_RANKS,), ("pod",))
    cfg = get_config(DIST_ARCH).with_(vocab_size=DIST_VOCAB)
    g = dist_gen(seed + 11)
    tokens = torch.randint(0, cfg.vocab_size, PP_TOKENS, generator=g, device=DIST_DEVICE)
    labels = torch.randint(0, cfg.vocab_size, PP_TOKENS, generator=g, device=DIST_DEVICE)
    per = cfg.num_layers // DIST_RANKS
    rows = slice(rank * per, (rank + 1) * per)
    res = {}
    zero_launches()
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = pp_forward(cfg, mesh, stage_rows(params, rows), tokens, n_micro=PP_MICRO)
        torch.cuda.synchronize()
    res["forward_ms"] = (time.perf_counter() - t0) * 1e3
    res["flash_attention"] = kernel_launches()["flash_attention"]
    c8 = cfg.with_(num_layers=PP_F32_LAYERS, dtype="float32")
    p8 = cut_depth(params, {"layers": PP_F32_LAYERS})
    r8 = slice(rank * (PP_F32_LAYERS // DIST_RANKS), (rank + 1) * (PP_F32_LAYERS // DIST_RANKS))
    with torch.no_grad():
        logits8 = pp_forward(c8, mesh, stage_rows(p8, r8), tokens, n_micro=PP_MICRO)
    if rank == 0:
        with torch.no_grad():
            want, _ = registry.forward(cfg, params, tokens)
            want8, _ = registry.forward(c8, p8, tokens)
        res["logprob_err"] = float((torch.log_softmax(logits, -1)
                                    - torch.log_softmax(want, -1)).abs().max())
        res["f32_logprob_err"] = float((torch.log_softmax(logits8, -1)
                                        - torch.log_softmax(want8, -1)).abs().max())
        del want, want8
    del logits, logits8
    pairs = [tdist.new_group([0, s]) for s in range(1, DIST_RANKS)]
    res["grads_f32"] = pp_grads(c8, mesh, p8, r8, tokens, labels, rank, pairs,
                                lambda t: t.detach().float())
    free_card()
    res["grads_bf16"] = pp_grads(cfg, mesh, params, rows, tokens, labels, rank, pairs,
                                 lambda t: t.detach(), f32_witness=True)
    free_card()
    tdist.barrier()
    return res


def ts_batches(cfg, seed: int) -> list[dict]:
    g = dist_gen(seed + 13)
    return [{k: torch.randint(0, cfg.vocab_size, TS_BATCH, generator=g, device=DIST_DEVICE)
             for k in ("tokens", "labels")} for _ in range(TS_STEPS)]


def nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in flatten(tree).values())


def train_step_rank(rank: int, seed: int, pod: bool = False) -> dict:
    """(d) the sharded train step over (2, 2) ("data", "model") at
    llama3.2-3b's widths, 4 layers: each rank stores a quarter or so of the
    params and state; rank 0 runs the single-device step as the control of
    the trajectory (losses, params after the last step), and before each
    sharded step the single-device gradient's norm of the params the
    sharded step starts from (gathered), the control of that step's grad
    norm.  In f32 a planted fault follows: one step from the same start
    with each gradient left unsummed over "data" (the trainstep's
    ``_grad_shard`` swapped here), whose grad norm must land beyond
    TS_GNORM_TOL.  (d') with ``pod``: the same over the (2, 1, 2) pod mesh,
    where the rules cut the layer stack over pod (two layers a pod), and
    the planted fault gathers each layer from the other pod (the trainstep's
    ``_owner`` swapped)."""
    from repro_torch.dist import sharding as shd
    from repro_torch.dist import trainstep as dts
    from repro_torch.launch.mesh import make_test_mesh
    if pod:
        mesh = make_test_mesh(*POD_MESH)
        fault = ("wrong_pod", "_owner", lambda i, per: (i // per + 1) % POD_MESH[0][0])
    else:
        mesh = make_test_mesh((2, 2), ("data", "model"))
        fault = ("unsummed", "_grad_shard", lambda g, mesh, dp, slices: g.float()[slices])
    base = get_config(DIST_ARCH).with_(vocab_size=DIST_VOCAB, num_layers=TS_LAYERS)
    ocfg = opt.OptimizerConfig(total_steps=TS_STEPS, warmup_steps=0)
    res = {}
    for dt in ("float32", "bfloat16"):
        cfg = base.with_(dtype=dt)
        pspecs = registry.param_specs(cfg)
        psh = shd.spec_shardings(pspecs, mesh)
        ssh = shd.spec_shardings(opt.state_specs(pspecs, ocfg), mesh)
        params = registry.init_params(cfg, dist_gen(seed))
        state = opt.init_state(params, ocfg)

        def run(n_steps: int, r: dict):
            lp, ls = shd.place_tree(params, psh), shd.place_tree(state, ssh)
            step = dts.make_sharded_train_step(cfg, ocfg, mesh)
            r.update(grad_norms=[], same_params_grad_norms=[], step_s=[], losses=[],
                     launches=[0, 0])
            for i, batch in enumerate(ts_batches(cfg, seed)[:n_steps]):
                # the first step starts from ``params`` themselves, bit for bit
                start = shd.gather_tree(lp, psh) if i else params
                if rank == 0:
                    g = trainstep.grads_and_loss(cfg, start, batch["tokens"],
                                                 batch["labels"].long())[2]
                    r["same_params_grad_norms"].append(float(opt.global_norm(g)))
                    del g
                del start
                free_card()
                torch.cuda.synchronize()
                base_bytes = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                n0 = kernel_launches()
                t0 = time.perf_counter()
                lp, ls, m = step(lp, ls, batch)
                torch.cuda.synchronize()
                r["step_s"].append(time.perf_counter() - t0)
                n1 = kernel_launches()      # the step's own, not the control's
                r["launches"] = [a + n1[k] - n0[k] for a, k in zip(
                    r["launches"], ("flash_attention", "flash_attention_bwd"))]
                r["step_peak_gib"] = max(r.get("step_peak_gib", 0.0), (
                    torch.cuda.max_memory_allocated() - base_bytes) / 2**30)
                r["losses"].append(float(m["loss"]))
                r["grad_norms"].append(float(m["grad_norm"]))
            if rank == 0:
                r["grad_norm_rel_err"] = max(abs(a - b) / b for a, b in zip(
                    r["grad_norms"], r["same_params_grad_norms"]))
            return lp, ls

        r = {}
        lp, ls = run(TS_STEPS, r)
        r.update(local_param_share=nbytes(lp) / nbytes(params),
                 local_state_share=nbytes(ls) / nbytes(state))
        got = shd.gather_tree(lp, psh)
        del lp, ls
        if dt == "float32":
            key, attr, planted = fault
            real = getattr(dts, attr)
            setattr(dts, attr, planted)
            try:
                r[key] = {}
                run(1, r[key])
            finally:
                setattr(dts, attr, real)
        if rank == 0:
            ref_step = trainstep.make_train_step(cfg, ocfg)
            wl = []
            for batch in ts_batches(cfg, seed):
                params, state, m = ref_step(params, state, batch)
                wl.append(float(m["loss"]))
            r["control_losses"] = wl
            r["loss_err"] = max(abs(a - b) for a, b in zip(r["losses"], wl))
            fg, fw = flatten(got), flatten(params)
            r["param_err"] = max(float((fg[k].float() - fw[k].float()).abs().max()) for k in fw)
        res[dt] = r
        del params, state, got
        free_card()
        tdist.barrier()
    return res


def restore_rank(rank: int, seed: int) -> dict:
    """(e) a 2-layer full-width llama3.2-3b checkpoint saved from a (4,)
    "data" mesh and restored on (2, 2): each rank's shards against the saved
    arrays' slices, bit for bit."""
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_test_mesh
    cfg = get_config(DIST_ARCH).with_(num_layers=RS_LAYERS)
    pspecs = registry.param_specs(cfg)
    d = os.path.join(DIST_DIR, "ckpt")
    m1 = make_test_mesh((DIST_RANKS,), ("data",))
    sh1 = shd.spec_shardings(pspecs, m1)
    local1 = shd.place_tree(registry.init_params(cfg, dist_gen(seed)), sh1)
    free_card()
    whole = shd.gather_tree(local1, sh1)
    res = {"saved_gib": nbytes(whole) / 2**30}
    if rank == 0:
        t0 = time.perf_counter()
        ckpt.save(d, 1, {"params": whole})
        res["save_s"] = time.perf_counter() - t0
    del whole, local1
    free_card()
    tdist.barrier()
    m2 = make_test_mesh((2, 2), ("data", "model"))
    sh2 = flatten(shd.spec_shardings(pspecs, m2))
    t0 = time.perf_counter()
    step, out = ckpt.restore_sharded(d, {"params": unflatten(sh2)})
    res["restore_s"] = time.perf_counter() - t0
    _, saved = ckpt.load(d)
    saved = flatten(saved["params"])
    got = flatten(out["params"])
    res["step"] = step
    res["bits_equal"] = all(
        same_bits(got[p].cpu(), saved[p][sh2[p].local_slices(saved[p].shape)].contiguous())
        for p in saved)
    res["local_share"] = nbytes(got) / nbytes(saved)
    tdist.barrier()
    return res


def dist_rank(rank: int, seed: int) -> None:
    """One rank of phase 20's world: a process of its own on the card."""
    import datetime
    repro_torch.set_device(DIST_DEVICE)
    tdist.init_process_group("gloo", init_method=f"file://{os.path.join(DIST_DIR, 'rdzv')}",
                            world_size=DIST_RANKS, rank=rank,
                            timeout=datetime.timedelta(seconds=DIST_TIMEOUT))
    try:
        laps = {}
        t0 = time.perf_counter()
        params = registry.init_params(get_config(DIST_ARCH).with_(vocab_size=DIST_VOCAB),
                                      dist_gen(seed))
        res = {"a": cp_rank(params, rank, seed)}
        laps["a"] = time.perf_counter() - t0
        res["a_pod"] = cp_pod_rank(params, rank, seed)
        laps["a_pod"] = time.perf_counter() - t0 - sum(laps.values())
        res["c"] = pp_rank(params, rank, seed)
        laps["c"] = time.perf_counter() - t0 - sum(laps.values())
        del params
        free_card()
        for key, fn in (("b", moe_rank), ("d", train_step_rank),
                        ("d_pod", functools.partial(train_step_rank, pod=True)),
                        ("e", restore_rank)):
            res[key] = fn(rank, seed)
            free_card()
            laps[key] = time.perf_counter() - t0 - sum(laps.values())
        res["laps_s"] = laps
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        with open(os.path.join(DIST_DIR, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    except BaseException:
        # spawn reports one rank's error; each rank's own goes to a file
        import traceback
        with open(os.path.join(DIST_DIR, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        tdist.destroy_process_group()


def launch_train_runs(smi: str) -> dict:
    """(f) ``python -m repro_torch.launch.train`` as two processes of one
    world (``--coordinator``), each against a one-process run with its
    ``--process-id`` as the data shard; all four at once."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.path.join(root, "src")}
    base = ["--smoke", "--device", DIST_DEVICE, "--steps", "2", "--batch", "2",
            "--seq-len", "32", "--num-processes", "2"]
    runs = {}
    for i in range(2):
        for kind, extra in (("world", ["--coordinator", f"127.0.0.1:{port}"]), ("alone", [])):
            argv = [*base, "--process-id", str(i), *extra,
                    "--ckpt-dir", os.path.join(DIST_DIR, f"train_{kind}{i}")]
            runs[(kind, i)] = (argv, subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.train", *argv], env=env, cwd=root,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    finals = {}
    for key, (argv, p) in runs.items():
        out, err = p.communicate(timeout=300)
        log(f"$ python -m repro_torch.launch.train {' '.join(argv)}  (exit {p.returncode})")
        assert p.returncode == 0, err[-4000:]
        finals[key] = ast.literal_eval(out.split("[train] final:")[-1].strip())
        log(f"  final {finals[key]}")
    for i in range(2):
        w, a = finals[("world", i)], finals[("alone", i)]
        assert w["last_step"] == a["last_step"] == 2, (w, a)
        for k in ("loss", "grad_norm"):
            assert abs(w[k] - a[k]) <= RESUME_TOL * abs(a[k]), (i, k, w, a)
    assert finals[("world", 0)]["loss"] != finals[("world", 1)]["loss"], finals
    log(f"launch/train --num-processes 2 on {smi}: each process's final metrics equal its "
        f"shard's one-process run")
    return {f"{k}{i}": v for (k, i), v in finals.items()}


def dist_phase(args, smi: str) -> dict:
    """Phase 20: the distribution layer across DIST_RANKS processes on the card."""
    import torch.multiprocessing as mp
    free_card()
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    os.makedirs(DIST_DIR)
    t0 = time.perf_counter()
    ctx = mp.start_processes(dist_rank, args=(args.seed,), nprocs=DIST_RANKS,
                             start_method="spawn", join=False)
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > DIST_TIMEOUT:
                raise TimeoutError(f"phase 20's world ran past {DIST_TIMEOUT} s")
    except BaseException:
        for r in range(DIST_RANKS):
            err = os.path.join(DIST_DIR, f"rank{r}.err")
            if os.path.exists(err):
                with open(err) as f:
                    log(f"rank {r}: {f.read()[-3000:]}")
        raise
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    world_s = time.perf_counter() - t0
    ranks = []
    for r in range(DIST_RANKS):
        with open(os.path.join(DIST_DIR, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    r0 = ranks[0]
    log(f"phase 20 on {smi}: {DIST_RANKS} ranks (processes) on one card, gloo carrying CUDA "
        f"tensors; the world took {world_s:.1f} s; per-rank peak memory "
        + ", ".join(f"{r['peak_gib']:.2f}" for r in ranks) + " GiB; rank 0's laps "
        + json.dumps({k: round(v, 1) for k, v in r0["laps_s"].items()}))
    cfg = get_config(DIST_ARCH)
    # (a)
    for dt, tol in (("bf16", GEN_BF16_LOGPROB_TOL), ("f32", CP_F32_TOL)):
        a = r0["a"][dt]
        layers = cfg.num_layers if dt == "bf16" else CP_F32_LAYERS
        log(f"(a) {DIST_ARCH} context-parallel decode on {smi}, {dt}, {layers} layers (vocab "
            f"cut to {DIST_VOCAB}), batch {CP_BATCH}, cache {CP_SEQ} positions, lens {CP_LENS}, "
            f"{CP_STEPS} steps: spec {a['spec']}, each rank's layer shard "
            f"{[r['a'][dt]['local_layer_shape'] for r in ranks]} "
            f"({a['local_cache_gib']:.3f} GiB of K+V), log-probs against the whole-cache "
            f"control {a['logprob_err']:.4g} (limit {tol}), layer-0 caches bit for bit "
            f"{a['layer0_bits_equal']}; a step {a['step_ms']:.2f} ms (control "
            f"{a['control_step_ms']:.2f} ms); decode_attention launches "
            f"{[r['a'][dt]['decode_attention'] for r in ranks]} (control "
            f"{a['control_decode_attention']})")
        assert a["logprob_err"] <= tol, a
        assert a["layer0_bits_equal"], a
        for r in ranks:
            ra = r["a"][dt]
            assert ra["local_layer_shape"] == [CP_BATCH, CP_SEQ // DIST_RANKS,
                                               cfg.num_kv_heads, cfg.hd], ra
            assert ra["decode_attention"] == 0 and ra["flash_attention"] == 0, ra
        assert a["control_decode_attention"] == layers * CP_STEPS, a
    # (a')
    for dt, tol in (("bf16", GEN_BF16_LOGPROB_TOL), ("f32", CP_F32_TOL)):
        a = r0["a_pod"][dt]
        layers = cfg.num_layers if dt == "bf16" else CP_F32_LAYERS
        log(f"(a') {DIST_ARCH} context-parallel decode over {POD_MESH[0]} {POD_MESH[1]} under "
            f"the default rules on {smi}, {dt}, {layers} layers (vocab cut to {DIST_VOCAB}), "
            f"batch {CP_BATCH}, cache {CP_POD_SEQ} positions, lens {CP_POD_LENS}, "
            f"{CP_POD_STEPS} steps: stack spec {a['spec']}, each rank's stack shard "
            f"{[r['a_pod'][dt]['local_stack_shape'] for r in ranks]} "
            f"({a['local_cache_gib']:.3f} GiB of K+V), attention rows "
            f"{[r['a_pod'][dt]['attention_rows'] for r in ranks]}; log-probs against the "
            f"one-process control on the whole cache {a['logprob_err']:.4g} (limit {tol}); the "
            f"first and last layers gathered back: unwritten positions bit for bit "
            f"{a['unwritten_bits_equal']}, written {a['written_err']:.4g} from the control's; "
            f"a step {[round(r['a_pod'][dt]['step_ms'], 2) for r in ranks]} ms (control "
            f"{a['control_step_ms']:.2f} ms); decode_attention launches "
            f"{[r['a_pod'][dt]['decode_attention'] for r in ranks]} (control "
            f"{a['control_decode_attention']})")
        assert a["logprob_err"] <= tol, a
        assert a["unwritten_bits_equal"] and math.isfinite(a["written_err"]), a
        per = layers // POD_MESH[0][0]
        for i, r in enumerate(ranks):
            ra = r["a_pod"][dt]
            assert ra["local_stack_shape"] == [per, CP_BATCH, CP_POD_SEQ // 2, cfg.num_kv_heads,
                                               cfg.hd], ra
            assert ra["attention_rows"] == [CP_BATCH // 2 * (i // 2),
                                            CP_BATCH // 2 * (i // 2 + 1)], ra
            assert ra["decode_attention"] == 0 and ra["flash_attention"] == 0, ra
        assert a["control_decode_attention"] == layers * CP_POD_STEPS, a
    # (b)
    b = r0["b"]
    log(f"(b) {MOE_ARCH} one MoE layer (d 6144, ff 16384, 8 experts, top-2) at x "
        f"{list(MOE_ROWS) + [6144]}, expert parallel over (1, {DIST_RANKS}) on {smi}: local "
        f"experts {[round(r['b']['local_expert_gib'], 3) for r in ranks]} GiB a rank; routes "
        f"identical to the control's {b['control_ids_equal']}, flips across ranks "
        f"{b['route_flips_across_ranks']:.0f}; bf16 {json.dumps(b['bf16'])} (limit "
        f"{MOE_BF16_TOL}); f32 {json.dumps(b['f32'])} (limit {MOE_F32_TOL})")
    assert b["control_ids_equal"] and b["route_flips_across_ranks"] == 0, b
    assert b["bf16"]["rel_err"] <= MOE_BF16_TOL < b["bf16"]["wrong_offset_rel_err"], b
    assert b["f32"]["rel_err"] <= MOE_F32_TOL, b
    assert b["f32"]["lb_err"] <= MOE_F32_TOL and b["f32"]["z_err"] <= MOE_F32_TOL, b
    # (c)
    c = r0["c"]
    per = cfg.num_layers // DIST_RANKS
    gf, gb = c["grads_f32"], c["grads_bf16"]
    log(f"(c) {DIST_ARCH} pipeline, {cfg.num_layers} layers over {DIST_RANKS} stages of {per}, "
        f"{PP_MICRO} microbatches of tokens {list(PP_TOKENS)} on {smi}: log-probs against "
        f"registry.forward {c['logprob_err']:.4g} (limit {GEN_BF16_LOGPROB_TOL}), f32 at "
        f"{PP_F32_LAYERS} layers {c['f32_logprob_err']:.3g} (limit {PP_F32_TOL}); "
        f"make_pp_loss and its gradients against loss_fn: f32 params and activations at "
        f"{PP_F32_LAYERS} layers, loss "
        f"{gf['loss']:.6f} against {gf['control_loss']:.6f}, gradients within "
        f"{gf['grad_rel_err']:.3g} of each leaf's largest entry (worst {gf['grad_worst_leaf']}, "
        f"limit {PP_GRAD_TOL}); bf16 at {cfg.num_layers} layers, loss {gb['loss']:.6f} against "
        f"{gb['control_loss']:.6f}, "
        f"gradients {gb['grad_rel_err']:.4g} from the control's (worst {gb['grad_worst_leaf']}); "
        f"against the gradients of f32 copies of the same bf16 params in f32 activations: "
        f"the pipeline's {gb['pp_vs_f32']:.4g} (worst {gb['pp_vs_f32_worst']}, embedding "
        f"{gb['pp_vs_f32_embedding']:.4g}; limit {PP_BF16_GRAD_TOL}), the control's "
        f"{gb['control_vs_f32']:.4g} (worst {gb['control_vs_f32_worst']}, embedding "
        f"{gb['control_vs_f32_embedding']:.4g}), each stage against the next stage's "
        f"{gb['wrong_stage_vs_f32']:.4g} (wrong-stage control); "
        f"flash_attention launches per rank {[r['c']['flash_attention'] for r in ranks]}; "
        f"forward {[round(r['c']['forward_ms'], 1) for r in ranks]} ms, loss and gradients "
        f"bf16 {[round(r['c']['grads_bf16']['loss_and_grads_ms'], 1) for r in ranks]} ms")
    assert c["logprob_err"] <= GEN_BF16_LOGPROB_TOL and c["f32_logprob_err"] <= PP_F32_TOL, c
    for gr in (gf, gb):
        assert abs(gr["loss"] - gr["control_loss"]) <= PP_LOSS_TOL, c
    assert gf["grad_rel_err"] <= PP_GRAD_TOL, c
    assert gb["pp_vs_f32"] <= PP_BF16_GRAD_TOL < gb["wrong_stage_vs_f32"], gb
    assert all(r["c"]["flash_attention"] == per * PP_MICRO for r in ranks), ranks
    # (d), (d')
    log(f"cut: (d) and (d') {DIST_ARCH} at {TS_LAYERS} of {cfg.num_layers} layers, vocab "
        f"{DIST_VOCAB}")
    base = cfg.with_(num_layers=TS_LAYERS)
    meshes = {"d": ("(d)", "(2, 2) (\"data\", \"model\")", "unsummed",
                    "gradients unsummed over \"data\""),
              "d_pod": ("(d')", f"{POD_MESH[0]} {POD_MESH[1]}, the layer stack over pod",
                        "wrong_pod", "each layer gathered from the other pod")}
    for key, (tag, where, fault, what) in meshes.items():
        for dt in ("float32", "bfloat16"):
            d = r0[key][dt]
            log(f"{tag} sharded train step over {where} on {smi}, {dt} "
                f"activations, {TS_STEPS} steps of {list(TS_BATCH)}: losses {d['losses']} "
                f"against the single-process step's {d['control_losses']} (err "
                f"{d['loss_err']:.3g}), params {d['param_err']:.3g} from it; shares of the "
                f"param bytes a rank holds "
                f"{[round(r[key][dt]['local_param_share'], 4) for r in ranks]}, of the state "
                f"bytes {[round(r[key][dt]['local_state_share'], 4) for r in ranks]}; grad norms "
                f"{d['grad_norms']} against the single-device gradient's of the same params "
                f"{d['same_params_grad_norms']} (relative err {d['grad_norm_rel_err']:.3g}"
                + (f", limit {TS_GNORM_TOL}; the planted fault, {what}, "
                   f"{d[fault]['grad_norms'][0]} against "
                   f"{d[fault]['same_params_grad_norms'][0]}: "
                   f"{d[fault]['grad_norm_rel_err']:.3g}" if dt == "float32" else "")
                + f"); per-rank peak memory of a step above its start "
                f"{[round(r[key][dt]['step_peak_gib'], 3) for r in ranks]} GiB; launches "
                f"[flash_attention, flash_attention_bwd] per rank "
                f"{[r[key][dt]['launches'] for r in ranks]}; step wall "
                f"{[round(s, 3) for s in d['step_s']]} s")
            want = [TS_STEPS * (1 + base.remat) * TS_LAYERS, TS_STEPS * TS_LAYERS]
            assert all(r[key][dt]["launches"] == want for r in ranks), (key, dt, want, ranks)
        d32 = r0[key]["float32"]
        assert d32["loss_err"] <= TS_LOSS_TOL and d32["param_err"] <= TS_PARAM_TOL, (key, d32)
        assert d32["grad_norm_rel_err"] <= TS_GNORM_TOL < d32[fault]["grad_norm_rel_err"], \
            (key, d32)
        assert all(0.2 <= r[key]["float32"]["local_param_share"] <= 0.3 for r in ranks), ranks
    # (e)
    e = [r["e"] for r in ranks]
    log(f"(e) restore_sharded on {smi}: a {RS_LAYERS}-layer full-width {DIST_ARCH} checkpoint "
        f"({e[0]['saved_gib']:.3f} GiB) saved from a ({DIST_RANKS},) \"data\" mesh in "
        f"{e[0]['save_s']:.2f} s, restored on (2, 2) in "
        f"{[round(x['restore_s'], 2) for x in e]} s: each rank's shards bit for bit "
        f"{[x['bits_equal'] for x in e]}, shares {[round(x['local_share'], 4) for x in e]}")
    assert all(x["bits_equal"] and x["step"] == 1 for x in e), e
    # (f)
    f = launch_train_runs(smi)
    shutil.rmtree(os.path.join(DIST_DIR, "ckpt"), ignore_errors=True)
    log(f"phase 20 on {smi}: {time.perf_counter() - t0:.1f} s")
    return {"ranks": ranks, "launch_train": f}


# ---------------------------------------------------------------------------
# Phase 21: the launch/ tooling on the card (cost counter, roofline)
# ---------------------------------------------------------------------------

# llama3.2-3b at its catalog config: phase 19's train step (4 x 512 tokens in
# 2 microbatches), one 512-token prefill, a decode step of 32 slots at 1024
# positions (the generate phase's): (cell, microbatches)
RL_CELLS = {"train": (ShapeCell("train_4x512", TRAIN_SEQ, TRAIN_BATCH, "train"), TRAIN_MICRO),
            "prefill": (ShapeCell("prefill_1x512", 512, 1, "prefill"), None),
            "decode": (ShapeCell("decode_32x1024", 1024, 32, "decode"), None)}


def outside(costs, scope: str = "attn_core") -> tuple[float, float]:
    """(FLOPs, bytes) outside ``scope`` (integers below 2^53: exact)."""
    f, b = costs.scopes.get(scope, (0.0, 0.0))
    return costs.flops - f, costs.bytes - b


def log_row_diff(meta, card, scope: str = "attn_core", n: int = 30) -> None:
    """The grouped rows outside ``scope`` where the two runs differ."""
    a = {k: v for k, v in meta.rows.items() if k[2] != scope}
    b = {k: v for k, v in card.rows.items() if k[2] != scope}
    diff = sorted(set(a) | set(b), key=lambda k: -abs((a.get(k) or [0, 0, 0])[2]
                                                      - (b.get(k) or [0, 0, 0])[2]))
    log(f"rows outside {scope} that differ ({len([k for k in diff if a.get(k) != b.get(k)])}):")
    for k in [k for k in diff if a.get(k) != b.get(k)][:n]:
        log(f"  {k}: meta {a.get(k)}, card {b.get(k)}")


def expected_charges(cfg, kind: str, cell, mb) -> dict:
    """Each kernel's [launches, FLOPs, bytes] that a step of ``kind`` must
    charge: its module's cost() at the launched shapes, times the launches
    (bf16; the train step's forward runs twice a layer and microbatch under
    remat, with the row statistics the backward reads)."""
    L, H, HK, HD = cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    S, B = cell.seq_len, cell.global_batch
    if kind == "train":
        b = B // mb
        plan = {"flash_attention": (2 * L * mb, kfa.cost(b, S, S, H, HK, HD, stats=True)),
                "flash_attention_bwd": (L * mb, kfa.backward_cost(b, S, S, H, HK, HD,
                                                                 stats=True))}
    elif kind == "prefill":
        plan = {"flash_attention": (L, kfa.cost(B, S, S, H, HK, HD))}
    else:
        plan = {"decode_attention": (L, kda.cost(B, S, H, HK, HD, [S - 1] * B))}
    return {k: [n, float(n * f), float(n * b)] for k, (n, (f, b)) in plan.items()}


def roofline_phase(args, smi: str) -> dict:
    """Phase 21: the cost counter and the roofline on three full-width
    llama3.2-3b steps (``RL_CELLS``).  (a) Each step traced on meta tensors
    (``dryrun.build_cell``, no mesh); (b) the same step on the card under
    ``CostMode`` (the kernel path): FLOPs and bytes outside ``attn_core``
    equal to the meta trace's exactly, each kernel's charges equal to its
    cost() at the launched shapes and its count to the module's launch
    counter; (c) one uncounted run under the profiler: wall, busy, idle
    share, the roofline terms at the card's datasheet peaks and the wall's
    share of the model FLOPs' time (``mfu_measured``); (d) hlo_debug's top
    20 rows of the train step; (e) the meta trace's predicted peak memory
    beside ``max_memory_allocated`` of the timed run (printed only)."""
    t0 = time.perf_counter()
    cfg = get_config(TRAIN)
    pk = roofline.peaks(torch.cuda.get_device_name(0))
    out = {}
    for kind, (cell, mb) in RL_CELLS.items():
        t1 = time.perf_counter()
        traced, _ = dryrun.build_cell(TRAIN, cell, None, microbatches=mb, cfg=cfg)
        meta = hlo_analysis.analyze(traced.fn, *traced.args, rows=True, flop_counter=True)
        del traced
        meta_s = time.perf_counter() - t1
        free_card()
        traced, _ = dryrun.build_cell(TRAIN, cell, None, microbatches=mb, cfg=cfg,
                                      device="cuda", seed=args.seed + 21)
        traced.run()                                   # warm-up, uncounted
        torch.cuda.synchronize()
        zero_launches()
        t1 = time.perf_counter()
        card = hlo_analysis.analyze(traced.fn, *traced.args, rows=True)
        torch.cuda.synchronize()
        counted_s = time.perf_counter() - t1
        launched = {n: getattr(m, a) for n, m, a in _KERNELS if getattr(m, a)}
        want = expected_charges(cfg, kind, cell, mb)
        log(f"(a, b) {TRAIN} {kind} {cell.name}: meta trace {meta_s:.1f} s, counted run on "
            f"the card {counted_s:.1f} s; FLOPs {card.flops:.6g} (meta {meta.flops:.6g}), bytes "
            f"{card.bytes:.6g} (meta {meta.bytes:.6g}); outside attn_core card "
            f"{outside(card)}, meta {outside(meta)}; attn_core card "
            f"{card.scopes.get('attn_core')}, meta {meta.scopes.get('attn_core')}; kernels "
            f"charged {card.kernels}, cost() {want}, launch counters {launched}")
        if outside(card) != outside(meta):
            log_row_diff(meta, card)
        assert outside(card) == outside(meta), (kind, outside(card), outside(meta))
        assert card.kernels == want, (kind, card.kernels, want)
        assert launched == {k: v[0] for k, v in want.items()}, (kind, launched, want)
        assert meta.kernels == {} and meta.memory["flop_counter_flops"] == meta.flops
        # (c) one uncounted run under the profiler
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        wall, busy, nrec = device_busy(traced.run)
        peak = torch.cuda.max_memory_allocated()
        model_flops = roofline.model_flops_for_cell(cfg, cell)
        t_c, t_m = card.flops / pk.bf16, card.bytes / pk.hbm_bw
        step = max(t_c, t_m)
        r = dict(wall_ms=wall * 1e3, busy_ms=busy, idle=None if busy is None else
                 1 - busy / (wall * 1e3), t_compute_ms=t_c * 1e3, t_memory_ms=t_m * 1e3,
                 bottleneck="compute" if t_c >= t_m else "memory", step_ms=step * 1e3,
                 model_flops=model_flops, mfu_measured=model_flops / (pk.bf16 * wall),
                 mfu_roofline=model_flops / (pk.bf16 * step), upcast_bytes=card.upcast_bytes,
                 peak_predicted=meta.memory["peak"], peak_measured=float(peak))
        log(f"(c) {TRAIN} {kind} {cell.name} on {smi}: wall {r['wall_ms']:.2f} ms, device busy "
            + ("not measured (the profiler kept no record)" if busy is None else
               f"{busy:.2f} ms ({nrec} records), idle share {r['idle']:.4f}")
            + f"; roofline at {roofline.sku(torch.cuda.get_device_name(0))}'s datasheet peaks "
            f"({pk.bf16 / 1e12:.0f} TFLOP/s bf16, {pk.hbm_bw / 1e12} TB/s): t_compute "
            f"{r['t_compute_ms']:.3f} ms, t_memory {r['t_memory_ms']:.3f} ms, bottleneck "
            f"{r['bottleneck']}, roofline step {r['step_ms']:.3f} ms (mfu at it "
            f"{r['mfu_roofline']:.4f}); model FLOPs {model_flops:.6g}, mfu_measured "
            f"{r['mfu_measured']:.4f}; bf16->f32 casts {card.upcast_bytes / 1e9:.3f} GB of "
            f"{card.bytes / 1e9:.3f} GB")
        log(f"(e) {TRAIN} {kind} {cell.name}: predicted peak {r['peak_predicted'] / 2**30:.2f} "
            f"GiB (meta trace: argument {meta.memory['argument'] / 2**30:.2f}, temp "
            f"{meta.memory['temp'] / 2**30:.2f}), max_memory_allocated "
            f"{peak / 2**30:.2f} GiB")
        if kind == "train":   # (d)
            top, _ = hlo_debug.top_contributors(card, 20)
            log(f"(d) hlo_debug top 20 of the {TRAIN} train step on the card "
                "(GB, GFLOP, count, op, scope, shapes):")
            for b, f, n, op, sc, shapes in top:
                log(f"  {b / 1e9:9.3f} {f / 1e9:10.1f} {n:6d} {op[:30]:30} {sc:10} {shapes[:90]}")
        out[kind] = r
        del traced, card, meta
        free_card()
    log(f"phase 21 on {smi}: {time.perf_counter() - t0:.1f} s")
    return out


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
    sku, pk = roofline.sku(kind), roofline.peaks(kind)
    bw, fp32, bf16 = pk.hbm_bw, pk.fp32, pk.bf16
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
    free_card()
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
    free_card()
    serving = {"15 serving": serving_phase(args, smi)}
    free_card()
    lap("15 serving")

    # 16. a continuous query over a growing table, and the serving CLI
    serving["16 stream"] = stream_phase(args, smi)
    lap("16 stream and CLI")
    log(f"serving launches {json.dumps(serving)}")

    # 17. the transformer's MoE and VLM layouts at full width
    families_phase(args, smi)
    lap("17 families")

    # 18. the encoder-decoder, recurrent and hybrid families at full width
    recurrent_phase(args, smi, bw, bf16)
    lap("18 recurrent families")

    # 19. training at full width through the attention kernel pair
    kres.update(attention_bwd_phase(args, bw, fp32, bf16))
    lap("19 backward kernel")
    train = train_phase(args, smi)
    launches["flash_attention_bwd"] = train["launches"]["flash_attention_bwd"]
    log(f"{TRAIN} training on {smi}: {json.dumps(train)}")
    lap("19 reduced depth: compress_grads, checkpoint and resume")

    # 20. the distribution layer across four ranks on the card
    dist_phase(args, smi)
    lap("20 distribution layer")

    # 21. the launch/ tooling: cost counter and roofline of three steps
    rl = roofline_phase(args, smi)
    log(f"{TRAIN} roofline on {smi}: {json.dumps(rl)}")
    lap("21 roofline")

    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(f"device: {smi}")
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": _SOURCES[name][0],
         "replaces": _SOURCES[name][1], "launches": launches[name],
         "max_abs_err": kres[name]["max_abs_err"], "ms": kres[name]["ms"],
         "plain_ms": kres[name]["plain_ms"], "bound_ms": kres[name]["bound_ms"],
         "bound_by": kres[name]["bound_by"], "library_ms": kres[name]["library_ms"],
         "clock": kres[name]["clock"], "plain_clock": kres[name]["plain_clock"]}
        for name, _, _ in _KERNELS]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
