"""Time the ``decode_attention`` and ``rmsnorm`` kernels of several source
trees in turns on one CUDA card, each beside its PyTorch library call.

    python3 tools/kernel_ab.py TREE [TREE ...] [--rounds N] [--seed N]

A TREE is the root of a checkout of this repository (its ``src/`` holds
``repro_torch``); to compare a variant, unpack a copy of the tree
(``git archive``) into an ignored directory and edit it there.
Each tree is measured in a process of its own (two trees of one package
cannot share one), in the order A B B A A B ... over ``--rounds`` rounds,
so that a drift of the card's clocks reaches every tree; each builds its
two kernel libraries into its own ``build/kernels/`` first.

Shapes are those of ``chip_smoke.py``'s phases 7 and 9: ``decode_attention``
at q [32,1,24,128], k/v [32,1024,8,128] with random lens (f32 and bf16,
against SDPA with a bool mask and GQA; bf16 also with every lens at S - 1),
``rmsnorm`` at x [16384, 3072]
bf16 (against ``F.rms_norm``), and ``x.clone()`` of that x, a copy of the
same bytes.  Besides, ``decode_attention`` bf16 at small batches, where
``chunk_for`` decides whether a row's keys split into several chunks: the
engine's default 8 slots at S 1024 (random lens and lens S - 1), the paged
phase's 8 rows of 128 positions, and 2 rows of 4096.  Times are profiler device time per call.
Prints the card's name and power limit, then one line per tree and kernel
(median kernel ms, library ms, the ratio of each of the tree's runs, GB/s),
and exits non-zero if a kernel disagrees with its plain version or the
profiler keeps no record of a timing.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

PEAK_BW = 3.35e12   # H100 SXM device memory, bytes/s (NVIDIA datasheet)


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


def child(tree: str, seed: int) -> None:
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.kernels import rmsnorm as krn

    _build.SOURCES = ("rmsnorm", "decode_attention")
    _build.build()
    dev = torch.device("cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
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
        rows = int((lens.clamp(max=S - 1) + 1).sum())
        es = q.element_size()
        nbytes = rows * HK * HD * 2 * es + 2 * q.numel() * es + lens.numel() * 4
        out[f"decode_attention {str(dt)[6:]}"] = dict(ms=ms, lib=lib, nbytes=nbytes, err=err)
        if dt == torch.bfloat16:   # every row at S - 1: the whole cache, uniform work
            full = torch.full_like(lens, S - 1)
            out["decode_attention bfloat16, lens S - 1"] = dict(
                ms=device_ms(torch, lambda: kda.decode_attention(q, k, v, full), 20),
                lib=lib, nbytes=B * S * HK * HD * 2 * es + 2 * q.numel() * es + B * 4,
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
        rows = int((lens + 1).sum())
        out[f"decode_attention bfloat16, B {b} S {s}, lens {'S - 1' if full else 'random'}"] = \
            dict(ms=device_ms(torch, lambda: kda.decode_attention(q, k, v, lens), 20),
                 lib=device_ms(torch, lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                                   enable_gqa=True), 20),
                 nbytes=rows * HK * HD * 2 * 2 + 2 * q.numel() * 2 + b * 4, err=err)
    x = torch.randn(16384, 3072, device=dev, generator=g).to(torch.bfloat16)
    sc = torch.randn(3072, device=dev, generator=g)
    sc16 = sc.to(torch.bfloat16)
    err = float((krn.rmsnorm(x, sc, eps=1e-5).float()
                 - ref.rmsnorm_ref(x, sc, eps=1e-5).float()).abs().max())
    ms = device_ms(torch, lambda: krn.rmsnorm(x, sc, eps=1e-5), 20)
    lib = device_ms(torch, lambda: torch.nn.functional.rms_norm(x, (3072,), sc16, eps=1e-5), 20)
    out["rmsnorm bfloat16"] = dict(ms=ms, lib=lib, nbytes=2 * x.numel() * 2 + 3072 * 4, err=err)
    # a copy of x moves the same bytes: the card's reachable rate for them
    out["x.clone() bfloat16"] = dict(ms=device_ms(torch, x.clone, 20), lib=1.0,
                                     nbytes=2 * x.numel() * 2, err=0.0)
    print(json.dumps(out))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--child", default=None)
    args = ap.parse_args()
    if args.child is not None:
        child(args.child, args.seed)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"device: {smi}", flush=True)
    order = []
    for r in range(args.rounds):
        order += args.trees if r % 2 == 0 else args.trees[::-1]
    runs: dict[str, list[dict]] = {t: [] for t in args.trees}
    for spec in order:
        res = subprocess.run([sys.executable, __file__, "_", "--child", spec,
                              "--seed", str(args.seed)], capture_output=True, text=True)
        if res.returncode != 0:
            sys.exit(f"{spec} failed:\n{res.stdout[-4000:]}\n{res.stderr[-4000:]}")
        runs[spec].append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(f"ran {spec}: {res.stdout.strip().splitlines()[-1]}", flush=True)
    for spec, rs in runs.items():
        for name in rs[0]:
            ms = statistics.median(r[name]["ms"] for r in rs)
            lib = statistics.median(r[name]["lib"] for r in rs)
            ratios = ", ".join(f"{r[name]['ms'] / r[name]['lib']:.3f}" for r in rs)
            nbytes = rs[0][name]["nbytes"]
            print(f"{spec} | {name}: kernel {ms:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s, "
                  f"bound {nbytes / PEAK_BW * 1e3:.4f} ms), library {lib:.4f} ms; "
                  f"kernel / library per run {ratios}; max abs err "
                  f"{max(r[name]['err'] for r in rs):.3g}")


if __name__ == "__main__":
    main()
