"""Render the roofline table from dry-run artifacts into EXPERIMENTS.md.

    PYTHONPATH=src python -m repro_torch.launch.report [--dir artifacts/dryrun_torch]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

SHAPE_ORDER = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}


def build_table(art_dir: str) -> str:
    rows = []
    skips = []
    for f in sorted(glob.glob(os.path.join(art_dir, "*.json"))):
        d = json.load(open(f))
        if d.get("status") == "skipped":
            skips.append((d["mesh"], d["arch"], d["shape"]))
            continue
        if d.get("status") != "ok":
            rows.append((d["mesh"], d["arch"], d["shape"], d.get("status"), {}))
            continue
        rows.append((d["mesh"], d["arch"], d["shape"], "ok", d))
    rows.sort(key=lambda r: (r[0], r[1], SHAPE_ORDER.get(r[2], 9)))

    out = ["| mesh | arch | shape | bottleneck | t_comp | t_mem | t_mem_flash | t_coll | step_s | MFU | MFU_flash | useful | peak GB | ideal GB/dev |",
           "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for mesh, arch, shape, status, d in rows:
        if status != "ok":
            out.append(f"| {mesh} | {arch} | {shape} | {status.upper()} | | | | | | | | | | |")
            continue
        r = d["roofline"]
        peak = r["mem_per_dev"].get("peak", 0) / 1e9
        ideal = d.get("ideal_bytes_per_dev", 0) / 1e9
        out.append(
            f"| {mesh} | {arch} | {shape} | {r['bottleneck']} | "
            f"{r['t_compute_s']:.3g} | {r['t_memory_s']:.3g} | "
            f"{r['t_memory_flash_s']:.3g} | {r['t_collective_s']:.3g} | "
            f"{r['step_time_s']:.3g} | {r['mfu']:.3f} | {r['mfu_flash']:.3f} | "
            f"{r['useful_flops_ratio']:.2f} | {peak:.1f} | {ideal:.2f} |")
    out.append("")
    out.append(f"Skipped cells ({len(skips)}): long_500k for pure full-attention "
               "archs per the assignment — "
               + ", ".join(sorted({a for _, a, _ in skips})) + ".")
    return "\n".join(out)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="artifacts/dryrun_torch")
    ap.add_argument("--write", action="store_true", help="inject into EXPERIMENTS.md")
    args = ap.parse_args()
    table = build_table(args.dir)
    print(table)
    if args.write:
        path = "EXPERIMENTS.md"
        text = open(path).read()
        marker = "<!-- ROOFLINE_TABLE -->"
        if marker in text:
            text = text.replace(marker, marker + "\n\n" + table)
            open(path, "w").write(text)
            print(f"\n[report] table injected into {path}")


if __name__ == "__main__":
    main()
