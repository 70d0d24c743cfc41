"""One run of one cell: set-up, the measured window, the metrics, the check.

:func:`prepare` is the set-up that ``run.py`` and ``calibrate.py`` share:
the configuration's family and weights from the seed, the table from the
mix and the seed, and the adapter of the mix's entry.  :func:`run` then
drives one warm call through the entry over the warm rows (every prompt
length the mix allows, so every shape the window meets), and calls the
entry over successive slices of the table until ``seconds`` have passed
and the call in flight has returned: every rate is taken over whole
calls, all their work and all their time.  After the window the program's
state is freed and the adapter's check judges a sample of the answers.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import time
from pathlib import Path

import torch

from bench.lib import adapter as adapter_mod
from bench.lib import check, family, manifest, traffic
from bench.lib.trace import DeviceTrace, Spans, idle_gaps

BENCH = Path(__file__).resolve().parents[1]


class Record:
    """What a per-layer metric's reader reads (``metrics/<name>.py``)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def reader(name: str):
    """The ``read(record)`` function of ``metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Setup:
    fam: family.Family
    mix: traffic.Mix
    weights: dict
    table: list
    spans: Spans
    adapter: adapter_mod.Base


def mix_of(cell: dict) -> traffic.Mix:
    return traffic.load(BENCH / "traffic" / f"{cell['traffic']}.json")


def prepare(man: dict, cell: dict, *, seed: int, device, fam=None, mix=None) -> Setup:
    fam = fam or family.load(manifest.ROOT / manifest.config(man, cell["config"])["file"])
    mix = mix or mix_of(cell)
    w = fam.weights(seed, device)
    spans = Spans()
    adapter = adapter_mod.load(mix["entry"]).Adapter(fam, w, mix, spans)
    return Setup(fam, mix, w, traffic.table(mix, seed), spans, adapter)


def run(man: dict, cell: dict, *, seed: int, seconds: float, trace: bool, device,
        t_start: float, fam=None, mix=None, log=lambda s: None) -> dict:
    s = prepare(man, cell, seed=seed, device=device, fam=fam, mix=mix)
    adapter, mix, table = s.adapter, s.mix, s.table
    per_call = int(mix["rows_per_call"])
    adapter.warm(traffic.warm(mix, seed))
    adapter.capture(table[: int(mix["check"].get("held", 0))])
    gc.collect()
    gc.freeze()          # set-up's objects out of the collector's walks in the window
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s; window {seconds} s")

    dt = DeviceTrace() if trace else None
    if dt:
        dt.start()
    w0 = time.time_ns()
    t0 = time.perf_counter()
    start = 0
    while time.perf_counter() - t0 < seconds:
        adapter.call([table[(start + i) % len(table)] for i in range(per_call)])
        start += per_call
    if device.type == "cuda":
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    w1 = w0 + int(window_s * 1e9)
    if dt:
        dt.stop()
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    e2e = adapter.end_to_end(window_s)
    attempted, failed = adapter.attempted_failed()
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    rec = Record(arch=s.fam.arch, costs=s.fam.costs, adapter=adapter, spans=s.spans, trace=dt,
                 window_s=window_s, wall=(w0, w1), device_name=name)
    metrics, breakdown = {}, None
    dev = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": name,
           "count": 1, "memory_peak_bytes": int(peak)}
    if not trace:
        for m in man["end_to_end"]:
            if cell["name"] not in m.get("workloads", [cell["name"]]):
                continue
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            elif m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        for m in man["per_layer"]:
            if cell["name"] not in m.get("workloads", [cell["name"]]):
                continue
            v = reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev["busy_s"] = dt.busy_ns(w0, w1) / 1e9
        dev["window_s"] = window_s
        breakdown = {"device_ops": dt.top_ops(10), "idle_gaps": idle_gaps(dt, s.spans, w0, w1, 10)}
        log(f"trace: {len(dt.names)} device records read in {dt.read_s:.2f} s")

    # the check: the program's state freed first, the reference in its place
    t_check = time.perf_counter()
    adapter.release()
    ok, checks = check.judge(adapter.check(table, seed), check.limits(cell["name"]))
    log(f"check {time.perf_counter() - t_check:.3f} s")
    out = {"correct": bool(ok and failed == 0), "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out
