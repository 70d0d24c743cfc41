"""Which ``torch.distributed`` collectives gloo carries for CUDA tensors, with
several ranks (processes) on one card, and at what rate.

    python3 tools/gloo_cuda_probe.py [--ranks 4]

Each group of collectives runs in a world of its own (a collective that
aborts a process ends only its world), and every result is printed as
``name | per-rank result``: ``["ok", seconds, value]`` or ``["refused",
error, message]``.  It also starts two nccl ranks on the card that run no
collective (NCCL refuses two ranks on one device only when it builds a
communicator).  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

MIB128 = 128 << 20


def _sum(op, dtype):
    def f(rank):
        x = torch.full((4,), float(rank), device="cuda", dtype=dtype)
        dist.all_reduce(x, op=op)
        return x.float().tolist()
    return f


def _bcast(dtype):
    def f(rank):
        x = torch.full((4,), float(rank), device="cuda", dtype=dtype)
        dist.broadcast(x, src=1)
        return x.float().tolist()
    return f


def _rate(fn, nbytes):
    def f(rank):
        fn()                                   # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return nbytes / 2**30 / (time.perf_counter() - t0)
    return f


def _gather(world):
    def f(rank):
        x = torch.full((2,), float(rank), device="cuda")
        out = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(out, x)
        return [t.tolist() for t in out]
    return f


def _reduce_scatter(world):
    def f(rank):
        out = torch.empty(2, device="cuda")
        dist.reduce_scatter_tensor(out, torch.ones(2 * world, device="cuda"))
        return out.tolist()
    return f


def _reduce(rank):
    x = torch.ones(2, device="cuda")
    dist.reduce(x, dst=0)
    return x.tolist()


def _send_recv(rank):
    x = torch.full((3,), float(rank), device="cuda")
    if rank == 0:
        dist.send(x, dst=1)
    elif rank == 1:
        dist.recv(x, src=0)
    return x.tolist()


def _dtensor(rank):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = init_device_mesh("cuda", (2, dist.get_world_size() // 2),
                            mesh_dim_names=("data", "model"))
    n = mesh.shape[1]
    local = torch.full((3, 2, 4), float(rank), device="cuda")
    d = DTensor.from_local(local, mesh, [Replicate(), Shard(1)], run_check=False,
                           shape=(3, 2 * n, 4), stride=(8 * n, 4, 1))
    d[1].to_local()[0, 0] = 99.0               # a view's write reaches the shard
    return [str(d[1].placements), local[1, 0, 0].item()]


def probes(world: int) -> list[dict]:
    S, M = dist.ReduceOp.SUM, dist.ReduceOp.MAX
    return [
        {f"all_reduce {n} {dt}": _sum(op, dt)
         for dt in (torch.float32, torch.bfloat16, torch.int32)
         for n, op in (("SUM", S), ("MAX", M))}
        | {"all_reduce AVG f32": _sum(dist.ReduceOp.AVG, torch.float32),
           "all_reduce 128 MiB f32, GiB/s": _rate(
               lambda: dist.all_reduce(torch.zeros(MIB128 // 4, device="cuda")), MIB128)},
        {f"broadcast {dt}": _bcast(dt)
         for dt in (torch.float32, torch.bfloat16, torch.int32, torch.int16, torch.uint8)}
        | {"broadcast 128 MiB bf16, GiB/s": _rate(
            lambda: dist.broadcast(torch.zeros(MIB128 // 2, dtype=torch.bfloat16,
                                               device="cuda"), src=0), MIB128)},
        {"DTensor over a cuda mesh": _dtensor},
        {"all_gather": _gather(world)},
        {"reduce_scatter_tensor": _reduce_scatter(world)},
        {"reduce": _reduce},
        {"send/recv": _send_recv},
    ]


def rank_main(rank: int, world: int, root: str, group: int) -> None:
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{root}/rdzv", world_size=world,
                            rank=rank)
    out = {}
    try:
        for name, fn in probes(world)[group].items():
            t0 = time.perf_counter()
            try:
                value = fn(rank)
                torch.cuda.synchronize()
                out[name] = ["ok", round(time.perf_counter() - t0, 4), value]
            except RuntimeError as e:           # a refusal the backend reports
                out[name] = ["refused", type(e).__name__, str(e)[:300]]
            with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()


_NCCL = """
import sys, torch, torch.distributed as dist
dist.init_process_group("nccl", init_method="tcp://127.0.0.1:%d", world_size=2,
                        rank=int(sys.argv[1]))
print("nccl rank", sys.argv[1], "up without a collective", flush=True)
dist.destroy_process_group()
"""


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("gloo_cuda_probe.py needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    for group in range(len(probes(args.ranks))):
        with tempfile.TemporaryDirectory() as root:
            t0 = time.time()
            try:
                mp.start_processes(rank_main, args=(args.ranks, root, group),
                                   nprocs=args.ranks, start_method="spawn")
                failed = "ok"
            except mp.ProcessRaisedException as e:
                failed = f"a rank raised: {str(e)[-300:]}"
            except mp.ProcessExitedException as e:
                failed = f"a rank died: {e}"
            res = []
            for r in range(args.ranks):
                p = os.path.join(root, f"rank{r}.json")
                res.append(json.load(open(p)) if os.path.exists(p) else {})
            for name in probes(args.ranks)[group]:
                print(name, "|", [x.get(name, "no result") for x in res], flush=True)
            print(f"  world {time.time() - t0:.1f} s: {failed}", flush=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, "-c", _NCCL % port, str(i)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=120)
        print("nccl exit", p.returncode, out.strip()[-300:])


if __name__ == "__main__":
    main()
