#!/usr/bin/env python3
"""What NCCL does when two processes put their ranks on one card.

    python3 scripts/nccl_shared_card.py [--timeout SECONDS]

Starts two processes. Each joins a two-rank NCCL process group on a
localhost TCP store, on cuda:0, and all-reduces one tensor. NCCL refuses a
second rank on a device that another rank of the same communicator holds,
which is why `symbiont_tpu_torch/parallel/mesh.device_backend` takes gloo
where processes share a card (the rule decides; this script shows the
refusal the rule avoids). Prints each process's exit code and the tail of
what it printed (NCCL_DEBUG=WARN), then one verdict line. A process that
has not ended by the deadline is killed. Needs a CUDA card; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import datetime
import os
import socket
import subprocess
import sys
import time


def worker(rank: int, port: int) -> int:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank, timeout=datetime.timedelta(seconds=60))
    x = torch.ones(4, device="cuda:0")
    dist.all_reduce(x)
    torch.cuda.synchronize()
    print(f"rank {rank}: all_reduce went through: {x.tolist()}", flush=True)
    dist.destroy_process_group()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--timeout", type=float, default=120.0)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        return worker(args.rank, args.port)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, NCCL_DEBUG="WARN")
    procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r), "--port", str(port)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    deadline = time.monotonic() + args.timeout
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
        except subprocess.TimeoutExpired:
            p.kill()
            outs.append(p.communicate()[0] + "\n(killed at the deadline)")
    for r, (p, out) in enumerate(zip(procs, outs)):
        print(f"--- rank {r}: exit code {p.returncode}\n{out[-4000:]}", flush=True)
    went = sum("all_reduce went through" in out for out in outs)
    print(f"NCCL with two ranks on cuda:0: {'refused' if went == 0 else 'ran'} "
          f"(exit codes {[p.returncode for p in procs]})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
