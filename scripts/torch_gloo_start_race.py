"""Start many two-process gloo groups at once on the CPU, each rank leaving
as soon as its group has started, and count the groups that failed.

    python scripts/torch_gloo_start_race.py --groups 16 --rounds 4
    python scripts/torch_gloo_start_race.py --groups 16 --rounds 4 --no-barrier

By default each rank starts its group through
``bitdance_tpu_torch/utils/fs.py::init_distributed``, which returns only
after a barrier over the new group. ``--no-barrier`` calls
``torch.distributed.init_process_group`` alone, as ``init_distributed`` did
before: the group's start does not wait for every rank's connections, so a
rank that leaves at once can close its socket while its peer is still
connecting ("Connection closed by peer" in gloo's connectFullMesh). The
last line is a JSON object with the counts.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def _rank(rank: int, workdir: str, barrier: bool) -> None:
    init = f"file://{workdir}/store"
    result = "ok"
    try:
        if barrier:
            from bitdance_tpu_torch.utils.fs import init_distributed

            os.environ.update(RANK=str(rank), WORLD_SIZE="2")
            init_distributed("cpu", init_method=init)
        else:
            dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2)
        dist.destroy_process_group()
    except RuntimeError as e:
        result = str(e)[:300]
    with open(os.path.join(workdir, f"rank{rank}"), "w") as f:
        f.write(result)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--groups", type=int, default=16, help="groups started at once")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--no-barrier", action="store_true",
                    help="init_process_group alone, without init_distributed's barrier")
    args = ap.parse_args()
    root = tempfile.mkdtemp(prefix="gloo_race_")
    failed, messages = 0, []
    try:
        for r in range(args.rounds):
            runs = []
            for g in range(args.groups):
                workdir = os.path.join(root, f"{r}_{g}")
                os.makedirs(workdir)
                runs.append((workdir, mp.start_processes(
                    _rank, args=(workdir, not args.no_barrier), nprocs=2, join=False,
                    start_method="spawn")))
            for workdir, ctx in runs:
                while not ctx.join(timeout=60):
                    pass
                got = [open(os.path.join(workdir, f"rank{k}")).read() for k in range(2)]
                if got != ["ok", "ok"]:
                    failed += 1
                    messages.append(next(m for m in got if m != "ok"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for m in sorted(set(messages)):
        print(m)
    print(json.dumps({"groups": args.groups * args.rounds, "failed": failed,
                      "barrier": not args.no_barrier}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
