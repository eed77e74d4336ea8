"""The training-run proof (port of scripts/train_proof.py): loss descent and
a resume after a hard kill.

A real multi-step ImageNet training run (``train/imagenet_train.py``'s
sharded step over the processes' mesh, on the card unless ``--device``
says otherwise) shows, in one JSONL log:

  * the loss descending (a line per step);
  * checkpoint save -> HARD KILL (``os._exit(9)`` right after the save, no
    clean shutdown) -> restore in a new process -> the same state bit for
    bit: a sha256 digest over every tensor's bytes (model, AdamW moments
    and counts, EMA; each sharded tensor gathered whole, so every rank
    agrees) plus the step, the schedule's count and the learning rates,
    taken at save time and again after the restore;
  * the EMA advancing (it differs from the live parameters).

The data is a fixed synthetic set of +-1 latent tokens and labels (the
backbone and head memorise it, so the loss has signal); the batch and the
step's draws depend on the global step alone (the generator is seeded by
``train/checkpoints.py::step_seed(7, step)``), so the resumed run continues
the stream the killed run was on.

The parent starts both phases as processes, ``--world`` ranks each (RANK,
WORLD_SIZE and a free MASTER_PORT on 127.0.0.1; gloo on the CPU, NCCL on
cards), so that the kill is a real process death:

    python -m bitdance_tpu_torch.cli.train_proof --model BitDance-B --batch 128 \\
        --steps 300 --kill-at 200 --ckpt-every 100 --out results/train_proof.jsonl

Each phase also prints the flash kernels' launches as ``LAUNCHES {json}``
and where its time went as ``SECONDS {json}``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

GLOBAL_SEED = 7           # the JAX script's PRNGKey(7) for the step draws
INIT_SEED = 0             # and PRNGKey(0) for the initial state
ROOT = Path(__file__).resolve().parents[2]


def state_digest(state) -> str:
    """sha256 over every tensor of ``state`` (train/checkpoints.py's
    ``state_tensors``) in name order: its name, dtype, shape and the sha256
    of its bytes (a DTensor gathered whole, which every rank must call
    together), then the step, the schedule's count and each group's
    learning rate. The tensors' own digests run on threads (hashlib
    releases the GIL), beside the next tensor's copy to the host."""
    import concurrent.futures

    import torch

    from bitdance_tpu_torch.train.checkpoints import state_tensors
    from bitdance_tpu_torch.utils.dtensor import is_sharded

    def sha(t: torch.Tensor) -> bytes:
        return hashlib.sha256(t.reshape(-1).view(torch.uint8).numpy()).digest()

    h = hashlib.sha256()
    with concurrent.futures.ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        parts = []
        for name, t in sorted(state_tensors(state).items()):
            t = (t.full_tensor() if is_sharded(t) else t).detach().contiguous().cpu()
            parts.append((name, f"{t.dtype}{tuple(t.shape)}", pool.submit(sha, t)))
        for name, kind, digest in parts:
            h.update(name.encode() + kind.encode() + digest.result())
    h.update(json.dumps({"step": int(state.step), "tx_count": int(state.tx.count),
                         "lrs": [g["lr"] for g in state.tx.opt.param_groups]}).encode())
    return h.hexdigest()


def make_synth_batch(step: int, batch: int, seq: int, z: int,
                     n_samples: int = 512, num_classes: int = 1000):
    """The batch of global ``step`` from a fixed ``n_samples``-row synthetic
    set (cycled), the JAX script's numpy stream bit for bit."""
    idx = (np.arange(batch, dtype=np.int64) + step * batch) % n_samples
    out_t = np.empty((batch, seq, z), np.float32)
    out_c = np.empty((batch,), np.int32)
    for j, i in enumerate(idx):
        rng = np.random.default_rng(1234 + int(i))
        out_t[j] = np.sign(rng.standard_normal((seq, z))).astype(np.float32)
        out_c[j] = int(i) % num_classes
    return out_t, out_c


def build(args, device):
    """(config, sharded state, step function, mesh, checkpoint manager)."""
    import torch

    from bitdance_tpu_torch.models.imagenet_ar import IMAGENET_MODELS
    from bitdance_tpu_torch.parallel.mesh import create_mesh
    from bitdance_tpu_torch.train.checkpoints import CheckpointManager
    from bitdance_tpu_torch.train.imagenet_train import (
        ImageNetTrainConfig,
        init_train_state,
        make_sharded_train_step,
    )

    cfg = IMAGENET_MODELS[args.model](resolution=256, parallel_num=args.parallel)
    tcfg = ImageNetTrainConfig(warmup_steps=args.warmup, total_steps=10**9,
                               ema_decay=args.ema_decay, global_batch_size=args.batch)
    state = init_train_state(cfg, tcfg, device, generator=torch.Generator(
        device=device).manual_seed(INIT_SEED))
    mesh = create_mesh(device_type=device.type)
    step_fn, state = make_sharded_train_step(mesh, state, cfg, tcfg)
    ckpt = CheckpointManager(os.path.join(args.workdir, "checkpoints"),
                             keep_last_n=args.keep_last_n)
    return cfg, state, step_fn, mesh, ckpt


def _launches() -> dict:
    from bitdance_tpu_torch.ops.attention import flash_bwd_dkv, flash_bwd_dq, flash_fwd

    return {f.__name__: f.launches for f in (flash_fwd, flash_bwd_dq, flash_bwd_dkv)}


def train_loop(args, start_required: int | None) -> None:
    """The run phase trains until ``--kill-at``, saves and dies with
    ``os._exit(9)``; the resume phase restores (the digest and step held),
    trains to ``--steps`` and checks the EMA and the descent."""
    import torch

    from bitdance_tpu_torch.cli.common import require_device
    from bitdance_tpu_torch.parallel.mesh import batch_rows
    from bitdance_tpu_torch.train.checkpoints import step_seed
    from bitdance_tpu_torch.utils.dtensor import local
    from bitdance_tpu_torch.utils.fs import init_distributed
    from bitdance_tpu_torch.utils.precision import full_fp32

    t0 = time.perf_counter()
    device = require_device(args.device)
    full_fp32()
    rank, _ = init_distributed(device)
    cfg, state, step_fn, mesh, ckpt = build(args, device)
    # where a phase's time goes (host clock): the group and the state, the
    # restore, the digests, the saves, the steps
    seconds = dict.fromkeys(("build", "restore", "digest", "save", "steps"), 0.0)
    seconds["build"] = time.perf_counter() - t0
    rows = batch_rows(mesh, args.batch)
    log = open(args.out, "a", buffering=1) if rank == 0 else None

    def write(line: dict) -> None:
        if log is not None:
            log.write(json.dumps(line) + "\n")

    def say(msg: str) -> None:
        if rank == 0:
            print(msg, flush=True)

    def digest() -> str:
        t = time.perf_counter()
        dig = state_digest(state)
        seconds["digest"] += time.perf_counter() - t
        return dig

    def report() -> None:
        say(f"LAUNCHES {json.dumps(_launches())}")
        say(f"SECONDS {json.dumps({k: round(v, 3) for k, v in seconds.items()})}")

    t0 = time.perf_counter()
    restored, step0, data_status = ckpt.restore(state, with_data_status=True)
    seconds["restore"] = time.perf_counter() - t0
    if restored is not None:
        dig = digest()
        want = (data_status or {}).get("digest")
        write({"event": "resume", "step": step0, "digest": dig, "digest_at_save": want,
               "bit_identical": dig == want})
        say(f"RESUME step={step0} bit_identical={dig == want}")
        if dig != want:
            raise RuntimeError(f"restored state digest {dig[:16]} != saved {str(want)[:16]}")
        if start_required is not None and step0 != start_required:
            raise RuntimeError(f"resumed at step {step0}, want {start_required}")
    else:
        if start_required is not None:
            raise RuntimeError("expected a checkpoint to resume from")
        step0 = 0
        write({"event": "start", "model": args.model, "batch": args.batch,
               "steps": args.steps, "backend": device.type})

    t_prev = time.time()
    for step in range(step0, args.steps):
        t0 = time.perf_counter()
        toks, labels = make_synth_batch(step, args.batch, cfg.num_tokens, cfg.token_dim,
                                        num_classes=cfg.num_classes)
        gen = torch.Generator(device=device).manual_seed(step_seed(GLOBAL_SEED, step))
        metrics = step_fn(state, torch.from_numpy(toks[rows]).to(device),
                          torch.from_numpy(labels[rows]).to(device).long(), gen)
        loss = float(metrics["loss"])          # the host read fences the step
        gnorm = float(metrics["grad_norm"])
        seconds["steps"] += time.perf_counter() - t0
        now = time.time()
        write({"step": step + 1, "loss": round(loss, 5), "grad_norm": round(gnorm, 4),
               "step_s": round(now - t_prev, 3)})
        t_prev = now
        done = step + 1
        if done % args.ckpt_every == 0 or done == args.kill_at or done == args.steps:
            dig = digest()
            t0 = time.perf_counter()
            ckpt.save(done, state, data_status={"digest": dig, "i": done})
            seconds["save"] += time.perf_counter() - t0
            write({"event": "save", "step": done, "digest": dig})
            if args.phase == "run" and done == args.kill_at:
                say(f"KILL at step {done} digest={dig[:16]}")
                report()
                if log is not None:
                    log.close()
                os._exit(9)    # a hard death: no finalizers, no clean shutdown

    ema_moved = any(not torch.equal(local(state.ema[n]), local(p))
                    for n, p in zip(state.tx.names, state.tx.params))
    if not ema_moved:
        raise RuntimeError("EMA identical to the live parameters: the EMA did not advance")
    ckpt.close()
    report()
    if log is None:
        return
    # descent over the WHOLE run (both phases append to the same log)
    log.flush()
    with open(args.out) as f:
        losses = [json.loads(ln)["loss"] for ln in f if '"loss"' in ln and '"event"' not in ln]
    n = min(20, max(1, len(losses) // 4))
    first, last = float(np.mean(losses[:n])), float(np.mean(losses[-n:]))
    write({"event": "done", "steps": args.steps, "loss_first20": round(first, 5),
           "loss_last20": round(last, 5), "descended": bool(last < first)})
    say(f"DONE loss {first:.4f} -> {last:.4f} descended={last < first}")
    log.close()
    if args.require_descent and not last < first:
        raise RuntimeError(f"loss did not descend: {first:.4f} -> {last:.4f}")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="BitDance-B")
    p.add_argument("--parallel", type=int, default=1)
    p.add_argument("--batch", type=int, default=128, help="global batch")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--kill-at", type=int, default=200)
    p.add_argument("--ckpt-every", type=int, default=100)
    p.add_argument("--keep-last-n", type=int, default=3, help="checkpoints kept")
    p.add_argument("--warmup", type=int, default=100)
    p.add_argument("--ema-decay", type=float, default=0.9999)
    p.add_argument("--workdir", default="results/train_proof/work")
    p.add_argument("--out", default="results/train_proof/train_proof.jsonl")
    p.add_argument("--world", type=int, default=1, help="ranks a phase (parent only)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--phase", choices=["parent", "run", "resume"], default="parent")
    p.add_argument("--require-descent", action=argparse.BooleanOptionalAction, default=True,
                   help="fail unless the loss descended (off for short orchestration "
                        "smokes, where descent is luck)")
    return p.parse_args(argv)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _phase(args, phase: str, expect: int) -> list[int]:
    """Start ``args.world`` ranks of ``phase`` and wait for them; a rank
    that ends with another code than ``expect`` ends the others."""
    child = [sys.executable, "-m", "bitdance_tpu_torch.cli.train_proof",
             "--model", args.model, "--parallel", str(args.parallel),
             "--batch", str(args.batch), "--steps", str(args.steps),
             "--kill-at", str(args.kill_at), "--ckpt-every", str(args.ckpt_every),
             "--keep-last-n", str(args.keep_last_n), "--warmup", str(args.warmup),
             "--ema-decay", repr(args.ema_decay), "--workdir", args.workdir,
             "--out", args.out, "--device", args.device, "--phase", phase,
             "--require-descent" if args.require_descent else "--no-require-descent"]
    port = str(_free_port())
    procs = [subprocess.Popen(child, cwd=ROOT, env=dict(
        os.environ, RANK=str(r), WORLD_SIZE=str(args.world), LOCAL_RANK=str(r),
        MASTER_ADDR="127.0.0.1", MASTER_PORT=port)) for r in range(args.world)]
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, expect) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return [p.returncode for p in procs]


def main(argv=None) -> int:
    args = parse_args(argv)
    args.out, args.workdir = os.path.abspath(args.out), os.path.abspath(args.workdir)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    if args.phase != "parent":
        train_loop(args, None if args.phase == "run" else args.kill_at)
        return 0
    # the parent: run -> hard kill -> resume, each phase its own processes
    shutil.rmtree(args.workdir, ignore_errors=True)
    if os.path.exists(args.out):
        os.unlink(args.out)
    rcs = _phase(args, "run", 9)
    if rcs != [9] * args.world:
        raise SystemExit(f"the run phase should die with os._exit(9) on every rank, got {rcs}")
    rcs = _phase(args, "resume", 0)
    if rcs != [0] * args.world:
        raise SystemExit(f"the resume phase failed: return codes {rcs}")
    print("TRAIN_PROOF OK: hard-kill resume bit-identical"
          + (", loss descended" if args.require_descent else "") + f"; log at {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
