"""Packed multimodal (T2I) training of BitDance-14B (the port's counterpart
of scripts/train_mllm.py).

    python -m bitdance_tpu_torch.cli.train_mllm \\
        --config train/configs/bitdance_14b_64x.yaml \\
        --data-dir /data/packed --hf-llm /models/Qwen3-14B

The YAML config (model, data and training blocks), packed .npz sequences
(data/packing.py) stacked into one step's batch, the loss weights of the
yaml, a checkpoint every ``save_every`` steps and at the end with the next
data file as its data status, keep-last-N rotation, auto-resume, and a
validation loss every ``validate_every`` steps on ``--val-batch``. Each step
draws from a seed of (global seed, step), so a resumed run equals the
straight run. The step is FSDP-sharded over a (replica, fsdp) mesh of the
launcher's processes, the yaml's (num_replicate, num_shard) when they
multiply to the world size, else (1, world) as the JAX script does; each
data shard takes its own packed sequence per microbatch. On the card by
default (``--device``); one process without a launcher, or:

    torchrun --nproc_per_node 8 -m bitdance_tpu_torch.cli.train_mllm \\
        --config train/configs/bitdance_14b_64x.yaml --data-dir /data/packed
"""

from __future__ import annotations

import argparse
import os
import sys


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--data-dir", type=str, required=True,
                   help="directory of .npz packed sequences (data/packing.py)")
    p.add_argument("--val-batch", type=str, default="",
                   help="held-out packed .npz for validate_every")
    p.add_argument("--hf-llm", type=str, default="",
                   help="HF Qwen3 directory to initialise the backbone (else random)")
    p.add_argument("--results-dir", type=str, default="results/mllm")
    p.add_argument("--vocab-size", type=int, default=152064)
    p.add_argument("--max-steps", type=int, default=-1)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None, stats: dict | None = None) -> int:
    """Run the command. ``stats``, when given, receives per step the
    seconds of the whole step (synchronised by each log line's read, so
    exact with log_every 1), the summed seconds of loading the batches and
    of the train steps (CUDA events on the card), each save's seconds, the
    restore's and the validation losses."""
    args = parse_args(argv)
    import time

    import numpy as np
    import torch

    from bitdance_tpu_torch.cli.common import require_device
    from bitdance_tpu_torch.config import (
        load_yaml,
        mesh_shape_from_yaml,
        mllm_config_from_yaml,
        mllm_train_config_from_yaml,
    )
    from bitdance_tpu_torch.data.packing import stack_packed_batches
    from bitdance_tpu_torch.io.random_init import build_random_mllm_train_state
    from bitdance_tpu_torch.models.mllm import PackedBatch
    from bitdance_tpu_torch.parallel.mesh import create_mesh, data_index, data_size
    from bitdance_tpu_torch.train.checkpoints import CheckpointManager, step_seed
    from bitdance_tpu_torch.train.mllm_train import eval_step, make_sharded_train_step
    from bitdance_tpu_torch.utils.fs import init_distributed
    from bitdance_tpu_torch.utils.logging import (
        MetricAccumulator,
        ScalarWriter,
        create_logger,
    )
    from bitdance_tpu_torch.utils.precision import full_fp32
    from bitdance_tpu_torch.utils.timing import PhaseTimer

    device = require_device(args.device)
    full_fp32()
    rank, world = init_distributed(device)
    ycfg = load_yaml(args.config)
    cfg = mllm_config_from_yaml(ycfg, args.vocab_size)
    tcfg = mllm_train_config_from_yaml(ycfg)
    stats = stats if stats is not None else {}
    stats.update(step_seconds=[], save_seconds=[])
    logger = create_logger(args.results_dir, rank)
    writer = ScalarWriter(os.path.join(args.results_dir, "tb"), rank)
    replica, shard = mesh_shape_from_yaml(ycfg)
    if replica * shard != world:
        logger.info(f"the yaml's mesh ({replica}, {shard}) does not fit {world} "
                    f"processes; overriding it to (1, {world})")
        replica, shard = 1, world
    mesh = create_mesh(replica=replica, fsdp=shard, device_type=device.type)
    stats["mesh"] = (replica, shard)
    logger.info(f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}")

    global_seed = int(ycfg.training.get("global_seed", 0))
    state = build_random_mllm_train_state(cfg, tcfg, device, dtype=torch.bfloat16,
                                          seed=global_seed)
    if args.hf_llm:
        from bitdance_tpu_torch.io.release import load_hf_qwen3_dir, load_state_

        hf_state, _ = load_hf_qwen3_dir(args.hf_llm)
        load_state_(state.model.llm, hf_state)
        if state.ema is not None:
            for name, p in state.model.named_parameters():
                state.ema[name].copy_(p.detach())
        logger.info(f"initialized LLM from {args.hf_llm}")
    step_fn, state = make_sharded_train_step(mesh, state, cfg, tcfg)

    ckpt = CheckpointManager(os.path.join(args.results_dir, "checkpoints"))
    start_file = 0
    if ycfg.training.get("auto_resume", True):
        t0 = time.perf_counter()
        restored, step, ds = ckpt.restore(state, with_data_status=True)
        if restored is not None:
            stats["restore_seconds"] = time.perf_counter() - t0
            start_file = (ds or {}).get("file", 0)
            logger.info(f"auto-resumed from step {step}, data file {start_file}")

    files = sorted(f for f in os.listdir(args.data_dir) if f.endswith(".npz"))
    if not files:
        raise SystemExit(f"no .npz packed sequences in {args.data_dir}")
    acc = MetricAccumulator()
    global_step = state.step
    save_every = int(ycfg.training.get("save_every", 1000))
    log_every = int(ycfg.training.get("log_every", 10))
    validate_every = int(ycfg.training.get("validate_every", 0))
    val_batch = None
    if args.val_batch:
        with np.load(args.val_batch) as raw:
            val_batch = PackedBatch.from_numpy(dict(raw), device)
    total_steps = (args.max_steps if args.max_steps > 0
                   else int(ycfg.training.get("total_steps", 10**6)))
    # one distinct packed sequence per data shard per microbatch (the JAX
    # script's HYBRID_SHARD layout); this process loads its own
    dp, index = data_size(mesh), data_index(mesh)
    seqs_per_step = dp * max(tcfg.grad_accum, 1)

    def load_step_batch(fi: int) -> PackedBatch:
        raws = []
        for a in range(max(tcfg.grad_accum, 1)):
            with np.load(os.path.join(args.data_dir,
                                      files[(fi + a * dp + index) % len(files)])) as raw:
                raws.append(dict(raw))
        return PackedBatch.from_numpy(
            stack_packed_batches(raws, grad_accum=tcfg.grad_accum), device)

    def save(fi: int) -> None:
        t = time.perf_counter()
        ckpt.save(global_step, state, data_status={"file": fi})
        stats["save_seconds"].append(time.perf_counter() - t)
        logger.info(f"saved checkpoint at step {global_step} "
                    f"({stats['save_seconds'][-1]:.2f} s)")

    timer = PhaseTimer(device)
    fi = start_file
    while global_step < total_steps:
        t_step = time.perf_counter()
        with timer("batch"):
            batch = load_step_batch(fi)
        with timer("train_step"):
            metrics = step_fn(state, batch, step_seed(global_seed, global_step))
        acc.update(loss=metrics["loss"], grad_norm=metrics["grad_norm"],
                   ce_loss_text=metrics["ce_loss_text"],
                   ce_loss_vision=metrics["ce_loss_vision"])
        global_step += 1
        fi += seqs_per_step
        if global_step % log_every == 0:
            means, sps = acc.flush()
            logger.info(f"(step={global_step:07d}) "
                        + ", ".join(f"{k}: {v:.4f}" for k, v in means.items())
                        + f", steps/sec: {sps:.2f}")
            for k, v in means.items():
                writer.add_scalar(f"train/{k}", v, global_step)
        stats["step_seconds"].append(time.perf_counter() - t_step)
        if val_batch is not None and validate_every and \
                global_step % validate_every == 0:
            vm = eval_step(state.model, val_batch, 0, cfg=cfg, tcfg=tcfg)
            vals = dict(zip(vm, torch.stack([v.float() for v in vm.values()]).tolist()))
            logger.info(f"(step={global_step:07d}) "
                        + ", ".join(f"{k}: {v:.4f}" for k, v in vals.items()))
            for k, v in vals.items():
                writer.add_scalar(f"val/{k}", v, global_step)
            stats.setdefault("val", []).append(vals)
        if global_step % save_every == 0:
            save(fi)

    stats["phase_seconds"] = timer.totals()
    if ckpt.latest_step() != global_step:
        save(fi)
    ckpt.close()
    writer.close()
    logger.info("training done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
