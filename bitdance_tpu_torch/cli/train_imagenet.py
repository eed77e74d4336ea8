"""ImageNet class-conditional AR training (the port's counterpart of
scripts/train_imagenet.py, the reference's imagenet_gen/train.py).

    python -m bitdance_tpu_torch.cli.train_imagenet \\
        --data-path /data/ILSVRC2012_img_train.tar --model BitDance-B \\
        --results-dir results/b1x --epochs 800

An epoch loop over the tar (indexed by the native indexer) or a folder of
class folders: the frozen tokenizer encodes each batch on the device, one
train step (the flash attention kernels on the card), EMA, warmup and
cosine learning rate, aug-ratio decay, a checkpoint every
``--ckpt-every-epochs`` epochs and at the end, and auto-resume from the
latest checkpoint at its (epoch, batch). Each step draws from a generator
seeded by (global seed, step), so a resumed run equals the straight run.
The step is FSDP-sharded over a (replica, fsdp) mesh of the launcher's
processes (``--num-replicate`` replicas, the rest fsdp; one process without
a launcher), each process loading its own share of the batch, on the card
by default (``--device``):

    torchrun --nproc_per_node 8 -m bitdance_tpu_torch.cli.train_imagenet ...
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    # model (imagenet_gen/src/model.py:13-35)
    p.add_argument("--model", type=str, default="BitDance-L",
                   choices=["BitDance-B", "BitDance-L", "BitDance-H", "BitDance-S"])
    p.add_argument("--image-size", type=int, default=256, choices=[256, 512])
    p.add_argument("--down-size", type=int, default=16)
    p.add_argument("--patch-size", type=int, default=1)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--cls-token-num", type=int, default=64)
    p.add_argument("--latent-dim", type=int, default=16)
    p.add_argument("--diff-batch-mul", type=int, default=4)
    p.add_argument("--parallel-num", type=int, default=1)
    p.add_argument("--perturb-rate", type=float, default=0.0)
    p.add_argument("--time-schedule", type=str, default="logit_normal")
    p.add_argument("--time-shift", type=float, default=1.0)
    p.add_argument("--P-std", type=float, default=0.8)
    p.add_argument("--P-mean", type=float, default=-0.8)
    # loop (imagenet_gen/train.py:417-448)
    p.add_argument("--data-path", type=str, required=True)
    p.add_argument("--trained-vae", type=str, default="",
                   help="reference ae safetensors of the frozen tokenizer "
                        "(random tokenizer without it)")
    p.add_argument("--results-dir", type=str, default="results")
    p.add_argument("--epochs", type=int, default=800)
    p.add_argument("--global-batch-size", type=int, default=1024)
    p.add_argument("--global-seed", type=int, default=0)
    p.add_argument("--lr", type=float, default=6e-4)
    p.add_argument("--min-lr", type=float, default=0.0)
    p.add_argument("--weight-decay", type=float, default=0.05)
    p.add_argument("--beta1", type=float, default=0.9)
    p.add_argument("--beta2", type=float, default=0.95)
    p.add_argument("--warmup-steps", type=int, default=2000)
    p.add_argument("--decay-start", type=int, default=-1)
    p.add_argument("--max-grad-norm", type=float, default=1.0)
    p.add_argument("--ema-decay", type=float, default=0.9999)
    p.add_argument("--aug-decay-start-epoch", type=int, default=700)
    p.add_argument("--aug-decay-end-epoch", type=int, default=750)
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--ckpt-every-epochs", type=int, default=1)
    p.add_argument("--num-replicate", type=int, default=1)
    p.add_argument("--profile-dir", type=str, default="")
    p.add_argument("--max-steps", type=int, default=-1,
                   help="stop after this many steps in all (smoke runs)")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None, stats: dict | None = None) -> int:
    """Run the command. ``stats``, when given, receives what the run
    measured: per step the seconds of the data (host) and of the whole
    step (synchronised by each log line's read, so exact with
    ``--log-every 1``), the summed seconds of the encode and of the train
    step (CUDA events on the card), each save's seconds and the
    checkpoint's bytes, and the restore's seconds."""
    args = parse_args(argv)
    import torch

    from bitdance_tpu_torch.cli.common import imagenet_tokenizer, require_device
    from bitdance_tpu_torch.data.imagenet import (
        ShardedBatchIterator,
        build_dataset,
        linear_decay_ratio,
    )
    from bitdance_tpu_torch.models.imagenet_ar import IMAGENET_MODELS
    from bitdance_tpu_torch.parallel.mesh import create_mesh
    from bitdance_tpu_torch.train.checkpoints import CheckpointManager, step_seed
    from bitdance_tpu_torch.train.imagenet_train import (
        ImageNetTrainConfig,
        encode_batch,
        init_train_state,
        make_sharded_train_step,
    )
    from bitdance_tpu_torch.utils.fs import init_distributed
    from bitdance_tpu_torch.utils.logging import (
        MetricAccumulator,
        ScalarWriter,
        create_logger,
    )
    from bitdance_tpu_torch.utils.precision import full_fp32
    from bitdance_tpu_torch.utils.profiler import StepProfiler
    from bitdance_tpu_torch.utils.timing import PhaseTimer

    device = require_device(args.device)
    full_fp32()
    rank, world = init_distributed(device)
    stats = stats if stats is not None else {}
    stats.update(data_seconds=[], step_seconds=[], save_seconds=[], ckpt_bytes=[])
    logger = create_logger(args.results_dir, rank)
    writer = ScalarWriter(os.path.join(args.results_dir, "tb"), rank)

    cfg = IMAGENET_MODELS[args.model](
        resolution=args.image_size, down_size=args.down_size,
        patch_size=args.patch_size, latent_dim=args.latent_dim,
        cls_token_num=args.cls_token_num, num_classes=args.num_classes,
        diff_batch_mul=args.diff_batch_mul, parallel_num=args.parallel_num,
        perturb_rate=args.perturb_rate, time_schedule=args.time_schedule,
        time_shift=args.time_shift, P_std=args.P_std, P_mean=args.P_mean)
    tcfg = ImageNetTrainConfig(
        lr=args.lr, min_lr=args.min_lr, weight_decay=args.weight_decay,
        betas=(args.beta1, args.beta2), warmup_steps=args.warmup_steps,
        total_steps=10**9, decay_start=args.decay_start,
        max_grad_norm=args.max_grad_norm, ema_decay=args.ema_decay,
        global_batch_size=args.global_batch_size)

    if not args.trained_vae:
        logger.info("WARNING: no --trained-vae given; random tokenizer")
    ae = imagenet_tokenizer(args.latent_dim, args.trained_vae, device, encoder=True)
    state = init_train_state(cfg, tcfg, device, generator=torch.Generator(
        device=device).manual_seed(args.global_seed))
    mesh = create_mesh(replica=args.num_replicate, device_type=device.type)
    step_fn, state = make_sharded_train_step(mesh, state, cfg, tcfg)
    logger.info(f"train state initialized on {device}; mesh "
                f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}, state sharded")

    ckpt = CheckpointManager(os.path.join(args.results_dir, "checkpoints"))
    start_epoch, start_batch = 0, 0
    t0 = time.perf_counter()
    restored, step, data_status = ckpt.restore(state, with_data_status=True)
    if restored is not None:
        stats["restore_seconds"] = time.perf_counter() - t0
        start_epoch = (data_status or {}).get("epoch", 0)
        start_batch = (data_status or {}).get("batch", 0)
        logger.info(f"auto-resumed from step {step} (epoch {start_epoch}, batch "
                    f"{start_batch}) in {stats['restore_seconds']:.2f} s")

    dataset = build_dataset(args.data_path, args.image_size, args.global_seed)
    loader = ShardedBatchIterator(dataset, args.global_batch_size,
                                  num_shards=world, shard_index=rank,
                                  seed=args.global_seed)
    batches_per_epoch = len(loader.epoch_indices(0)) // loader.local_batch
    profiler = StepProfiler(args.profile_dir or os.path.join(
        args.results_dir, "profile"), enabled=bool(args.profile_dir), rank=rank)

    def save(data_status: dict) -> None:
        t = time.perf_counter()
        ckpt.save(global_step, state, data_status=data_status)
        stats["save_seconds"].append(time.perf_counter() - t)
        d = os.path.join(ckpt.directory, str(global_step))
        stats["ckpt_bytes"].append(sum(os.path.getsize(os.path.join(d, f))
                                       for f in os.listdir(d)))
        logger.info(f"saved checkpoint at step {global_step} {data_status} "
                    f"({stats['save_seconds'][-1]:.2f} s, "
                    f"{stats['ckpt_bytes'][-1] / 1e9:.3f} GB)")

    def done() -> bool:
        return args.max_steps > 0 and global_step >= args.max_steps

    acc = MetricAccumulator()
    timer = PhaseTimer(device)
    global_step = state.step
    position = {"epoch": args.epochs, "batch": 0}
    for epoch in range(start_epoch, args.epochs):
        if done():
            position = {"epoch": epoch, "batch": start_batch if epoch == start_epoch else 0}
            break
        dataset.set_aug_ratio(linear_decay_ratio(
            epoch, args.aug_decay_start_epoch, args.aug_decay_end_epoch))
        first = start_batch if epoch == start_epoch else 0
        batches = loader.iter_epoch(epoch, first)
        for b in range(first, batches_per_epoch):
            t_step = time.perf_counter()
            images, labels = next(batches)
            stats["data_seconds"].append(time.perf_counter() - t_step)
            gen = torch.Generator(device=device).manual_seed(
                step_seed(args.global_seed, global_step))
            with timer("encode"):
                tokens = encode_batch(ae, cfg, torch.from_numpy(images).to(device))
            with timer("train_step"):
                metrics = step_fn(state, tokens,
                                  torch.from_numpy(labels).to(device).long(), gen)
            profiler.step()
            acc.update(loss=metrics["loss"], grad_norm=metrics["grad_norm"])
            global_step += 1
            if global_step % args.log_every == 0:
                means, sps = acc.flush()
                logger.info(f"(step={global_step:07d}) epoch={epoch} "
                            + ", ".join(f"{k}: {v:.4f}" for k, v in means.items())
                            + f", steps/sec: {sps:.2f}")
                for k, v in means.items():
                    writer.add_scalar(f"train/{k}", v, global_step)
                writer.add_scalar("train/steps_per_sec", sps, global_step)
            stats["step_seconds"].append(time.perf_counter() - t_step)
            if done():
                position = ({"epoch": epoch, "batch": b + 1}
                            if b + 1 < batches_per_epoch
                            else {"epoch": epoch + 1, "batch": 0})
                break
        else:
            if (epoch + 1) % args.ckpt_every_epochs == 0:
                save({"epoch": epoch + 1, "batch": 0})
            continue
        break

    stats["phase_seconds"] = timer.totals()
    if ckpt.latest_step() != global_step:
        save(position)
    ckpt.close()
    profiler.close()
    writer.close()
    logger.info("training done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
