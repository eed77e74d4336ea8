"""Training checkpoints and release export (port of
bitdance_tpu/train/checkpoints.py: CheckpointManager, export_release_dir,
export_hf_qwen3).

CheckpointManager keeps the JAX manager's interface (save with a
``data_status``, restore, latest_step, keep-last-N, async saves and an HDFS
mirror) over the port's own format, since orbax is a JAX library. A step is
a directory ``<dir>/<step>/``:
  - ``state.safetensors``: the TrainState's tensors, written one at a time
    through io/safetensors.py: ``model/<name>`` for the model's state dict
    (the fp32 masters), ``opt/<param name>/<key>`` for every tensor AdamW
    keeps (both moments and its step count), ``ema/<name>`` for the EMA;
  - ``meta.json``: the format, ``step``, the schedule's count and the
    learning rate of each parameter group;
  - ``data_status.json`` when the caller passes one.
A save writes ``<dir>/<step>.tmp/`` and renames it when every file is
written, so a save cut short (the process killed) never looks like a
checkpoint. Files are not fsynced: a machine that loses power may lose the
newest step.

A state under FSDP (its tensors DTensors, parallel/mesh.py; the JAX
package's orbax save of a sharded state) is saved by every process: each
writes its own shards as ``state.rank<r>-of-<world>.safetensors`` (at world
1 the one file is ``state.safetensors``, as an unsharded save names it) and
their places, {name: {"shape": global shape, "offset": the shard's first
index}}, as ``shards.rank<r>.json``; tensors with no entry are whole (the
optimizer's step counts). Process 0 writes the meta (with ``world``) and
the data status, and renames the directory only after every process has
written (a barrier). :meth:`CheckpointManager.restore` at the same world
reads each process's own file; at another world, or into an unsharded
state, it assembles each tensor from every process's file.

The release export writes each module's state dict as it is: ae /
vision_head / projector safetensors and their JSON configs, and the LLM as
an HF Qwen3 checkpoint (model.safetensors in fp32 plus config.json), the
layout pipelines/loader.py (and the JAX package's loader) reads.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import shutil
import threading

import torch
import torch.distributed as dist
from torch import nn

from bitdance_tpu_torch.io.safetensors import load_file, save_file
from bitdance_tpu_torch.train.optim import TrainState
from bitdance_tpu_torch.utils.dtensor import (
    dtensor_like,
    is_sharded,
    local,
    local_region,
)

FORMAT = "bitdance_tpu_torch.train_state/1"


def step_seed(global_seed: int, step: int) -> int:
    """The seed of one training step's draws. A run resumed at any step
    draws what the straight run drew, since each step's generator depends
    on (global_seed, step) alone."""
    return (int(global_seed) * 1_000_003 + int(step)) % (2 ** 63)


def state_tensors(state: TrainState) -> dict[str, torch.Tensor]:
    """Every tensor of ``state`` by its checkpoint name (views, no copies)."""
    out = {f"model/{k}": v for k, v in state.model.state_dict().items()}
    opt = state.tx.opt
    for name, p in zip(state.tx.names, state.tx.params):
        for key, v in opt.state.get(p, {}).items():
            if not isinstance(v, torch.Tensor):
                raise TypeError(f"AdamW state {name}/{key} is a {type(v).__name__}, "
                                "not a tensor")
            out[f"opt/{name}/{key}"] = v
    for k, v in (state.ema or {}).items():
        out[f"ema/{k}"] = v
    return out


class CheckpointManager:
    """Step checkpoints of a TrainState with keep-last-N rotation and
    auto-resume.

    ``async_save=True`` (unsharded states only; :meth:`save` refuses a
    sharded one, whose processes write together between barriers):
    :meth:`save` copies the tensors to the host, then writes on a thread
    while training goes on (one save in flight; the next save,
    :meth:`restore`, :meth:`wait_until_finished` and :meth:`close` wait for
    it and raise its error). Otherwise tensors are copied to the
    host one at a time as they are written, so no second host copy of the
    state exists. ``hdfs_mirror``: each finished step is also copied there
    (utils/fs.py) on a thread."""

    def __init__(self, directory: str, keep_last_n: int = 3,
                 async_save: bool = False, hdfs_mirror: str | None = None):
        self.directory = os.path.abspath(directory)
        self.keep_last_n = keep_last_n
        self.async_save = async_save
        self.hdfs_mirror = hdfs_mirror
        os.makedirs(self.directory, exist_ok=True)
        rank, world = _process()
        if rank == 0:
            for name in os.listdir(self.directory):
                if name.endswith(".tmp"):         # a save that was cut short
                    shutil.rmtree(os.path.join(self.directory, name))
        if world > 1:
            dist.barrier()
        self._pool = (concurrent.futures.ThreadPoolExecutor(max_workers=1)
                      if async_save else None)
        self._pending: concurrent.futures.Future | None = None
        self._mirrors: list[threading.Thread] = []

    def all_steps(self) -> list[int]:
        return sorted(int(n) for n in os.listdir(self.directory) if n.isdigit())

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState,
             data_status: dict | None = None) -> None:
        """Write ``state`` as step ``step`` (which must not exist yet)."""
        self.wait_until_finished()
        step = int(step)
        if os.path.exists(self._step_dir(step)):
            raise FileExistsError(f"checkpoint step {step} exists in {self.directory}")
        meta = {"format": FORMAT, "step": int(state.step), "tx_count": state.tx.count,
                "lrs": [g["lr"] for g in state.tx.opt.param_groups]}
        tensors = state_tensors(state)
        if any(is_sharded(t) for t in tensors.values()):
            if self._pool is not None:
                raise ValueError("async_save: a sharded state is saved by every process "
                                 "together, between barriers, not on a thread")
            self._write_sharded(step, tensors, meta, data_status)
            return
        if self._pool is None:
            self._write(step, tensors, meta, data_status)
            return
        host = {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}
        self._pending = self._pool.submit(self._write, step, host, meta, data_status)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def _write(self, step: int, tensors: dict, meta: dict,
               data_status: dict | None) -> None:
        final = self._step_dir(step)
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        save_file(tensors, os.path.join(tmp, "state.safetensors"))
        self._finish(step, tmp, meta, data_status)

    def _write_sharded(self, step: int, tensors: dict, meta: dict,
                       data_status: dict | None) -> None:
        rank, world = _process()
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
        _barrier(world)
        own, places = {}, {}
        for name, t in tensors.items():
            if is_sharded(t):
                offset, _ = local_region(t.shape, t.device_mesh, t.placements)
                places[name] = {"shape": list(t.shape), "offset": list(offset)}
                t = t.to_local()
            own[name] = t
        save_file(own, os.path.join(tmp, _shard_file(rank, world)))
        with open(os.path.join(tmp, f"shards.rank{rank:05d}.json"), "w") as f:
            json.dump(places, f)
        _barrier(world)
        if rank == 0:
            self._finish(step, tmp, dict(meta, world=world), data_status)
        _barrier(world)

    def _finish(self, step: int, tmp: str, meta: dict, data_status: dict | None) -> None:
        """Write the meta and the data status into ``tmp``, rename it into
        place, drop old steps and mirror the new one."""
        for name, obj in (("meta.json", meta), ("data_status.json", data_status)):
            if obj is not None:
                with open(os.path.join(tmp, name), "w") as f:
                    json.dump(obj, f)
        os.rename(tmp, self._step_dir(step))
        for old in self.all_steps()[:-self.keep_last_n] if self.keep_last_n > 0 else ():
            shutil.rmtree(self._step_dir(old))
        self._mirror(step)

    def _mirror(self, step: int) -> None:
        if not self.hdfs_mirror:
            return
        from bitdance_tpu_torch.utils import fs

        dst = f"{self.hdfs_mirror.rstrip('/')}/{step}"
        t = threading.Thread(target=fs.copy, args=(self._step_dir(step), dst),
                             daemon=True)
        t.start()
        self._mirrors.append(t)

    def wait_until_finished(self) -> None:
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def restore(self, state_like: TrainState, step: int | None = None,
                with_data_status: bool = False):
        """Fill ``state_like`` in place (each tensor on its own device) from
        step ``step`` (the latest by default). Returns (state, step,
        data_status), or (None, None, None) when no step exists. A step
        whose tensors do not match the state's names, shapes and dtypes
        raises."""
        self.wait_until_finished()
        step = self.latest_step() if step is None else int(step)
        if step is None:
            return None, None, None
        d = self._step_dir(step)
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        if meta.get("format") != FORMAT:
            raise ValueError(f"{d}: format {meta.get('format')!r}, want {FORMAT!r}")
        _fill(state_like, _Saved(d, meta.get("world")), d)
        state_like.step = int(meta["step"])
        state_like.tx.count = int(meta["tx_count"])
        groups = state_like.tx.opt.param_groups
        if len(meta["lrs"]) != len(groups):
            raise ValueError(f"{d}: {len(meta['lrs'])} parameter groups, the state "
                             f"has {len(groups)}")
        for g, lr in zip(groups, meta["lrs"]):
            g["lr"] = lr
        data_status = None
        ds_path = os.path.join(d, "data_status.json")
        if with_data_status and os.path.exists(ds_path):
            with open(ds_path) as f:
                data_status = json.load(f)
        return state_like, step, data_status

    def close(self) -> None:
        self.wait_until_finished()
        if self._pool is not None:
            self._pool.shutdown()
        for t in self._mirrors:
            t.join()
        self._mirrors.clear()


def _process() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier(world: int) -> None:
    if world > 1:
        dist.barrier()


def _shard_file(rank: int, world: int) -> str:
    return ("state.safetensors" if world == 1
            else f"state.rank{rank:05d}-of-{world:05d}.safetensors")


class _Saved:
    """The tensors of one step directory, unsharded (``world`` None) or
    written by ``world`` processes: :meth:`shape` of each, :meth:`get` it
    whole or as one process's shard. Files are read lazily (memory-mapped)."""

    def __init__(self, d: str, world: int | None):
        self.d, self.world = d, world
        self._files: dict[int, dict] = {}
        self._places: dict[int, dict] = {}
        self.names = set(self._file(0))

    def _file(self, r: int) -> dict:
        if r not in self._files:
            name = "state.safetensors" if self.world is None else _shard_file(r, self.world)
            self._files[r] = load_file(os.path.join(self.d, name))
        return self._files[r]

    def _place(self, r: int) -> dict:
        if self.world is None:
            return {}
        if r not in self._places:
            with open(os.path.join(self.d, f"shards.rank{r:05d}.json")) as f:
                self._places[r] = json.load(f)
        return self._places[r]

    def shape(self, name: str) -> tuple:
        p = self._place(0).get(name)
        return tuple(p["shape"]) if p else tuple(self._file(0)[name].shape)

    def dtype(self, name: str) -> torch.dtype:
        return self._file(0)[name].dtype

    def get(self, name: str, region: tuple | None = None) -> torch.Tensor:
        """The tensor whole, or the part at ``region`` (offset, shape): this
        process's own shard when its file holds just that, else cut from the
        tensor assembled from every process's file."""
        rank, world = _process()
        if region is not None and world == self.world:
            p = self._place(rank).get(name)
            t = self._file(rank)[name]
            if p and tuple(p["offset"]) == region[0] and tuple(t.shape) == region[1]:
                return t
        full = self._whole(name)
        if region is None:
            return full
        for dim, (o, s) in enumerate(zip(*region)):
            full = full.narrow(dim, o, s)
        return full

    def _whole(self, name: str) -> torch.Tensor:
        if self.world is None or name not in self._place(0):
            return self._file(0)[name]
        full = torch.empty(self.shape(name), dtype=self.dtype(name))
        for r in range(self.world):
            t = self._file(r)[name]
            view = full
            for dim, (o, s) in enumerate(zip(self._place(r)[name]["offset"], t.shape)):
                view = view.narrow(dim, o, s)
            view.copy_(t)
        return full


def _region(t: torch.Tensor) -> tuple | None:
    """(offset, local shape) of a DTensor's shard; None for a whole tensor."""
    if not is_sharded(t):
        return None
    return local_region(t.shape, t.device_mesh, t.placements)


@torch.no_grad()
def _fill(state: TrainState, saved: _Saved, where: str) -> None:
    """Copy ``saved`` into ``state``'s tensors in place (the local shards of
    DTensors). Model and EMA names must match exactly (a checkpoint's EMA
    is ignored by a state without one, as in the JAX manager); AdamW's
    per-parameter state is rebuilt from the checkpoint on each parameter's
    device (sharded like it when it has its shape), in place where a tensor
    of that shape and dtype exists."""
    def check(name, dst):
        if saved.shape(name) != tuple(dst.shape) or saved.dtype(name) != dst.dtype:
            raise ValueError(f"{where}: {name} is {saved.dtype(name)} "
                             f"{saved.shape(name)}, the state's {dst.dtype} "
                             f"{tuple(dst.shape)}")

    groups = {"model": {}, "opt": {}, "ema": {}}
    for k in saved.names:
        kind, _, rest = k.partition("/")
        if kind not in groups:
            raise ValueError(f"{where}: unknown tensor {k}")
        groups[kind][rest] = k
    targets = [("model", state.model.state_dict())]
    if state.ema is not None:
        targets.append(("ema", state.ema))
    for kind, own in targets:
        if set(own) != set(groups[kind]):
            diff = sorted(set(own) ^ set(groups[kind]))
            raise KeyError(f"{where}: {kind} tensors differ from the state's: {diff[:8]}")
        for name, dst in own.items():
            key = groups[kind][name]
            check(key, dst)
            local(dst).copy_(saved.get(key, _region(dst)))
    per_param: dict[str, dict] = {}
    for rest, k in groups["opt"].items():
        name, _, key = rest.rpartition("/")
        per_param.setdefault(name, {})[key] = k
    unknown = set(per_param) - set(state.tx.names)
    if unknown:
        raise KeyError(f"{where}: optimizer state of unknown parameters "
                       f"{sorted(unknown)[:8]}")
    opt = state.tx.opt
    for name, p in zip(state.tx.names, state.tx.params):
        entries = per_param.get(name)
        if not entries:
            opt.state.pop(p, None)
            continue
        own = opt.state.get(p, {})
        new = {}
        for key, k in entries.items():
            dst = own.get(key)
            if isinstance(dst, torch.Tensor) and tuple(dst.shape) == saved.shape(k) \
                    and dst.dtype == saved.dtype(k):
                local(dst).copy_(saved.get(k, _region(dst)))
                new[key] = dst
            elif is_sharded(p) and saved.shape(k) == tuple(p.shape):
                new[key] = dtensor_like(saved.get(k, _region(p)), p)
            else:
                new[key] = saved.get(k).to(device=local(p).device, copy=True)
        opt.state[p] = new


def export_release_dir(out_dir: str, ae: nn.Module | None = None,
                       head: nn.Module | None = None,
                       projector: nn.Module | None = None,
                       configs: dict[str, dict] | None = None,
                       dtype: torch.dtype | None = torch.float32) -> None:
    """Write the release layout: ae.safetensors, vision_head.safetensors,
    projector.safetensors and ``configs`` as ``<name>.json``. Floating
    tensors are written as ``dtype`` (fp32, as the JAX package exports; None
    keeps each module's dtype, e.g. bf16 as the released shards are)."""
    os.makedirs(out_dir, exist_ok=True)
    for name, module in (("ae", ae), ("vision_head", head),
                         ("projector", projector)):
        if module is not None:
            save_file(module.state_dict(),
                      os.path.join(out_dir, f"{name}.safetensors"), dtype=dtype)
    for name, cfg in (configs or {}).items():
        with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
            json.dump(cfg, f, indent=2)


def export_hf_qwen3(llm: nn.Module, out_dir: str) -> None:
    """Write a Qwen3Model (unquantized) as an HF Qwen3 checkpoint:
    model.safetensors in fp32 and config.json."""
    os.makedirs(out_dir, exist_ok=True)
    save_file(llm.state_dict(), os.path.join(out_dir, "model.safetensors"),
              dtype=torch.float32)
    c = llm.cfg
    cfg_json = {
        "architectures": ["Qwen3ForCausalLM"],
        "model_type": "qwen3",
        "vocab_size": c.vocab_size,
        "hidden_size": c.hidden_size,
        "intermediate_size": c.intermediate_size,
        "num_hidden_layers": c.num_hidden_layers,
        "num_attention_heads": c.num_attention_heads,
        "num_key_value_heads": c.num_key_value_heads,
        "head_dim": c.head_dim,
        "rms_norm_eps": c.rms_norm_eps,
        "rope_theta": c.rope_theta,
        "tie_word_embeddings": c.tie_word_embeddings,
    }
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(cfg_json, f, indent=2)
