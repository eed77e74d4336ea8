"""Device mesh and FSDP sharding (port of bitdance_tpu/parallel/mesh.py).

The JAX package names a mesh ("replica", "fsdp", "tp") and lets GSPMD insert
the collectives: "fsdp" shards parameters ZeRO-3 style, "replica" replicates
them (HYBRID_SHARD's replicate group), and the batch is sharded over every
axis, replica-major. The port builds the same mesh as a
``torch.distributed.device_mesh.DeviceMesh`` and puts a model under FSDP2
(``torch.distributed.fsdp.fully_shard``): one unit for each decoder layer and
each head block, plus the root, sharded over "fsdp" and replicated over
"replica" (HSDP on a 2-D mesh). Each parameter is sharded on the dimension
the JAX rule picks (:func:`shard_dim`); the moments and the EMA are sharded
like their parameters (:func:`shard_train_state`). On a mesh with "tp" > 1
a model is tensor-parallel first (parallel/tp.py, over :func:`tp_group`)
and FSDP2 then shards its TP-local parameters over ("replica", "fsdp"):
torch's 2-D recipe.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist
from torch import nn

from bitdance_tpu_torch.utils.dtensor import shard_like

MESH_AXES = ("replica", "fsdp", "tp")
MIN_SHARD_SIZE = 2 ** 14


def create_mesh(replica: int = 1, fsdp: int | None = None, tp: int = 1,
                device_type: str = "cuda"):
    """A (replica, fsdp, tp) DeviceMesh over the processes of the default
    group (started by ``utils/fs.py::init_distributed`` when none is; ranks
    that share one card start it over gloo themselves first):
    ``fsdp`` defaults to what the other axes leave, and the axes must
    multiply to the world size, as in the JAX package (which asserts it).
    Ranks are laid out tp-minor, so a tp group is consecutive ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    from bitdance_tpu_torch.utils.fs import init_distributed

    if not dist.is_initialized():
        init_distributed(device_type)
    n = dist.get_world_size()
    if fsdp is None:
        fsdp = n // (replica * tp)
    if replica * fsdp * tp != n:
        raise ValueError(f"mesh {replica}x{fsdp}x{tp} != {n} devices")
    return init_device_mesh(device_type, (replica, fsdp, tp), mesh_dim_names=MESH_AXES)


def shard_dim(shape: Sequence[int], fsdp_size: int, min_size: int = MIN_SHARD_SIZE,
              start: int = 0) -> int | None:
    """The JAX FSDP rule: None (replicate) under ``min_size`` elements or
    with one shard, else the largest axis from ``start`` on that the fsdp
    size divides (the first of equal ones), else None."""
    if math.prod(shape) < min_size or fsdp_size == 1:
        return None
    for d in sorted(range(start, len(shape)), key=lambda d: -shape[d]):
        if shape[d] % fsdp_size == 0:
            return d
    return None


def fsdp_partition_spec(path_str: str, shape: Sequence[int], fsdp_size: int,
                        min_size: int = MIN_SHARD_SIZE) -> tuple:
    """The JAX function's answer as a tuple: () to replicate, else one entry
    per axis, "fsdp" on the sharded one. A stacked per-layer tensor ("layers"
    in the path, more than one axis) never shards its leading layer axis."""
    start = 1 if ("layers" in path_str and len(shape) > 1) else 0
    d = shard_dim(shape, fsdp_size, min_size, start)
    if d is None:
        return ()
    return tuple("fsdp" if i == d else None for i in range(len(shape)))


def data_size(mesh) -> int:
    """Processes that take distinct rows: the replica and fsdp axes."""
    return mesh.size(0) * mesh.size(1)


def data_index(mesh) -> int:
    """This process's place among them, replica-major (the JAX package's
    batch sharding P(MESH_AXES))."""
    r, f, _ = mesh.get_coordinate()
    return r * mesh.size(1) + f


def batch_rows(mesh, global_batch: int) -> slice:
    """This process's rows of a global batch (the counterpart of
    ``batch_sharding``)."""
    n = data_size(mesh)
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} does not split over {n} "
                         "data shards")
    per = global_batch // n
    i = data_index(mesh)
    return slice(i * per, (i + 1) * per)


def fsdp_units(model: nn.Module) -> list[nn.Module]:
    """The modules that become FSDP units of their own: every Qwen3 and
    ImageNet AR decoder layer and every diffusion-head block."""
    from bitdance_tpu_torch.models.diff_head import MlpResBlock, TransBlock
    from bitdance_tpu_torch.models.imagenet_ar import Layer
    from bitdance_tpu_torch.models.qwen3 import Qwen3DecoderLayer

    kinds = (Qwen3DecoderLayer, Layer, TransBlock, MlpResBlock)
    return [m for m in model.modules() if isinstance(m, kinds)]


def tp_group(mesh):
    """This process's :class:`~bitdance_tpu_torch.parallel.tp.TPGroup` on
    the mesh's "tp" axis (size 1, no process group, when the axis is 1)."""
    from bitdance_tpu_torch.parallel.tp import TPGroup

    size = mesh.size(2)
    if size == 1:
        return TPGroup()
    return TPGroup(mesh.get_local_rank("tp"), size, mesh.get_group("tp"))


def shard_model(model: nn.Module, mesh, param_dtype: torch.dtype | None = None) -> nn.Module:
    """Put ``model`` under FSDP2 in place over the mesh's (replica, fsdp)
    axes: each of :func:`fsdp_units`, then the root with the parameters
    left. On a mesh with tp > 1 the parameters are the model's TP-local
    ones (shard it with parallel/tp.py first), each rank's FSDP group the
    ranks of its tp coordinate. Each parameter is sharded on :func:`shard_dim`
    of its shape. FSDP2 cannot keep a tensor whole inside a unit, so where
    the JAX rule replicates (small or indivisible tensors) it is sharded on
    dim 0 with FSDP2's padding. ``param_dtype`` is the dtype the forward and
    backward compute in (the fp32 masters cast as ``.to`` casts them);
    gradients are reduced in fp32 and inputs are not cast."""
    from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard
    from torch.distributed.tensor import Shard

    fsdp_size = mesh.size(1)

    def placement(p: nn.Parameter):
        d = shard_dim(tuple(p.shape), fsdp_size)
        return Shard(0 if d is None else d)

    kw = dict(mesh=mesh["replica", "fsdp"], shard_placement_fn=placement,
              mp_policy=MixedPrecisionPolicy(param_dtype=param_dtype,
                                             reduce_dtype=torch.float32,
                                             cast_forward_inputs=False))
    for unit in fsdp_units(model):
        fully_shard(unit, **kw)
    fully_shard(model, **kw)
    return model


def shard_train_state(state, mesh, param_dtype: torch.dtype | None = None):
    """A TrainState (train/optim.py) under FSDP2 on ``mesh``: the model put
    under :func:`shard_model`, its AdamW rebuilt over the sharded parameters
    (count, learning rates and any moments carried over, sharded like their
    parameters; the clip's norm reduced over the fsdp axis), the EMA sharded
    like the parameters. The old state's optimizer must not be used after."""
    from bitdance_tpu_torch.train.optim import TrainState

    tx = state.tx
    saved = {n: dict(tx.opt.state.get(p, {})) for n, p in zip(tx.names, tx.params)}
    lrs = [g["lr"] for g in tx.opt.param_groups]
    shard_model(state.model, mesh, param_dtype)
    named = dict(state.model.named_parameters())
    group = mesh.get_group("fsdp") if mesh.size(1) > 1 else None
    new_tx = tx.rebind(named, norm_group=group)
    new_tx.count = tx.count
    for g, lr in zip(new_tx.opt.param_groups, lrs):
        g["lr"] = lr
    for name, entries in saved.items():
        p = named[name]
        if entries:
            new_tx.opt.state[p] = {
                k: shard_like(v, p) if v.shape == p.shape and v.ndim else v
                for k, v in entries.items()}
    ema = (None if state.ema is None
           else {n: shard_like(state.ema[n], named[n]) for n in named})
    return TrainState(model=state.model, tx=new_tx, ema=ema, step=state.step)


def all_reduce_mean(values: dict[str, torch.Tensor], mesh) -> dict[str, torch.Tensor]:
    """Means over the data shards of 0-d metrics (one all-reduce); as they
    are with one shard."""
    n = data_size(mesh)
    if n == 1 or not values:
        return values
    keys = list(values)
    buf = torch.stack([values[k].float() for k in keys])
    dist.all_reduce(buf)
    buf = buf / n
    return dict(zip(keys, buf.unbind(0)))
