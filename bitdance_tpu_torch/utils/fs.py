"""Filesystem layer: local and hdfs:// paths, download with a cache, and the
process layout (port of bitdance_tpu/utils/fs.py).

hdfs:// paths go through ``hdfs dfs`` subprocesses; local paths through
os and shutil. :func:`init_distributed` starts the process group from the
launcher's RANK, WORLD_SIZE and LOCAL_RANK (torchrun), or a group of one
without them.
"""

from __future__ import annotations

import os
import pickle
import shutil
import subprocess
import tempfile
import time


def is_hdfs_path(path: str) -> bool:
    return path.startswith("hdfs://")


def _hdfs(*args: str) -> subprocess.CompletedProcess:
    return subprocess.run(["hdfs", "dfs", *args], capture_output=True,
                          text=True, check=False)


def exists(path: str) -> bool:
    if is_hdfs_path(path):
        return _hdfs("-test", "-e", path).returncode == 0
    return os.path.exists(path)


def listdir(path: str) -> list[str]:
    """Full paths of a directory's entries (sorted for local paths)."""
    if is_hdfs_path(path):
        out = _hdfs("-ls", path)
        files = []
        for line in out.stdout.splitlines():
            parts = line.split()
            if len(parts) >= 8:
                files.append(parts[-1])
        return files
    return [os.path.join(path, p) for p in sorted(os.listdir(path))]


def listdir_with_metafile(path: str, meta_name: str = ".listing.pkl") -> list[str]:
    """:func:`listdir`, cached in a pickle beside a local directory's files
    (a listing this function wrote)."""
    meta = os.path.join(path, meta_name) if not is_hdfs_path(path) else None
    if meta and os.path.exists(meta):
        with open(meta, "rb") as f:
            return pickle.load(f)
    files = listdir(path)
    if meta:
        try:
            with open(meta, "wb") as f:
                pickle.dump(files, f)
        except OSError:
            pass
    return files


def mkdir(path: str) -> None:
    if is_hdfs_path(path):
        _hdfs("-mkdir", "-p", path)
    else:
        os.makedirs(path, exist_ok=True)


def copy(src: str, dst: str) -> None:
    if is_hdfs_path(src) and not is_hdfs_path(dst):
        _hdfs("-get", src, dst)
    elif not is_hdfs_path(src) and is_hdfs_path(dst):
        _hdfs("-put", "-f", src, dst)
    elif is_hdfs_path(src):
        _hdfs("-cp", "-f", src, dst)
    elif os.path.isdir(src):
        shutil.copytree(src, dst, dirs_exist_ok=True)
    else:
        shutil.copy(src, dst)


def remove(path: str) -> None:
    if is_hdfs_path(path):
        _hdfs("-rm", "-r", "-f", path)
    elif os.path.isdir(path):
        shutil.rmtree(path, ignore_errors=True)
    elif os.path.exists(path):
        os.remove(path)


def download(path: str, cache_dir: str | None = None,
             timeout_s: float = 600.0) -> str:
    """A local copy of a remote path (local paths pass through). Rank 0
    copies it into ``cache_dir`` (bitdance_cache under the temporary
    directory by default) and writes a sentinel; other ranks wait for it."""
    if not is_hdfs_path(path):
        return path
    cache_dir = cache_dir or os.path.join(tempfile.gettempdir(), "bitdance_cache")
    os.makedirs(cache_dir, exist_ok=True)
    local = os.path.join(cache_dir, os.path.basename(path))
    done = local + ".done"
    if _rank() == 0:
        if not os.path.exists(done):
            copy(path, local)
            with open(done, "w") as f:
                f.write("ok")
    else:
        start = time.time()
        while not os.path.exists(done):
            if time.time() - start > timeout_s:
                raise TimeoutError(f"waiting for download of {path}")
            time.sleep(1.0)
    return local


def _rank() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", 0))


def init_distributed(device="cuda", init_method: str | None = None,
                     backend: str | None = None,
                     device_index: int | None = None) -> tuple[int, int]:
    """Start the default process group once and return (rank, world size).

    The rank and world come from the launcher's RANK and WORLD_SIZE
    (torchrun); NCCL on ``device`` "cuda" (the device set to LOCAL_RANK
    first), gloo on the CPU. ``backend`` overrides that choice, and
    ``device_index`` the card: several ranks can share one card over gloo
    (``backend="gloo", device_index=0``), which NCCL refuses. ``init_method``
    defaults to torchrun's ``env://`` (MASTER_ADDR, MASTER_PORT); a
    ``file://`` path serves processes on one machine. Without launcher
    variables it starts a group of one from a local store, so the commands
    take their sharded steps on one device, as the JAX scripts do. A group
    above one process returns only after a barrier over it: the group's
    start does not wait for every rank's connections, and a rank that went
    on and left while a peer was still connecting closed that peer's socket
    under it. A world above 1 whose group does not start raises; so does a
    group already started at another world than WORLD_SIZE says, or on
    another backend than ``device`` (or ``backend``) takes."""
    import torch
    import torch.distributed as dist

    world = int(os.environ.get("WORLD_SIZE", 1))
    cuda = torch.device(device).type == "cuda"
    backend = backend or ("nccl" if cuda else "gloo")
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"WORLD_SIZE={world}, but the process group holds "
                               f"{dist.get_world_size()} processes")
        if backend not in str(dist.get_backend()):
            raise RuntimeError(f"device {device} takes {backend}, but the process group "
                               f"runs {dist.get_backend()}")
        return dist.get_rank(), world
    rank = int(os.environ.get("RANK", 0))
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                              if device_index is None else device_index)
    if world == 1 and init_method is None:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
        return 0, 1
    try:
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world)
        dist.barrier(**({"device_ids": [torch.cuda.current_device()]}
                        if backend == "nccl" else {}))
    except (ValueError, RuntimeError) as e:
        raise RuntimeError(f"rank {rank} of {world}: the {backend} process group "
                           f"did not start ({e})") from e
    return rank, world
