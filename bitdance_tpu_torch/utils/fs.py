"""Filesystem layer: local and hdfs:// paths, download with a cache, and the
process layout (port of bitdance_tpu/utils/fs.py).

hdfs:// paths go through ``hdfs dfs`` subprocesses; local paths through
os and shutil. :func:`init_distributed` reads the launcher's RANK and
WORLD_SIZE. The port runs one process: a world above 1 raises until
multi-process training is ported (ROADMAP A11).
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
    rank, _ = init_distributed()
    if rank == 0:
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


def init_distributed() -> tuple[int, int]:
    """(rank, world size) from the launcher's RANK and WORLD_SIZE; (0, 1)
    without them. A world above 1 raises: the port's trainers run one
    process until multi-process training is ported (ROADMAP A11)."""
    rank = int(os.environ.get("RANK", 0))
    world = int(os.environ.get("WORLD_SIZE", 1))
    if world > 1:
        raise NotImplementedError(
            f"WORLD_SIZE={world}: the port runs one process; multi-process "
            "training is not ported (ROADMAP A11)")
    return rank, world
