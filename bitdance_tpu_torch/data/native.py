"""The native tar indexer, built at first use and bound with ctypes (port of
bitdance_tpu/data/native.py).

``csrc/tar_index.cpp`` walks the nested ImageNet tar's headers in C++ for
the one-time (offset, size, label) index. ``g++`` builds it into
``build/`` at the root of the checkout, named by a hash of the source and
flags, on the first call that needs it. Failures raise: the caller that
wants the Python walk asks for it (data/imagenet.py::build_flat_index with
``native=False``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
from pathlib import Path

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "tar_index.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"libbd_tar_index_{h.hexdigest()[:12]}.so"


def load() -> ctypes.CDLL:
    """The indexer library, built first if this source has no build yet."""
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        try:
            res = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                                 capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"the native tar indexer needs g++: {e}") from e
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed to build {SOURCE}:\n{res.stderr[-3000:]}")
        os.replace(tmp, so)                     # atomic: concurrent builds agree
    lib = ctypes.CDLL(str(so))
    lib.bd_build_tar_index.restype = ctypes.c_int64
    lib.bd_build_tar_index.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    _lib = lib
    return lib


def build_tar_index_native(tar_path: str, idx_path: str):
    """(entries, class names) of the nested tar: entries [(offset, size,
    class index)] as build_flat_index gives them, classes sorted. The
    binary index goes to ``idx_path + ".bdix"``. Raises if the library
    cannot be built or the scan fails."""
    bin_path = idx_path + ".bdix"
    os.makedirs(os.path.dirname(os.path.abspath(bin_path)), exist_ok=True)
    n = load().bd_build_tar_index(os.fsencode(tar_path), os.fsencode(bin_path))
    if n < 0:
        raise RuntimeError(f"native tar index of {tar_path} failed (code {n}: "
                           "-1 open, -2 read, -3 write)")
    return read_bdix(bin_path)


def read_bdix(path: str):
    """Parse the BDIX1 binary index into (entries, class_names)."""
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic[:5] != b"BDIX1":
            raise ValueError(f"{path}: bad index magic {magic!r}")
        n, nc = struct.unpack("<qq", f.read(16))
        raw = f.read(n * 24)
        entries = [struct.unpack_from("<qqq", raw, i * 24) for i in range(n)]
        classes = []
        for _ in range(nc):
            (ln,) = struct.unpack("<h", f.read(2))
            classes.append(f.read(ln).decode())
    return entries, classes
