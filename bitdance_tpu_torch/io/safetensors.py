"""The safetensors file format, read and written directly.

A file is an 8-byte little-endian header length N, a JSON header of N bytes
({name: {"dtype", "shape", "data_offsets": [begin, end]}, optional
"__metadata__"}), then the raw little-endian buffers, offsets counted from
the end of the header. The released BitDance shards are bf16, which numpy
has no type for, and the card's machine has no ``safetensors`` package, so
the port reads the bytes into torch tensors itself: a file is memory-mapped
(copy on write) and each tensor is a view of the mapping, so a 3 GB shard
costs no read until a tensor is used.
"""

from __future__ import annotations

import json
import mmap
import struct
from pathlib import Path

import torch

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
CODES = {v: k for k, v in DTYPES.items()}


def read_header(path) -> tuple[dict, int]:
    """(header dict without "__metadata__", byte offset of the buffers)."""
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def load_file(path) -> dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, as CPU tensors viewing a
    copy-on-write memory map of the file (writes stay private)."""
    header, base = read_header(path)
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    out = {}
    for name, info in header.items():
        dtype = DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which "
                             "the port does not read")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        item = torch.empty((), dtype=dtype).element_size()
        count = (end - begin) // item
        if count * item != end - begin or count != _numel(shape):
            raise ValueError(f"{path}: {name} holds {end - begin} bytes for "
                             f"{info['dtype']} {list(shape)}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        if (base + begin) % item:
            # a misaligned buffer is copied into an aligned one
            raw = torch.frombuffer(mm, dtype=torch.uint8, count=end - begin,
                                   offset=base + begin)
            out[name] = raw.clone().view(dtype).reshape(shape)
        else:
            out[name] = torch.frombuffer(mm, dtype=dtype, count=count,
                                         offset=base + begin).reshape(shape)
    return out


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def save_file(tensors: dict[str, torch.Tensor], path,
              dtype: torch.dtype | None = None) -> None:
    """Write ``tensors`` (any device) as a safetensors file, floating ones
    cast to ``dtype`` when given. Each tensor is cast and copied to the host
    as it is written, so the host never holds more than one. The buffers
    are packed without gaps, as the format requires, widest element type
    first (then by name), so each buffer is aligned to its element size."""

    def out_dtype(t):
        return dtype if dtype is not None and t.is_floating_point() else t.dtype

    def size(t):
        return torch.empty((), dtype=out_dtype(t)).element_size()

    header: dict = {}
    offset, names = 0, sorted(tensors, key=lambda k: (-size(tensors[k]), k))
    for name in names:
        t = tensors[name]
        if out_dtype(t) not in CODES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors code")
        nbytes = t.numel() * size(t)
        header[name] = {"dtype": CODES[out_dtype(t)], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    # the buffers follow an 8-byte aligned header (padded with spaces)
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-(8 + len(blob)) % 8)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in names:
            t = tensors[name]
            if t.numel():
                host = t.detach().to(out_dtype(t)).to("cpu").contiguous().reshape(-1)
                f.write(host.view(torch.uint8).numpy().data)
