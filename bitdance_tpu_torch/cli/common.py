"""What the command lines share: the device check, the frozen tokenizer at
the ImageNet commands' width (scripts/train_imagenet.py:131-132 and
scripts/sample_fid.py of the JAX package), and a PNG writer and reader (the
card's machine has no imaging package)."""

from __future__ import annotations

import re
import struct
import zlib

import numpy as np
import torch

# the ImageNet tokenizer of the training and sampling commands; z_channels
# comes from --latent-dim
TOKENIZER_DDCONFIG = dict(in_channels=3, out_ch=3, ch=256, ch_mult=[1, 1, 2, 2, 4],
                          num_res_blocks=4)


def require_device(name: str) -> torch.device:
    """The device a command runs on; a CUDA device without a card raises
    (the commands never fall back to the CPU)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available "
                         "(pass --device cpu to run on the CPU)")
    return device


def imagenet_tokenizer(latent_dim: int, trained_vae: str, device: torch.device,
                       dtype: torch.dtype = torch.float32, *, encoder: bool,
                       seed: int = 0):
    """The frozen VQ tokenizer's encoder (``encoder=True``) or decoder:
    from a reference ae safetensors file when ``trained_vae`` is given
    (the other half's keys are skipped), else drawn with the flax-default
    init from ``seed``."""
    from bitdance_tpu_torch.io.release import load_safetensors, load_state_
    from bitdance_tpu_torch.models.tokenizer import VQModel, init_vq

    dd = dict(TOKENIZER_DDCONFIG, z_channels=latent_dim)
    if not trained_vae:
        gen = torch.Generator(device=device).manual_seed(seed)
        return init_vq(dd, device, dtype, gen, encoder=encoder, decoder=not encoder)
    other = "decoder" if encoder else "encoder"
    with torch.device("meta"):
        ae = VQModel(dd, dtype=dtype, encoder=encoder, decoder=not encoder)
    ae = ae.to_empty(device=device)
    load_state_(ae, load_safetensors(trained_vae), ignore=(re.compile(rf"^{other}\."),))
    return ae.eval().requires_grad_(False)


# Pillow's encoder settings, which png_bytes reproduces: zlib level 6,
# memLevel 9, the Z_FILTERED strategy, and IDAT chunks of ImageFile.MAXBLOCK
# bytes (or 4 bytes a pixel of one row, when that is more)
PNG_ZLIB = (6, zlib.DEFLATED, 15, 9, zlib.Z_FILTERED)
PNG_IDAT_BYTES = 65536


def png_bytes(image: np.ndarray) -> bytes:
    """uint8 RGB [H, W, 3] -> the 8-bit truecolor PNG that Pillow's
    ``Image.fromarray(image).save(f, "PNG")`` writes, byte for byte (the JAX
    package's eval harnesses and demo write with Pillow). Each row takes
    Pillow's adaptive filter: of None, Up, Sub and Paeth, in that order of
    preference, the one whose bytes, read as signed, sum to the least
    magnitude."""
    img = np.ascontiguousarray(image, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"png_bytes: want [H, W, 3] uint8, got {img.shape}")
    h, w, _ = img.shape
    x = img.reshape(h, w * 3).astype(np.int16)
    up, left, up_left = np.zeros_like(x), np.zeros_like(x), np.zeros_like(x)
    up[1:], left[:, 3:], up_left[1:, 3:] = x[:-1], x[:, :-3], x[:-1, :-3]
    p = left + up - up_left
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, up_left))
    rows = (np.stack([x, x - up, x - left, x - paeth]) & 0xFF).astype(np.int32)
    pick = np.argmin(np.minimum(rows, 256 - rows).sum(axis=2), axis=0)
    kinds = np.array([0, 2, 1, 4], np.uint8)[pick]
    raw = np.concatenate([kinds[:, None], rows[pick, np.arange(h)].astype(np.uint8)], axis=1)
    z = zlib.compressobj(*PNG_ZLIB)
    data = z.compress(raw.tobytes()) + z.flush()

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    n = max(PNG_IDAT_BYTES, 4 * w)
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + b"".join(chunk(b"IDAT", data[i:i + n]) for i in range(0, len(data), n))
            + chunk(b"IEND", b""))


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters (None, Sub, Up, Average, Paeth) of ``raw``
    [h, 1 + stride] uint8; returns [h, stride] uint8. Sub and Up are
    vectorized; Average and Paeth chain through the left neighbour, so they
    walk the row byte by byte."""
    out = np.zeros((h, stride), np.int64)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        kind, line = int(raw[y, 0]), raw[y, 1:].astype(np.int64)
        if kind == 0:
            cur = line
        elif kind == 1:
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif kind == 2:
            cur = (line + prev) & 0xFF
        elif kind in (3, 4):
            ln, up, row = line.tolist(), prev.tolist(), [0] * stride
            for x in range(stride):
                a = row[x - bpp] if x >= bpp else 0
                b = up[x]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[x - bpp] if x >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                row[x] = (ln[x] + pred) & 0xFF
            cur = np.asarray(row, np.int64)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {kind}")
        out[y] = prev = cur
    return out.astype(np.uint8)


def read_png(path) -> np.ndarray:
    """uint8 RGB [H, W, 3] of an 8-bit truecolor PNG (color type 2, or 6
    with its alpha dropped), non-interlaced, any of the five row filters.
    Raises ValueError on anything else (palette, grey, 16-bit, interlaced,
    a bad CRC)."""
    data = open(path, "rb").read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, header = 8, [], None
    while pos + 12 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in (2, 6) or interlace:
        raise ValueError(f"{path}: depth {depth}, color type {color}, interlace "
                         f"{interlace}; only 8-bit RGB / RGBA, non-interlaced")
    bpp = 3 if color == 2 else 4
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + bpp * w):
        raise ValueError(f"{path}: {raw.size} image bytes, want {h * (1 + bpp * w)}")
    rows = _unfilter(raw.reshape(h, 1 + bpp * w), h, bpp * w, bpp)
    return rows.reshape(h, w, bpp)[..., :3].copy()
