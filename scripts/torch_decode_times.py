#!/usr/bin/env python3
"""Time the PyTorch port's two decode-attention wrappers (kernels #1 and #6)
at chip_smoke.py's three decode windows, on one NVIDIA GPU: eager (CUDA
events over 50 calls), device-only (calls captured in a CUDA graph) and the
host time of one call, for the bf16 caches and the int8 fused buffer.

    python3 scripts/torch_decode_times.py [--root DIR]

``--root`` puts another checkout's ``bitdance_tpu_torch`` first on sys.path
(default: this one), so that one run can time two trees in turns (parent,
change, change, parent); only the wrappers' common signature is used, and
the inputs and timers are chip_smoke.py's. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(REPO),
                    help="checkout whose bitdance_tpu_torch is timed")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch

    if not torch.cuda.is_available():
        print("torch_decode_times: no CUDA device", file=sys.stderr)
        return 2
    import bitdance_tpu_torch
    from bitdance_tpu_torch.ops import _cuda

    _cuda.load()
    dev = torch.device("cuda")
    sh = smoke.DECODE_SHAPE
    b, s, hq, hkv, d, L = sh["b"], sh["s"], sh["hq"], sh["hkv"], sh["d"], smoke.DECODE_L
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((b, s, hq, d), generator=g, device=dev).bfloat16()
    k = torch.randn((b, hkv, L, d), generator=g, device=dev).bfloat16()
    v = torch.randn((b, hkv, L, d), generator=g, device=dev).bfloat16()
    kv_start = torch.tensor([0, 50], dtype=torch.int32, device=dev)
    out = {}
    with torch.no_grad():
        for fmt in ("bf16", "int8"):
            bufs = smoke._decode_buffers(fmt, k, v)
            for name, n in smoke.DECODE_WINDOWS.items():
                kv_len = torch.full((b,), n, dtype=torch.int32, device=dev)
                kernel = smoke._decode_fns(fmt, q, bufs, kv_len, kv_start)[0]
                out[f"{fmt} {name}"] = {"ms": smoke.cuda_time_ms(kernel, 50),
                                        "device_ms": smoke.cuda_graph_time_ms(kernel),
                                        "host_us": smoke.host_us(kernel)}
    print(json.dumps({"package": bitdance_tpu_torch.__file__,
                      "card": smoke.card_line(), "times": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
