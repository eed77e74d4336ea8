#!/usr/bin/env python3
"""Time the PyTorch port's W4A8 matmul (kernel #16, ``ops/int4.py::
int4_matmul``) on one NVIDIA GPU at the seven projections of one
Qwen3-14B layer (M 128), and the int4 BitDance-14B-64x requests it serves.

    python3 scripts/torch_w4a8_times.py [--root DIR] [--tokens FILE]
                                        [--skip-requests]

Per projection: warm ms (CUDA events over 20 calls of one product) and the
GEMM launch alone where the tree's wrapper takes quantized rows. For the
seven products: warm ms, the GEMM kernels' and the row quantization's
device time (torch.profiler, one session), cold ms (the products in layer
order over chip_smoke.W4A8_COLD_LAYERS layers' packed weights) beside
torch._int_mm on the unpacked int8 weights, and the host time of one
k_proj call. Then (unless --skip-requests) the random full-width
BitDance-14B-64x bundle quantized to int4 (W4A8 Qwen3, int8 KV) serves a
warm-up and the 512 px and 1024 px requests of chip_smoke.E2E_REQUESTS:
s/image and the decode phase. ``--tokens FILE`` holds their +-1 token
grids: written when FILE is missing, else compared with it (the line's
``tokens_equal``).

``--root`` puts another checkout's ``bitdance_tpu_torch`` first on sys.path
(default: this one), so one run can time two trees in turns (parent,
change, change, parent); only ``int4_matmul(x, w)`` and the bundle API
common to both are used, and the inputs and timers are chip_smoke.py's.
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def _profile_split(q4, xs, layer) -> dict:
    """Device ms per seven products of the row quantization and of the GEMM
    kernels (everything else the calls launch), from one profiler session
    over 20 passes."""
    import torch
    from torch.autograd import DeviceType

    def seven():
        for name, w in layer.items():
            q4.int4_matmul(xs[2 * w.q.shape[1]], w)

    seven()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            seven()
        torch.cuda.synchronize()
    quant = gemm = 0.0
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA or getattr(ev, "is_user_annotation", False):
            continue
        us = ev.time_range.elapsed_us()
        if "quantize" in ev.name:      # quantize_rows_kernel, quantize_image_kernel
            quant += us
        else:
            gemm += us
    return {"rowquant_ms": quant / 20e3, "gemm_ms": gemm / 20e3}


def kernel_times(smoke, q4, dev) -> dict:
    import torch

    g = torch.Generator(device=dev).manual_seed(5)
    layer = smoke.w4a8_layers(q4, 1, dev, g)[0]
    xs = {k: torch.randn((128, k), generator=g, device=dev).bfloat16() for k in (5120, 17408)}
    takes_rows = "rows" in inspect.signature(q4.int4_matmul).parameters
    per = {}
    for name, w in layer.items():
        x = xs[2 * w.q.shape[1]]
        row = {"ms": smoke.cuda_time_ms(lambda: q4.int4_matmul(x, w), 20)}
        if takes_rows:
            rows = q4.w4a8_quantize(x)
            row["gemm_ms"] = smoke.cuda_time_ms(lambda: q4.int4_matmul(x, w, rows=rows), 20)
            row["n_splits"] = q4.kernel_splits(128, *smoke.QWEN3_14B_PROJS[name], dev)
        per[name] = row
    seven = {"ms": sum(r["ms"] for r in per.values()),
             **_profile_split(q4, xs, layer),
             **smoke.w4a8_cold(q4, dev, g),
             "host_us_k_proj": smoke.host_us(
                 lambda: q4.int4_matmul(xs[5120], layer["k_proj"]))}
    return {"per_projection": per, "seven": seven}


def requests(smoke, dev, tokens_file: str | None) -> dict:
    import torch

    from bitdance_tpu_torch.io.random_init import build_random_bundle, quantize_bundle_
    from bitdance_tpu_torch.pipelines.t2i import T2IPipeline

    bundle = quantize_bundle_(build_random_bundle("cuda", seed=0), "int4")
    pipe = T2IPipeline(bundle, smoke.StubTokenizer(bundle.parallel_num), kv_int8=True)
    pipe.generate("warm-up", 512, 512, seed=9)
    out, grids = {}, {}
    for prompt, px, seed in (smoke.E2E_REQUESTS[0], smoke.E2E_REQUESTS[2]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, tok = pipe.generate(prompt, px, px, num_sampling_steps=50, guidance_scale=7.5,
                               num_images=1, seed=seed, return_tokens=True)
        out[f"{px}px"] = {"s_per_image": time.perf_counter() - t0,
                          "decode_s": pipe.last_timing.get("decode")}
        grids[f"{px}px"] = torch.from_numpy(tok)
    if tokens_file:
        path = Path(tokens_file)
        if path.exists():
            ref = torch.load(path)
            out["tokens_equal"] = all(torch.equal(ref[k], grids[k]) for k in grids)
        else:
            path.parent.mkdir(parents=True, exist_ok=True)
            torch.save(grids, path)
            out["tokens_equal"] = None
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(REPO),
                    help="checkout whose bitdance_tpu_torch is timed")
    ap.add_argument("--tokens", default=None,
                    help="file of the requests' token grids: written, or compared")
    ap.add_argument("--skip-requests", action="store_true",
                    help="time the kernel only")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch

    if not torch.cuda.is_available():
        print("torch_w4a8_times: no CUDA device", file=sys.stderr)
        return 2
    import bitdance_tpu_torch
    from bitdance_tpu_torch.ops import _cuda
    from bitdance_tpu_torch.ops import int4 as q4
    from bitdance_tpu_torch.utils.precision import full_fp32

    full_fp32()
    _cuda.load()
    dev = torch.device("cuda")
    with torch.no_grad():
        res = {"kernel": kernel_times(smoke, q4, dev)}
        if not args.skip_requests:
            res["requests"] = requests(smoke, dev, args.tokens)
    print(json.dumps({"package": bitdance_tpu_torch.__file__, "card": smoke.card_line(),
                      **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
