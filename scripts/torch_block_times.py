#!/usr/bin/env python3
"""Time the per-call head kernels on one NVIDIA GPU: the MLP block #14
(``fused_mlp_block``), the attention block #15 (``fused_attn_block``), the
whole net #5 (``fused_diffnet_forward``), the tokenizer's encode tail #13
(``fused_encode_tail``), and the unguided ImageNet batches that run the head
kernels; prints one JSON line.

For the random bf16 BitDance-H-1x and BitDance-B-16x samplers of
chip_smoke.py:
- #14 at H-1x's unguided 8 rows (C 1280) and B-16x's 512 (32 windows of 16,
  C 768), block 0 again and again (its 14.75 / 5.3 MB of weights stay in
  L2): eager (CUDA events, the least of 3 runs), device-only (a captured
  CUDA graph) and host us a call (the least of 5 runs); where the tree has
  the switch, each of ``_pdl`` 0 (no launch programmatic), 1 (the products)
  and 2 (the LN too); launches a call (captured); then a walk over every
  block's weights in turn (cold L2, as the per-call route finds them), eager
  and device-only a call; the bound;
- each #14 product on the head GEMM where the tree has its modes, over every
  block's weights in turn (cold L2), device-only, beside ``torch.matmul`` at
  the same shape, and the bound;
- #15 at B-16x's unguided 512 rows (32 windows of 16, C 768, 12 heads) and
  its guided 1024 (64 x 16, cfg_mult 2): eager, device-only and host us a
  call, block 0 again and again (warm L2) and a walk over the 6 blocks'
  weights (cold L2), each ``_pdl`` setting where the tree has the switch,
  launches a call (captured), and each launch's device us a call from a
  profile of 50 calls launched without PDL (a programmatic kernel's span
  holds its wait); the bound;
- #5 at H-1x 8 and 64 rows and B-16x 32 x 16: eager, device-only and host us
  a call as above, without PDL where the tree has the switch, launches a
  call (captured), the bound (chip_smoke.net_bound);
- #13 at the tokenizer trunk's three shapes (C 1024 at 256, 512 and 1024
  px, bf16; chip_smoke.phase_encode_kernel's inputs): eager and device-only
  a call, launches a call (captured) and each launch's device us from a
  profile (the second launch's span holds its wait where it is
  programmatic); the bound;
- unless ``--skip-e2e``, the unguided batches of ``--e2e`` (8 H-1x images
  and 32 B-16x images, ``--steps`` sampling steps, cfg 1) through
  ``sample`` and the VQ decoder on the per-call route (#14, #15) and with
  every net call through #5: s/batch; with ``--profile`` also the per-call route's profile (device
  busy and idle share, kernel time by group; ~130 s for the H-1x batch).

    python3 scripts/torch_block_times.py [--root DIR] [--skip-e2e] [--profile]
        [--steps N] [--e2e h1x,b16x]
        [--kernels mlp_block,attn_block,fused_net,encode_tail]

``--root`` puts another checkout's ``bitdance_tpu_torch`` first on sys.path
(default: this one), so that one run can time two trees in turns (parent,
change, change, parent); the inputs, timers and bounds are this checkout's
chip_smoke.py's.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import re
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def _eager_ms(smoke, fn, iters: int, trials: int = 3) -> float:
    return min(smoke.cuda_time_ms(fn, iters, warmup=5) for _ in range(trials))


def _mlp_block(smoke, fb, bundle, norm_of, rows, dev, seed) -> dict:
    import torch

    stacked, blocks = bundle.head_stacked, bundle.head.net.res_blocks
    g = torch.Generator(device=dev).manual_seed(seed)
    c, h = blocks[0].w2.weight.shape
    x, ada = smoke._block_inputs(g, (rows,), c, dev)
    mods = ada.bfloat16().chunk(3, dim=-1)

    def weights(b):
        return (norm_of(b).weight, norm_of(b).bias, b.w1.weight, b.w1.bias, b.w2.weight,
                b.w2.bias)

    args = (x, *mods, *weights(blocks[0]))
    run = lambda **o: fb.fused_mlp_block(*args, **o)  # noqa: E731
    walk = lambda: [fb.fused_mlp_block(x, *mods, *weights(b)) for b in blocks]  # noqa: E731
    out = {}
    with torch.no_grad():
        out["ms"] = _eager_ms(smoke, run, 200)
        out["device_ms"] = smoke.cuda_graph_time_ms(run)
        out["host_us"] = smoke.host_us(run, trials=5)
        if "_pdl" in inspect.signature(fb.fused_mlp_block).parameters:
            for pdl in (0, 1, 2):
                out[f"pdl{pdl}_ms"] = _eager_ms(smoke, lambda: run(_pdl=pdl), 200)
                out[f"pdl{pdl}_device_ms"] = smoke.cuda_graph_time_ms(lambda: run(_pdl=pdl))
        out["launches"] = smoke._captured_kernels(run)
        out["cold_ms"] = _eager_ms(smoke, walk, 20) / len(blocks)
        out["cold_device_ms"] = smoke.cuda_graph_time_ms(walk, calls=2, reps=3) / len(blocks)
    out.update(smoke.roofline(smoke.nbytes(x, x, *mods, *weights(blocks[0])),
                              6.0 * rows * c * h))
    out["products"] = _products(smoke, stacked, rows, dev, seed + 1)
    return out


def _products(smoke, stacked, rows, dev, seed) -> dict:
    import torch

    from bitdance_tpu_torch.ops import fused_head

    if "swiglu_h32" not in getattr(fused_head, "HEAD_GEMM_MODES", {}):
        return {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    with torch.no_grad():
        for key in ("w1", "w2"):
            mode = smoke.MLP_BLOCK_PRODUCTS[key][0]
            n, k = stacked[key].shape[1:]
            blocks = stacked[key].shape[0]
            a, kw = smoke._head_gemm_operands(stacked, key, rows, g, dev,
                                              smoke.MLP_BLOCK_PRODUCTS)
            plan = fused_head.head_gemm_plan(rows, n, k, sms)
            walk = smoke.head_gemm_walk(stacked, key, a, kw, plan, smoke.MLP_BLOCK_PRODUCTS)
            lib = smoke.matmul_walk(stacked, key, a)
            out[key] = {"mode": mode, "plan": list(plan),
                        "device_ms": smoke.cuda_graph_time_ms(walk, calls=4, reps=3) / blocks,
                        "library_device_ms": smoke.cuda_graph_time_ms(lib, calls=4,
                                                                      reps=3) / blocks,
                        **smoke.head_gemm_bound(a, stacked[key][0], mode, kw)}
    return out


def _launch_us(run, calls: int = 50) -> dict:
    """Device us a call of each kernel that ``run`` launches: torch.profiler
    over ``calls`` calls, each kernel's spans summed by name (its name up to
    with its template arguments, without its namespaces)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        name = re.search(r"(\w+(?:<[^()]*>)?)\(", re.sub(r"\(anonymous namespace\)::|\w+::",
                                                       "", e.name))
        name = name.group(1) if name else e.name
        out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / calls
    return out


def _attn_block(smoke, fb, bundle, groups, dev, seed) -> dict:
    import torch

    blocks = bundle.head.net.res_blocks
    g = torch.Generator(device=dev).manual_seed(seed)
    c = blocks[0].attn.wo.weight.shape[0]
    x, ada = smoke._block_inputs(g, (groups, 16), c, dev)
    mods = ada.bfloat16().chunk(3, dim=-1)

    def weights(b):
        a = b.attn
        return (b.norm1.weight, b.norm1.bias, a.wqkv.weight, a.wqkv.bias, a.wo.weight,
                a.wo.bias, a.n_head)

    args = (x, *mods, *weights(blocks[0]))
    has_pdl = "_pdl" in inspect.signature(fb.fused_attn_block).parameters
    run = lambda **o: fb.fused_attn_block(*args, **o)  # noqa: E731
    walk = lambda: [fb.fused_attn_block(x, *mods, *weights(b)) for b in blocks]  # noqa: E731
    out = {}
    with torch.no_grad():
        out["ms"] = _eager_ms(smoke, run, 200)
        out["device_ms"] = smoke.cuda_graph_time_ms(run)
        out["host_us"] = smoke.host_us(run, trials=5)
        if has_pdl:
            for pdl in (0, 1, 2):
                out[f"pdl{pdl}_ms"] = _eager_ms(smoke, lambda: run(_pdl=pdl), 200)
                out[f"pdl{pdl}_device_ms"] = smoke.cuda_graph_time_ms(lambda: run(_pdl=pdl))
        out["launches"] = smoke._captured_kernels(run)
        out["cold_ms"] = _eager_ms(smoke, walk, 20) / len(blocks)
        out["cold_device_ms"] = smoke.cuda_graph_time_ms(walk, calls=2, reps=3) / len(blocks)
        out["launch_us"] = _launch_us(lambda: run(_pdl=0) if has_pdl else run())
    rows = x.shape[0] * x.shape[1]
    out.update(smoke.roofline(smoke.nbytes(x, x, *mods, *weights(blocks[0])[:6]),
                              8.0 * rows * c * c + 4.0 * rows * 16 * c))
    return out


def _encode_tail(smoke, fe, dev) -> dict:
    import torch

    out = {}
    for name, shape in (("256px", (8, 16, 16, 1024)), ("512px", (8, 32, 32, 1024)),
                        ("1024px", (2, 64, 64, 1024))):
        args = smoke._encode_case(shape, torch.bfloat16, dev, sum(shape))
        run = lambda: fe.fused_encode_tail(*args)  # noqa: E731
        x = args[0]
        n_px = x.numel() // x.shape[-1]
        out[name] = {"ms": _eager_ms(smoke, run, 50),
                     "device_ms": smoke.cuda_graph_time_ms(run),
                     "launches": smoke._captured_kernels(run),
                     "launch_us": _launch_us(run),
                     **smoke.roofline(smoke.nbytes(x, args[3]) + n_px * 32 * x.element_size(),
                                      2.0 * n_px * x.shape[-1] * 32)}
    return out


def _net(smoke, fh, bundle, lead, dev, seed) -> dict:
    import torch

    head, stacked = bundle.head, bundle.head_stacked
    attention = head.attention
    kw = dict(num_blocks=head.depth_latent, num_ada=head.depth_adanln,
              n_head=head.ch_latent // head.attn_head_dim if attention else 0,
              attention=attention, bounded=head.bounded)
    x, t, _, _, c_emb = smoke._net_inputs(head, stacked, lead, dev, seed)
    run = lambda **o: fh.fused_diffnet_forward(stacked, x, t, c_emb, **kw, **o)  # noqa: E731
    out = {}
    with torch.no_grad():
        out["ms"] = _eager_ms(smoke, run, 100)
        out["device_ms"] = smoke.cuda_graph_time_ms(run, calls=10, reps=3)
        out["host_us"] = smoke.host_us(run, calls=50, trials=5)
        if "_pdl" in inspect.signature(fh.fused_diffnet_forward).parameters:
            out["no_pdl_ms"] = _eager_ms(smoke, lambda: run(_pdl=False), 100)
            out["no_pdl_device_ms"] = smoke.cuda_graph_time_ms(lambda: run(_pdl=False),
                                                               calls=10, reps=3)
        out["launches"] = smoke._captured_kernels(run)
    out.update(smoke.net_bound(stacked, x, t, c_emb, attention=attention,
                               groups=lead[0] if attention else 1,
                               window=lead[1] if attention else 1))
    return out


def _e2e(smoke, bundle, n, steps, profile: bool) -> dict:
    out = {}
    r = smoke._imagenet_run(bundle, n, 1.0, 1, steps)
    out["per_call"] = {"s_per_batch": r["s"], "ok": r["ok"], "sampler_s": r["timing"]["sampler"],
                       "counts": {k: v for k, v in r["counts"].items() if v}}
    r = smoke._imagenet_run(bundle, n, 1.0, 1, steps,
                            head_sampler=smoke.fused_net_sampler(bundle.head,
                                                                 bundle.head_stacked))
    out["fused_net"] = {"s_per_batch": r["s"], "ok": r["ok"],
                        "sampler_s": r["timing"]["sampler"],
                        "counts": {k: v for k, v in r["counts"].items() if v}}
    if profile:
        out["per_call_profile"] = smoke.profile_run(
            "block_times", f"{n} images unguided, {steps} sampling steps, per-call route",
            lambda: smoke._imagenet_run(bundle, n, 1.0, 2, steps))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(REPO),
                    help="checkout whose bitdance_tpu_torch is timed")
    ap.add_argument("--skip-e2e", action="store_true", help="kernels only")
    ap.add_argument("--profile", action="store_true",
                    help="profile the per-call route's unguided batches")
    ap.add_argument("--steps", type=int, default=25,
                    help="sampling steps of the unguided batches")
    ap.add_argument("--e2e", default="h1x,b16x",
                    help="comma-separated heads whose unguided batch is run")
    ap.add_argument("--kernels", default="mlp_block,attn_block,fused_net,encode_tail",
                    help="comma-separated kernels to time")
    args = ap.parse_args()
    kernels = set(args.kernels.split(","))
    sys.path.insert(0, str(Path(args.root).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch

    if not torch.cuda.is_available():
        print("torch_block_times: no CUDA device", file=sys.stderr)
        return 2
    import bitdance_tpu_torch
    from bitdance_tpu_torch.ops import _cuda, fused_block, fused_encode, fused_head
    from bitdance_tpu_torch.utils.precision import full_fp32

    full_fp32()
    _cuda.load()
    dev = torch.device("cuda")
    out = {"package": bitdance_tpu_torch.__file__, "card": smoke.card_line()}
    if "encode_tail" in kernels:
        out["encode_tail"] = _encode_tail(smoke, fused_encode, dev)
    if kernels == {"encode_tail"} and args.skip_e2e:
        print(json.dumps(out))
        return 0
    h1x, b16x = smoke.build_imagenet_samplers()
    if "mlp_block" in kernels:
        out["mlp_block"] = {
            "h1x_8": _mlp_block(smoke, fused_block, h1x, lambda b: b.norm,
                                smoke.UNGUIDED_H1X_IMAGES, dev, 11),
            "b16x_512": _mlp_block(smoke, fused_block, b16x, lambda b: b.norm2,
                                   smoke.IMAGENET_BATCH * 16, dev, 12)}
    if "attn_block" in kernels:
        out["attn_block"] = {
            "b16x_512": _attn_block(smoke, fused_block, b16x, smoke.IMAGENET_BATCH, dev, 13),
            "b16x_1024": _attn_block(smoke, fused_block, b16x, 2 * smoke.IMAGENET_BATCH,
                                     dev, 14)}
    if "fused_net" in kernels:
        out["fused_net"] = {
            "h1x_8": _net(smoke, fused_head, h1x, (smoke.UNGUIDED_H1X_IMAGES,), dev, 21),
            "h1x_64": _net(smoke, fused_head, h1x, (2 * smoke.IMAGENET_BATCH,), dev, 22),
            "b16x_512": _net(smoke, fused_head, b16x, (smoke.IMAGENET_BATCH, 16), dev, 23)}
    if not args.skip_e2e:
        runs = {"h1x": (h1x, smoke.UNGUIDED_H1X_IMAGES), "b16x": (b16x, smoke.IMAGENET_BATCH)}
        out["unguided"] = {k: _e2e(smoke, *runs[k], args.steps, args.profile)
                           for k in args.e2e.split(",")}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
