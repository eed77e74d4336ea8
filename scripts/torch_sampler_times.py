#!/usr/bin/env python3
"""Time the whole sampler (kernel #2 at the 14B head, kernels #3/#4 at the
ImageNet heads) and, where the tree has it, its head GEMM, on one NVIDIA
GPU; prints one JSON line.

For the random bf16 BitDance-14B-64x bundle of chip_smoke.py (``t2i``):
- one 50-step sampler call at 128 rows (one image, CFG) and at 256, eager
  and device-only, with and without programmatic launches (PDL); the
  launches of one net call (captured); one net call's device time by stage
  (profiled: products, LN, window attention, final layer, input
  projection); the bound of chip_smoke.sampler_bound;
- each block product at 128 rows (qkv also at 256), device-only over the 6
  blocks' weights in turn (cold L2), on the head GEMM where the tree runs
  #2 on it (the planned tiles and splits, 1, 2 and 4 splits, bm 64) and
  torch.matmul at the same shape, with the bound;
- end to end, chip_smoke.phase_e2e: 2 x 512 px and 1 x 1024 px requests,
  s/image and their phases;
- ``em_precompute`` for one AR step (51 timesteps x 128 rows).

With ``--quant int8,int4``, for each mode the head stacked from the same
weights in that mode (kernel #2's W8A8 / W4A8 quant mode):
- one 50-step call at 128 rows, eager and device-only, with and without
  PDL; launches of one net call (captured); one net call by stage
  (profiled without PDL); the bound;
- each block product at 128 rows, device-only over the 6 blocks (cold L2):
  the integer head GEMM where the tree has it (its plan, 1 split), and
  ``torch._int_mm`` on int8 weights at the same shape (int4: the unpacked
  planes), with the bound; for int4's wo also #16's swap-AB GEMM;
- end to end (unless ``--skip-e2e``), chip_smoke.phase_e2e_quant: the int8
  512 px request and the int4 flagship's three, s/image and phases, and a
  profile of one more int4 512 px request (the bundle ends quantized, so
  this runs last).

For each of the random bf16 BitDance-H-1x and BitDance-B-16x samplers of
chip_smoke.py (``imagenet``), at its guided path's rows (32 images, 100
sampling steps):
- one sampler call, eager (CUDA events) and device-only (a captured CUDA
  graph), with and without programmatic launches (PDL) where the tree has
  that switch; the launches of one net call (captured); the bound of
  chip_smoke.sampler_bound;
- each block product of the head GEMM, device-only over every block's
  weights in turn (cold L2): the planned tiles and splits, torch.matmul at
  the same shape, and a sweep of split counts and tile shapes (the H-1x w2
  at 1-8 splits, one split everywhere, bm 64 at 1024 rows);
- end to end, the guided batch through ``sample`` and the VQ decoder:
  s/batch and its sampler phase.

    python3 scripts/torch_sampler_times.py [--root DIR] [--heads t2i,imagenet]
        [--quant int8,int4] [--skip-e2e]

``--root`` puts another checkout's ``bitdance_tpu_torch`` first on sys.path
(default: this one), so that one run can time two trees in turns (parent,
change, change, parent); the inputs, timers and bound are this checkout's
chip_smoke.py's.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
# split counts of the H-1x w2 sweep (10 tiles, 30 stages of 64 k; a
# power of two up to the cluster limit)
W2_SWEEP = (1, 2, 4, 8)


def _sampler(smoke, fused_head, bundle, dev, seed) -> dict:
    import torch

    kw, inputs = smoke.imagenet_sampler_inputs(bundle, dev, seed)
    stacked, cfg = bundle.head_stacked, 4.0
    args = inputs(smoke.IMAGENET_STEPS)
    run = lambda: fused_head.fused_em_sample(stacked, *args, cfg, **kw)  # noqa: E731
    out = {}
    with torch.no_grad():
        out["ms"] = smoke.cuda_time_ms(run, 3, warmup=1)
        out["device_ms"] = smoke.cuda_graph_time_ms(run, calls=1, reps=3)
        if "_pdl" in inspect.signature(fused_head.fused_em_sample).parameters:
            plain = lambda: fused_head.fused_em_sample(  # noqa: E731
                stacked, *args, cfg, _pdl=False, **kw)
            out["no_pdl_ms"] = smoke.cuda_time_ms(plain, 3, warmup=1)
            out["no_pdl_device_ms"] = smoke.cuda_graph_time_ms(plain, calls=1, reps=3)
        out["launches_per_net_call"] = smoke._sampler_launches(
            lambda s: fused_head.fused_em_sample(stacked, args[0], args[1][:s],
                                                 args[2][:s + 1], *args[3:], cfg, **kw))
    calls = smoke.IMAGENET_STEPS + 1
    out.update(smoke.sampler_bound(stacked, *args[:3], attention=bundle.head.attention,
                                   groups=kw["groups"], window=bundle.head.parallel_num))
    out["per_net_call"] = {k: v / calls for k, v in out.items()
                           if k.endswith("ms") and isinstance(v, float)}
    return out


def _products(smoke, fused_head, bundle, rows, dev, seed) -> dict:
    import torch

    stacked = bundle.head_stacked
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(seed)
    keys = ("wqkv", "wo", "w1", "w2") if bundle.head.attention else ("w1", "w2")
    out = {}

    def device_ms(fn, blocks):
        return smoke.cuda_graph_time_ms(fn, calls=4, reps=3) / blocks

    with torch.no_grad():
        for key in keys:
            mode = smoke.HEAD_GEMM_PRODUCTS[key][0]
            n, k = stacked[key].shape[1:]
            blocks = stacked[key].shape[0]
            a, kw = smoke._head_gemm_operands(stacked, key, rows, g, dev)
            plan = fused_head.head_gemm_plan(rows, n, k, sms)
            variants = {"planned": plan, "one_split": plan._replace(splits=1)}
            if rows > 64:
                variants["bm64"] = plan._replace(bm=64)
            if key == "w2" and rows <= 64:
                variants.update({f"splits_{s}": plan._replace(splits=s) for s in W2_SWEEP})

            rec = {"mode": mode, "plan": list(plan),
                   **smoke.head_gemm_bound(a, stacked[key][0], mode, kw),
                   "library_device_ms": device_ms(smoke.matmul_walk(stacked, key, a), blocks)}
            rec.update({f"{name}_device_ms":
                        device_ms(smoke.head_gemm_walk(stacked, key, a, kw, p), blocks)
                        for name, p in variants.items()})
            out[key] = rec
    return out


def _quant(smoke, fused_head, head, mode, dev) -> dict:
    """#2's quant mode ``mode`` at the 14B head: the sampler call, a net
    call by stage and each product (see the module doc)."""
    import torch

    stacked = fused_head.stack_diffnet_params(head.net, head.depth_latent, torch.bfloat16,
                                              quant="int4" if mode == "int4" else True)
    kw = dict(num_blocks=head.depth_latent, num_ada=head.depth_adanln,
              n_head=head.ch_latent // head.attn_head_dim, groups=2, last_step_size=0.05,
              quant=mode)
    x0, noise, mods, t_all, dt_all = smoke._head_inputs(stacked, head, 50, 22, dev)
    steps = lambda s, **e: fused_head.fused_em_sample(  # noqa: E731
        stacked, x0, noise[:s], mods[:s + 1], t_all, dt_all, 7.5, **kw, **e)
    run = lambda **e: steps(50, **e)  # noqa: E731
    with torch.no_grad():
        rec = {"ms": smoke.cuda_time_ms(run, 3, warmup=1),
               "device_ms": smoke.cuda_graph_time_ms(run, calls=1, reps=3),
               "no_pdl_ms": smoke.cuda_time_ms(lambda: run(_pdl=False), 3, warmup=1),
               "no_pdl_device_ms": smoke.cuda_graph_time_ms(lambda: run(_pdl=False), calls=1,
                                                            reps=3),
               "launches_per_net_call": smoke._sampler_launches(steps),
               "net_call_us": smoke.net_call_profile(lambda s: steps(s, _pdl=False))}
        rec.update(smoke.sampler_bound(stacked, x0, noise, mods, attention=True, groups=2,
                                       window=head.parallel_num, quant=mode))
        rec["per_net_call"] = {k: v / mods.shape[0] for k, v in rec.items()
                               if k.endswith("ms") and isinstance(v, float)}
        rec["products"] = _quant_products(smoke, fused_head, stacked, mode, dev)
    return rec


def _quant_products(smoke, fused_head, stacked, mode, dev) -> dict:
    import torch

    from bitdance_tpu_torch.ops import int4 as q4

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(23)
    out = {}

    def device_ms(fn, blocks=6):
        return smoke.cuda_graph_time_ms(fn, calls=4, reps=3) / blocks

    for key, (gmode, _) in smoke.QUANT_GEMM_PRODUCTS.items():
        n = stacked[key].shape[1]
        k, aq, sa, kw = smoke._quant_gemm_operands(stacked, key, 128, mode, g, dev)
        rec = {"mode": gmode,
               **smoke.quant_gemm_bound(aq, sa, stacked[key][0], stacked[key + "_s"][0],
                                        gmode, kw),
               "library_device_ms": device_ms(smoke.int_mm_walk(stacked, key, aq, mode))}
        if hasattr(fused_head, "head_gemm_s8"):
            plan = fused_head.head_gemm_plan(128, n, k, sms, mode)
            rec["plan"] = list(plan)
            for name, p in (("planned", plan), ("one_split", plan._replace(splits=1))):
                rec[f"{name}_device_ms"] = device_ms(
                    smoke.quant_gemm_walk(stacked, key, aq, sa, kw, p, mode))
        if mode == "int4" and key == "wo":
            x = torch.randn((128, k), generator=g, device=dev).bfloat16()
            rows = q4.w4a8_quantize(x)
            wts = [q4.Q4Tensor(stacked[key][l], stacked[key + "_s"][l]) for l in range(6)]
            rec["swap_ab_device_ms"] = device_ms(
                lambda: [q4.int4_matmul(x, q, rows=rows) for q in wts])
        out[key] = rec
    return out


def _t2i(smoke, fused_head, skip_e2e: bool, quant_modes=()) -> dict:
    import torch

    from bitdance_tpu_torch.io.random_init import build_random_bundle

    dev = torch.device("cuda")
    bundle = build_random_bundle("cuda", seed=0)
    head, stacked = bundle.head, bundle.stacked_head()
    kw = dict(num_blocks=head.depth_latent, num_ada=head.depth_adanln,
              n_head=head.ch_latent // head.attn_head_dim, last_step_size=0.05)
    has_pdl = "_pdl" in inspect.signature(fused_head.fused_em_sample).parameters
    out = {}
    with torch.no_grad():
        for images in (1, 2):
            x0, noise, mods, t_all, dt_all = smoke._head_inputs(stacked, head, 50, images, dev,
                                                               images)
            kwi = dict(kw, groups=2 * images)
            run = lambda **e: fused_head.fused_em_sample(  # noqa: E731
                stacked, x0, noise, mods, t_all, dt_all, 7.5, **kwi, **e)
            rec = {"ms": smoke.cuda_time_ms(run, 3, warmup=1),
                   "device_ms": smoke.cuda_graph_time_ms(run, calls=1, reps=3)}
            if has_pdl:
                rec["no_pdl_ms"] = smoke.cuda_time_ms(lambda: run(_pdl=False), 3, warmup=1)
                rec["no_pdl_device_ms"] = smoke.cuda_graph_time_ms(
                    lambda: run(_pdl=False), calls=1, reps=3)
            steps = lambda s, **e: fused_head.fused_em_sample(  # noqa: E731
                stacked, x0, noise[:s], mods[:s + 1], t_all, dt_all, 7.5, **kwi, **e)
            rec["launches_per_net_call"] = smoke._sampler_launches(steps)
            if images == 1:   # the chain without PDL (net_call_profile)
                rec["net_call_us"] = smoke.net_call_profile(
                    lambda s: steps(s, **({"_pdl": False} if has_pdl else {})))
            rec.update(smoke.sampler_bound(stacked, x0, noise, mods, attention=True,
                                           groups=kwi["groups"], window=head.parallel_num))
            rec["per_net_call"] = {k: v / mods.shape[0] for k, v in rec.items()
                                   if k.endswith("ms") and isinstance(v, float)}
            out[f"sampler_R{128 * images}"] = rec
        if "gated_f32" in getattr(fused_head, "HEAD_GEMM_MODES", {}):
            out["products"] = _t2i_products(smoke, fused_head, stacked, dev)
        else:
            g = torch.Generator(device=dev).manual_seed(18)
            out["products"] = {}
            for key in ("wqkv", "wo", "w1", "w2"):
                a, _ = smoke._head_gemm_operands(stacked, key, 128, g, dev)
                out["products"][key] = {"library_device_ms": smoke.cuda_graph_time_ms(
                    smoke.matmul_walk(stacked, key, a), calls=4, reps=3) / 6}
        c_emb = torch.randn((128, head.ch_latent), device=dev)
        t51 = torch.linspace(0.0, 0.95, 51)
        out["em_precompute_ms"] = smoke.cuda_time_ms(
            lambda: fused_head.em_precompute(stacked, c_emb, t51), 5)
        for mode in quant_modes:
            out[f"quant_{mode}"] = _quant(smoke, fused_head, head, mode, dev)
            torch.cuda.empty_cache()
    if not skip_e2e:
        r = smoke.phase_e2e(bundle, smoke.card_line())
        out["e2e"] = [{"px": q["px"], "s_per_image": q["s_per_image"], "timing": q["timing"]}
                      for q in r["requests"]]
        if quant_modes:
            tokens = [q.pop("tokens") for q in r["requests"]]
            del stacked
            out["e2e_quant"] = smoke.phase_e2e_quant(bundle, smoke.card_line(),
                                                     tokens)["requests"]
    del bundle
    return out


def _t2i_products(smoke, fused_head, stacked, dev) -> dict:
    """#2's four products at 128 rows (qkv also at 256) on the head GEMM:
    the plan, 1, 2 and 4 splits and bm 64, beside torch.matmul."""
    import torch

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(18)
    prods = smoke.T2I_GEMM_PRODUCTS
    out = {}
    for key, rows in (("wqkv", 128), ("wo", 128), ("w1", 128), ("w2", 128), ("wqkv", 256)):
        mode = prods[key][0]
        n, k = stacked[key].shape[1:]
        blocks = stacked[key].shape[0]
        a, kw = smoke._head_gemm_operands(stacked, key, rows, g, dev, prods)
        plan = fused_head.head_gemm_plan(rows, n, k, sms)
        variants = {"planned": plan, "bm64": plan._replace(bm=64, splits=1)}
        variants.update({f"splits_{q}": plan._replace(splits=q) for q in (1, 2, 4)})

        def device_ms(fn):
            return smoke.cuda_graph_time_ms(fn, calls=4, reps=3) / blocks

        rec = {"mode": mode, "rows": rows, "plan": list(plan),
               **smoke.head_gemm_bound(a, stacked[key][0], mode, kw),
               "library_device_ms": device_ms(smoke.matmul_walk(stacked, key, a))}
        rec.update({f"{name}_device_ms":
                    device_ms(smoke.head_gemm_walk(stacked, key, a, kw, p, prods))
                    for name, p in variants.items()})
        out[f"{key}_R{rows}"] = rec
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(REPO),
                    help="checkout whose bitdance_tpu_torch is timed")
    ap.add_argument("--heads", default="t2i,imagenet",
                    help="comma-separated: t2i (kernel #2), imagenet (#3/#4)")
    ap.add_argument("--quant", default="",
                    help="comma-separated: int8, int4 (kernel #2's quant modes, with t2i)")
    ap.add_argument("--skip-e2e", action="store_true", help="kernels only")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch

    if not torch.cuda.is_available():
        print("torch_sampler_times: no CUDA device", file=sys.stderr)
        return 2
    import bitdance_tpu_torch
    from bitdance_tpu_torch.ops import _cuda, fused_head
    from bitdance_tpu_torch.utils.precision import full_fp32

    full_fp32()
    _cuda.load()
    dev = torch.device("cuda")
    heads = args.heads.split(",")
    out = {"package": bitdance_tpu_torch.__file__, "card": smoke.card_line()}
    if "t2i" in heads:
        out["t2i"] = _t2i(smoke, fused_head, args.skip_e2e,
                          [m for m in args.quant.split(",") if m])
        torch.cuda.empty_cache()
    if "imagenet" not in heads:
        print(json.dumps(out))
        return 0
    h1x, b16x = smoke.build_imagenet_samplers()
    for name, bundle, rows, seed in (("h1x", h1x, 2 * smoke.IMAGENET_BATCH, 14),
                                     ("b16x", b16x, 2 * smoke.IMAGENET_BATCH * 16, 15)):
        out[name] = {"sampler": _sampler(smoke, fused_head, bundle, dev, seed)}
        if hasattr(fused_head, "head_gemm"):
            out[name]["products"] = _products(smoke, fused_head, bundle, rows, dev, seed + 2)
    if not args.skip_e2e:
        for name, bundle, cfg_scale in (("h1x", h1x, 4.55), ("b16x", b16x, 6.1)):
            r = smoke._imagenet_run(bundle, smoke.IMAGENET_BATCH, cfg_scale, 0,
                                    smoke.IMAGENET_STEPS)
            out[name]["e2e"] = {"s_per_batch": r["s"], "sampler_s": r["timing"]["sampler"],
                                "ok": r["ok"], "fused_em_sample": r["counts"]["fused_em_sample"]}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
