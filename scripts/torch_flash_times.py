#!/usr/bin/env python3
"""Time the PyTorch port's flash-attention wrappers (the forward #7 and the
backward #8 / #9, and their sparse instantiations #10-#12) on one NVIDIA
GPU: eager (CUDA events over 50 calls), device-only (calls captured in a
CUDA graph) and the host time of one call. The forward, dq and dk/dv at
chip_smoke.py's four dense cases, with scaled_dot_product_attention's
forward and autograd backward (eager and device-only) beside them; the
three sparse kernels and the dense ones at its packed 8,192-token case; the
sparse and the dense forward at the 14B training step's packed 37,376
tokens (fewer calls there).

    python3 scripts/torch_flash_times.py [--root DIR]

``--root`` puts another checkout's ``bitdance_tpu_torch`` first on sys.path
(default: this one), so that one run can time two trees in turns (parent,
change, change, parent); only the wrappers' common signature is used, and
the inputs and timers are chip_smoke.py's. The wrappers get the ids as the
autograd Function hands them (int32 [B, L], contiguous). Prints one JSON
line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
DENSE_CASES = ("path", "b16x", "packed", "gqa_d128")


def _times(smoke, fn, calls: int = 50) -> dict:
    """Eager ms over ``calls`` calls, device-only ms (a captured graph of up
    to 20 calls), host us a call (over 4 x ``calls`` calls)."""
    return {"ms": smoke.cuda_time_ms(fn, calls),
            "device_ms": smoke.cuda_graph_time_ms(fn, calls=min(calls, 20)),
            "host_us": smoke.host_us(fn, 4 * calls)}


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
        print("torch_flash_times: no CUDA device", file=sys.stderr)
        return 2
    import bitdance_tpu_torch
    from bitdance_tpu_torch.ops import _cuda
    from bitdance_tpu_torch.ops.attention import (
        flash_bwd_dkv,
        flash_bwd_dkv_sparse,
        flash_bwd_dq,
        flash_bwd_dq_sparse,
        flash_fwd,
        flash_fwd_sparse,
        mask_from_ids,
        sparse_plan,
    )

    _cuda.load()
    dev = torch.device("cuda")
    out = {}
    with torch.no_grad():
        for name in DENSE_CASES:
            q, k, v, do, ids, _ = smoke._flash_case(name, dev)
            ids = tuple(t.to(torch.int32).contiguous() for t in ids)
            sc = q.shape[-1] ** -0.5
            o, lse = flash_fwd(q, k, v, *ids, sc)
            delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
            rec = {"fwd": _times(smoke, lambda: flash_fwd(q, k, v, *ids, sc)),  # noqa: B023
                   "dq": _times(smoke, lambda: flash_bwd_dq(  # noqa: B023
                       q, k, v, do, lse, delta, *ids, sc)),
                   "dkv": _times(smoke, lambda: flash_bwd_dkv(  # noqa: B023
                       q, k, v, do, lse, delta, *ids, sc))}
            fwd, fwd_dev, bwd, bwd_dev = smoke.sdpa_times(
                q, k, v, do, mask_from_ids(*ids)[:, None], 50)
            rec["sdpa_forward"] = {"ms": fwd, "device_ms": fwd_dev}
            rec["sdpa_backward"] = {"ms": bwd, "device_ms": bwd_dev}
            out[name] = rec
            del q, k, v, do, o, lse, delta
        q, k, v, do, ids, bound, _ = smoke._sparse_case(dev)
        ids = tuple(t.to(torch.int32).contiguous() for t in ids)
        sc = q.shape[-1] ** -0.5
        plan = sparse_plan(*ids, bound)
        o, lse = flash_fwd_sparse(q, k, v, *ids, plan, sc)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        out["sparse_8192"] = {
            "fwd": _times(smoke, lambda: flash_fwd_sparse(q, k, v, *ids, plan, sc)),
            "dq": _times(smoke, lambda: flash_bwd_dq_sparse(
                q, k, v, do, lse, delta, *ids, plan, sc)),
            "dkv": _times(smoke, lambda: flash_bwd_dkv_sparse(
                q, k, v, do, lse, delta, *ids, plan, sc)),
            "dense_fwd": _times(smoke, lambda: flash_fwd(q, k, v, *ids, sc)),
            "dense_dq": _times(smoke, lambda: flash_bwd_dq(
                q, k, v, do, lse, delta, *ids, sc)),
            "dense_dkv": _times(smoke, lambda: flash_bwd_dkv(
                q, k, v, do, lse, delta, *ids, sc))}
        del q, k, v, do, o, lse, delta, plan
        cfg, _, _, _, batch = smoke.mllm_step_batch(dev)
        ids = tuple(t.to(torch.int32).contiguous() for t in (batch.block_ids, batch.doc_ids))
        ids = ids * 2
        L = ids[0].shape[1]
        g = torch.Generator(device=dev).manual_seed(8)
        hq, hkv, hd = (cfg.llm.num_attention_heads, cfg.llm.num_key_value_heads,
                       cfg.llm.head_dim)
        q = torch.randn((1, L, hq, hd), generator=g, device=dev).bfloat16()
        k, v = (torch.randn((1, L, hkv, hd), generator=g, device=dev).bfloat16()
                for _ in "kv")
        sc = hd ** -0.5
        plan = sparse_plan(*ids, cfg.attn_live_tiles())
        out[f"sparse_{L}"] = {
            "fwd": _times(smoke, lambda: flash_fwd_sparse(q, k, v, *ids, plan, sc), 10),
            "dense_fwd": _times(smoke, lambda: flash_fwd(q, k, v, *ids, sc), 10)}
    print(json.dumps({"package": bitdance_tpu_torch.__file__,
                      "card": smoke.card_line(), "times": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
