#!/usr/bin/env python3
"""Time the PyTorch port's flash-attention backward wrappers (kernels #8 and
#9, and their sparse instantiations #11 and #12) on one NVIDIA GPU: eager
(CUDA events over 50 calls), device-only (calls captured in a CUDA graph)
and the host time of one call, for dq and dk/dv at chip_smoke.py's four
dense cases and its packed 8,192-token sparse case, and the autograd
backward of scaled_dot_product_attention (eager and device-only) at the
dense cases.

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
import inspect
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
DENSE_CASES = ("path", "b16x", "packed", "gqa_d128")


def _times(smoke, fn) -> dict:
    return {"ms": smoke.cuda_time_ms(fn, 50), "device_ms": smoke.cuda_graph_time_ms(fn),
            "host_us": smoke.host_us(fn)}


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
            rec = {"dq": _times(smoke, lambda: flash_bwd_dq(  # noqa: B023
                       q, k, v, do, lse, delta, *ids, sc)),
                   "dkv": _times(smoke, lambda: flash_bwd_dkv(  # noqa: B023
                       q, k, v, do, lse, delta, *ids, sc))}
            _, _, bwd, bwd_dev = smoke.sdpa_times(q, k, v, do, mask_from_ids(*ids)[:, None],
                                                  50)
            rec["sdpa_backward"] = {"ms": bwd, "device_ms": bwd_dev}
            out[name] = rec
            del q, k, v, do, o, lse, delta
        q, k, v, do, ids, bound, _ = smoke._sparse_case(dev)
        ids = tuple(t.to(torch.int32).contiguous() for t in ids)
        sc = q.shape[-1] ** -0.5
        # an earlier tree's plan took the head dim (its dk/dv q tiles hung on it)
        head_dim = ({"head_dim": q.shape[-1]}
                    if "head_dim" in inspect.signature(sparse_plan).parameters else {})
        plan = sparse_plan(*ids, bound, **head_dim)
        o, lse = flash_fwd_sparse(q, k, v, *ids, plan, sc)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        out["sparse_8192"] = {
            "dq": _times(smoke, lambda: flash_bwd_dq_sparse(
                q, k, v, do, lse, delta, *ids, plan, sc)),
            "dkv": _times(smoke, lambda: flash_bwd_dkv_sparse(
                q, k, v, do, lse, delta, *ids, plan, sc)),
            "dense_dq": _times(smoke, lambda: flash_bwd_dq(
                q, k, v, do, lse, delta, *ids, sc)),
            "dense_dkv": _times(smoke, lambda: flash_bwd_dkv(
                q, k, v, do, lse, delta, *ids, sc))}
    print(json.dumps({"package": bitdance_tpu_torch.__file__,
                      "card": smoke.card_line(), "times": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
