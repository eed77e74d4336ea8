#!/usr/bin/env python3
"""Plant faults under two of chip_smoke.py's card bounds and read what each
check then reads, on one NVIDIA GPU; prints one JSON line.

- The W8A8 decoder (``conv_int8``) against the bf16 decoder of the same
  latents, relative L2 (bound ``CONV_INT8_REL_L2``): the release
  tokenizer's decoder (chip_smoke.py's ``_family_int8`` weights and
  latents), 8 images at 256 px, sound and with each of these quantizer
  faults: one activation scale for the whole batch instead of one an image
  (``per_tensor_activation``), one weight scale for the whole weight
  instead of one an output channel (``per_tensor_weight``), activations on
  7 bits (``activation_7bit``, scale max / 63, clip at +-63), activations
  truncated toward zero instead of rounded (``activation_trunc``).
- The plain-MLP T2I head (use_swiglu=False) at the 14B head width through
  ``DiffHead.sample`` against its plain route, a guided 4-step sample's
  max |d| / max |ref| (bound ``PLAIN_HEAD_MAX_REL_ERR``) and the signs
  after 50 steps (floor ``PLAIN_HEAD_SIGN_FLOOR``), chip_smoke.py's
  ``phase_head_leftovers`` inputs, sound (kernel #15) and with each of
  these faults on the sampled side: #15 replaced by its plain version
  computed in bf16 (LN output, qkv, scores, probabilities and attention
  output rounded to bf16; ``attn_block_bf16``), the attention scores
  unscaled (``attn_unscaled``), gelu in place of silu in the blocks' MLP
  (``mlp_gelu``).

    python3 scripts/torch_bound_faults.py [--out chiprun_out/bound_faults.json]
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def _patched(mod, name, fn):
    saved = getattr(mod, name)
    setattr(mod, name, fn)
    try:
        yield
    finally:
        setattr(mod, name, saved)


def _conv_faults():
    """name -> (function name in models/tokenizer.py, faulty version)."""
    import torch

    def per_tensor_activation(x):
        xf = x.float()
        xs = (xf.abs().amax().clamp_min(1e-12) / 127.0).expand(x.shape[0]).contiguous()
        xq = torch.clamp(torch.round(xf / xs[:, None, None, None]), -127, 127)
        return xq.to(torch.int8), xs

    def per_tensor_weight(w):
        wf = w.float().permute(0, 2, 3, 1).reshape(w.shape[0], -1)
        ws = (wf.abs().amax().clamp_min(1e-12) / 127.0).expand(w.shape[0]).contiguous()
        wq = torch.clamp(torch.round(wf / ws[:, None]), -127, 127).to(torch.int8)
        return wq, ws

    def activation_7bit(x):
        xf = x.float()
        xs = xf.abs().amax(dim=(1, 2, 3)).clamp_min(1e-12) / 63.0
        xq = torch.clamp(torch.round(xf / xs[:, None, None, None]), -63, 63)
        return xq.to(torch.int8), xs

    def activation_trunc(x):
        xf = x.float()
        xs = xf.abs().amax(dim=(1, 2, 3)).clamp_min(1e-12) / 127.0
        xq = torch.clamp(torch.trunc(xf / xs[:, None, None, None]), -127, 127)
        return xq.to(torch.int8), xs

    return {"per_tensor_activation": ("quantize_conv_input", per_tensor_activation),
            "per_tensor_weight": ("quantize_conv_weight", per_tensor_weight),
            "activation_7bit": ("quantize_conv_input", activation_7bit),
            "activation_trunc": ("quantize_conv_input", activation_trunc)}


def conv_int8_faults(smoke) -> dict:
    import torch

    from bitdance_tpu_torch.io.random_init import BITDANCE_14B_64X as GEO
    from bitdance_tpu_torch.models import tokenizer as tok

    dd = GEO["ddconfig"]
    vq = tok.init_vq(dd, "cuda", torch.bfloat16, smoke._seeded(27), encoder=True)
    with torch.device("meta"):
        q8 = tok.VQModel(dd, dtype=torch.bfloat16, conv_int8=True)
    q8 = q8.to_empty(device="cuda").eval()
    q8.decoder.load_state_dict(vq.decoder.state_dict())
    px, n, _ = smoke.FAMILY_IMAGES[0]
    h = px // 16
    z = torch.where(torch.randn((n, h, h, dd["z_channels"]), generator=smoke._seeded(px),
                                device="cuda") > 0, 1.0, -1.0).bfloat16()
    out = {"bound": smoke.CONV_INT8_REL_L2, "px": px, "images": n}
    with torch.no_grad():
        ref = vq.decode(z)
        out["sound"] = smoke._rel_l2(q8.decode(z), ref)
        for name, (fn_name, fn) in _conv_faults().items():
            with _patched(tok, fn_name, fn):
                out[name] = smoke._rel_l2(q8.decode(z), ref)
    for k in ("sound", *_conv_faults()):
        print(f"conv_int8 at {px} px, {n} images, {k}: relative L2 against bf16 "
              f"{out[k]:.4f} (bound {out['bound']}; caught {out[k] >= out['bound']})",
              flush=True)
    return out


def _attn_block_bf16(x, scale, shift, gate, ln_w, ln_b, wqkv, bqkv, wo, bo, n_head,
                     eps: float = 1e-6):
    """fused_attn_block_reference with its intermediates rounded to bf16."""
    import torch
    import torch.nn.functional as F

    g, w, c = x.shape
    hd = c // n_head
    bf = torch.bfloat16
    h = F.layer_norm(x.to(bf), (c,), ln_w.to(bf), ln_b.to(bf), eps) * (1 + scale.to(bf)) \
        + shift.to(bf)
    qkv = F.linear(h.to(bf), wqkv.to(bf), bqkv.to(bf)).reshape(g, w, 3, n_head, hd)
    q = qkv[:, :, 0] * hd ** -0.5
    s = torch.einsum("gqhd,gkhd->ghqk", q, qkv[:, :, 1])
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("ghqk,gkhd->gqhd", p, qkv[:, :, 2]).reshape(g, w, c)
    return x + F.linear(o, wo.to(bf), bo.to(bf)) * gate.to(bf)


def _attn_unscaled(x, scale, shift, gate, ln_w, ln_b, wqkv, bqkv, wo, bo, n_head,
                   eps: float = 1e-6):
    """fused_attn_block_reference with the scores not scaled by hd^-0.5."""
    import torch

    from bitdance_tpu_torch.ops.fused_block import _ln_modulate, _mm

    g, w, c = x.shape
    hd = c // n_head
    h = _ln_modulate(x, scale, shift, ln_w, ln_b, eps)
    qkv = (_mm(h, wqkv) + bqkv.float()).reshape(g, w, 3, n_head, hd)
    s = torch.einsum("gqhd,gkhd->ghqk", qkv[:, :, 0], qkv[:, :, 1])
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("ghqk,gkhd->gqhd", p, qkv[:, :, 2]).reshape(g, w, c)
    return (x.float() + (_mm(o, wo) + bo.float()) * gate.float()).to(x.dtype)


def plain_head_faults(smoke) -> dict:
    import torch
    from torch import nn

    from bitdance_tpu_torch.io.random_init import BITDANCE_14B_64X as GEO
    from bitdance_tpu_torch.io.random_init import init_head
    from bitdance_tpu_torch.models import diff_head as dh

    dev = torch.device("cuda")
    cond = torch.randn((2, GEO["head"]["parallel_num"], GEO["head"]["ch_cond"]),
                       generator=smoke._seeded(32), device=dev).bfloat16()
    head = init_head(dict(GEO["head"], use_swiglu=False), dev, torch.bfloat16,
                     smoke._seeded(31))
    assert not head.stackable

    def sample():
        return (head.sample(cond, smoke._seeded(33), 7.5, 4, 2),
                head.sample(cond, smoke._seeded(33), 7.5, 50, 2))

    @contextlib.contextmanager
    def gelu_mlp():
        saved = [b.mlp[1] for b in head.net.res_blocks]
        for b in head.net.res_blocks:
            b.mlp[1] = nn.GELU()
        try:
            yield
        finally:
            for b, act in zip(head.net.res_blocks, saved):
                b.mlp[1] = act

    faults = {"sound": contextlib.nullcontext,
              "attn_block_bf16": lambda: _patched(dh, "fused_attn_block", _attn_block_bf16),
              "attn_unscaled": lambda: _patched(dh, "fused_attn_block", _attn_unscaled),
              "mlp_gelu": gelu_mlp}
    out = {"bound": smoke.PLAIN_HEAD_MAX_REL_ERR, "sign_floor": smoke.PLAIN_HEAD_SIGN_FLOOR}
    with torch.no_grad():
        with smoke._plain_head():
            want4, want50 = sample()
        for name, ctx in faults.items():
            with ctx():
                got4, got50 = sample()
            _, rel = smoke._errors(got4, want4)
            agree = ((got50 > 0) == (want50 > 0)).float().mean().item()
            caught = rel > out["bound"] or agree < out["sign_floor"]
            out[name] = {"rel": rel, "sign_agreement": agree, "caught": caught}
            print(f"plain-MLP head, {name}: 4-step sample {rel:.3e} of max (bound "
                  f"{out['bound']}), signs after 50 steps {agree:.4f} (floor "
                  f"{out['sign_floor']}); caught {caught}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/bound_faults.json",
                    help="the JSON result's file (also printed)")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch

    if not torch.cuda.is_available():
        print("torch_bound_faults: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    res = {"card": smoke.card_line(), "conv_int8": conv_int8_faults(smoke)}
    torch.cuda.empty_cache()
    res["plain_head"] = plain_head_faults(smoke)
    res["seconds"] = time.perf_counter() - t
    line = json.dumps(res)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
