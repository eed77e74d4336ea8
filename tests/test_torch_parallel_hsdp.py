"""The port's sharded steps on a (replica 2, fsdp 2) mesh of four spawned
CPU processes over gloo (HSDP: each parameter split over fsdp, replicated
over replica, the batch split over all four), against the unsharded steps
on the same global batch and seed:
  - the ImageNet step, 3 steps, bf16 mixed precision and fp32 (the
    tolerances of tests/test_torch_parallel.py);
  - the MLLM step, one distinct packed sequence a rank: loss relative 2e-5
    and parameters within 1e-5, as tests/test_mllm_dp.py:68-86 holds JAX's;
  - the same in bf16, the 14B command's dtype (FSDP2 reduces the bf16
    gradients in fp32 and casts the sum to bf16), at bounds set from the
    readings;
  - gradient accumulation across ranks: 2 microbatches of one sequence a
    rank (8 sequences) against one unsharded step on the 8 sequences.
"""

import dataclasses

import numpy as np
import pytest
import torch

from bitdance_tpu_torch.data import packing as tpack
from bitdance_tpu_torch.io.random_init import build_random_mllm_train_state
from bitdance_tpu_torch.models import mllm as tm
from bitdance_tpu_torch.models import qwen3 as tq
from bitdance_tpu_torch.parallel import mesh as tmesh
from bitdance_tpu_torch.train import mllm_train as ttrain
from tests.test_torch_parallel import assert_imagenet_close, imagenet_vs_unsharded, spawn

LLM = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, head_dim=16)
HEAD = dict(z_channels=8, parallel_num=4, head_model_dim=128, head_num_blocks=2,
            head_num_adaln=2, head_use_swiglu=True, P_mean=-0.8, P_std=0.8,
            vision_perturb=0.1)


def _sequences(n):
    """n packed sequences of two samples each (numpy dicts), all distinct."""
    table = tpack.sincos_1d_table_np(32, 64)
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        samples = [tpack.T2ISample(
            text_ids=rng.integers(1, 250, int(rng.integers(5, 12))),
            image_latents=np.sign(rng.normal(size=(16, 8))).astype(np.float32),
            latent_h=4, latent_w=4, vision_start_id=251, res_h_id=252, res_w_id=253,
            query_ids=np.arange(260, 263), text_loss=True) for _ in range(2)]
        out.append(tpack.pack_t2i_batch(samples, 4, 128, table, text_budget=48,
                                        vis_budget=48))
    return out


def mllm_vs_unsharded(mesh, n_seq, accum, steps=2, dtype=torch.float32):
    """The sharded MLLM step (``accum`` microbatches, one slice of each a
    data shard) against ``train_step`` on the n_seq sequences at once, both
    in ``dtype``: per step the two losses, then {name: (sharded, unsharded)}
    parameters; per step the unsharded gradient's largest magnitude on the
    head's key biases (wqkv.bias[C:2C]) and its grad norm."""
    cfg = tm.MLLMConfig(llm=tq.Qwen3Config(vocab_size=300, **LLM), **HEAD)
    tcfg = ttrain.MLLMTrainConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    ref = build_random_mllm_train_state(cfg, tcfg, "cpu", dtype=dtype, seed=0)
    tcfg_s = dataclasses.replace(tcfg, grad_accum=accum)
    fn, st = ttrain.make_sharded_train_step(
        mesh, build_random_mllm_train_state(cfg, tcfg_s, "cpu", dtype=dtype, seed=0),
        cfg, tcfg_s)
    c = cfg.head_model_dim
    raws = _sequences(n_seq)
    whole = tm.PackedBatch.from_numpy(tpack.stack_packed_batches(raws), "cpu")
    split = tm.PackedBatch.from_numpy(tpack.stack_packed_batches(raws, accum), "cpu")
    rows = tmesh.batch_rows(mesh, n_seq // accum)
    mine = tm.PackedBatch(*(t[:, rows] if accum > 1 else t[rows] for t in split))
    losses, key_grads = [], []
    for s in range(steps):
        m, grads = ttrain.loss_and_grads(ref, whole, 7 + s, cfg=cfg, tcfg=tcfg)
        key_grads.append((max(g[c:2 * c].abs().max().item()
                              for n, g in zip(ref.tx.names, grads)
                              if n.endswith("attn.wqkv.bias")), m["grad_norm"].item()))
        mr = ttrain.train_step(ref, whole, 7 + s, cfg=cfg, tcfg=tcfg)
        ms = fn(st, mine, 7 + s)
        losses.append([{k: float(v) for k, v in m.items()} for m in (mr, ms)])
    ref_p = dict(ref.model.named_parameters())
    params = {n: (p.full_tensor().detach(), ref_p[n].detach())
              for n, p in st.model.named_parameters()}
    return {"losses": losses, "params": params, "step": st.step, "key_grads": key_grads}


def world4_task(rank, world, workdir):
    mesh = tmesh.create_mesh(replica=2, device_type="cpu")
    return {"mesh": tuple(mesh.shape),
            "imagenet_mixed": imagenet_vs_unsharded(mesh, True),
            "imagenet_fp32": imagenet_vs_unsharded(mesh, False),
            "mllm": mllm_vs_unsharded(mesh, 4, 1),
            "mllm_bf16": mllm_vs_unsharded(mesh, 4, 1, dtype=torch.bfloat16),
            "mllm_accum": mllm_vs_unsharded(mesh, 8, 2)}


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return spawn(world4_task, 4, tmp_path_factory.mktemp("world4"))


def test_hsdp_mesh(world4):
    assert [r["init"] for r in world4] == [(r, 4) for r in range(4)]
    assert all(r["mesh"] == (2, 2, 1) for r in world4)


@pytest.mark.parametrize("mixed", [True, False], ids=["bf16_mixed", "fp32"])
def test_sharded_imagenet_step_equals_unsharded_at_2x2(world4, mixed):
    r = world4[0]["imagenet_mixed" if mixed else "imagenet_fp32"]
    assert_imagenet_close(r, mixed)


@pytest.mark.parametrize("key", ["mllm", "mllm_accum"],
                         ids=["one_sequence_a_rank", "grad_accum_across_ranks"])
def test_sharded_mllm_step_equals_unsharded_at_2x2(world4, key):
    """Every parameter within 1e-5 after 2 steps, but the head's key biases
    (wqkv.bias[C:2C]): a softmax does not see a constant added to a row's
    scores, so their gradient is 0 up to rounding and Adam moves each by
    about lr on the sign of that rounding, which the shards' sums order
    otherwise. The cause is checked (the unsharded gradient there under
    1e-8 of the grad norm at each step; 3e-11 measured), then they are held
    to moving at most 2 steps' lr on both sides."""
    r = world4[0][key]
    lr, c = 1e-3, HEAD["head_model_dim"]
    assert r["step"] == len(r["losses"]) == 2
    for key_grad, grad_norm in r["key_grads"]:
        assert key_grad <= 1e-8 * grad_norm, (key_grad, grad_norm)
    for want, got in r["losses"]:
        for k in ("loss", "ce_loss_text", "ce_loss_vision", "grad_norm"):
            np.testing.assert_allclose(got[k], want[k], rtol=2e-5, err_msg=k)
    for n, (got, want) in r["params"].items():
        if n.endswith("attn.wqkv.bias"):
            key_bias = slice(c, 2 * c)
            assert (got[key_bias] - want[key_bias]).abs().max() <= 2 * 2 * lr * 1.01, n
            got, want = torch.cat([got[:c], got[2 * c:]]), torch.cat([want[:c], want[2 * c:]])
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5, err_msg=n)


def test_sharded_mllm_step_equals_unsharded_at_2x2_in_bf16(world4):
    """bf16 parameters, gradients and moments on both sides (the 14B
    command's dtype): the sharded bf16 gradient is the fp32 sum of the
    ranks' bf16 gradients rounded once, the unsharded one the whole batch's
    bf16 gradient, so the two part by bf16 rounding, which Adam turns into
    moves of up to 2 lr where a gradient is near 0. Bounds set from the
    readings (4 ranks, 2 steps): losses and grad norm relative 1e-3
    (2.1e-4 measured); over all parameters |d| / |unsharded move| <= 0.1
    (0.024) and at most 2% of the elements more than one bf16 ulp apart
    (0.54%); each element within 2 steps of 2 lr plus an ulp (2.54 lr)."""
    r = world4[0]["mllm_bf16"]
    lr = 1e-3
    assert r["step"] == len(r["losses"]) == 2
    for want, got in r["losses"]:
        for k in ("loss", "ce_loss_text", "ce_loss_vision", "grad_norm"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-3, err_msg=k)
    cfg = tm.MLLMConfig(llm=tq.Qwen3Config(vocab_size=300, **LLM), **HEAD)
    tcfg = ttrain.MLLMTrainConfig(lr=lr, warmup_steps=0, total_steps=10)
    start = dict(build_random_mllm_train_state(cfg, tcfg, "cpu", dtype=torch.bfloat16,
                                               seed=0).model.named_parameters())
    assert all(got.dtype == want.dtype == torch.bfloat16
               for got, want in r["params"].values())
    got = torch.cat([g.float().flatten() for g, _ in r["params"].values()])
    want = torch.cat([w.float().flatten() for _, w in r["params"].values()])
    p0 = torch.cat([start[n].detach().float().flatten() for n in r["params"]])
    d = (got - want).abs()
    ulp = torch.pow(2.0, torch.floor(torch.log2(torch.maximum(want.abs(), p0.abs())
                                                .clamp_min(1e-30))) - 7)
    assert (want - p0).abs().max() > 0.5 * lr
    assert d.norm() <= 0.1 * (want - p0).norm(), (d.norm(), (want - p0).norm())
    assert (d > ulp).float().mean() <= 0.02
    assert (d <= 2 * 2 * lr + ulp).all(), d.max()

