"""The quantized T2I slice as a whole: the port's generate_tokens with an
int8 KV cache gives EXACTLY the JAX generate_tokens(kv_int8=True) ±1 grid on
shared tiny weights and shared noise, in the two serving configurations the
JAX package ships (README "packed int4 W4A8 LLM+head, int8 KV";
pipelines/loader.py quantize_llm / quantize_head):
  - int4: packed-int4 W4A8 Qwen3 projections, int8 embedding table,
    sample_weight_quant="int4" head sampler;
  - int8: W8A8 Qwen3 projections, float embedding, sample_weight_quant=True.
The quantized models come from the JAX trees through io/from_jax.py.

The JAX bundle is stacked-only (head_params=None, head_stacked from
DiffHead._stack_for_sampler): on the CPU a bundle that carries head_params
samples through the per-call flax head, which ignores sample_weight_quant.
Stacked-only, it samples through em_sample_stacked on the quantized stack,
whose x0 [half, ch] and noise [steps, half, ch] draws come from shape-keyed
tables here (the port's draw_sampler_noise gets the same tables).

That JAX path carries the head's residual and glue in bf16 when quantized
(diff_head.py _run_fused_sample, glue_dtype), where the port keeps fp32 as
the TPU kernel #2 does; the LLM's bf16 activations round at other places
too. So the sign inputs of the two sides differ by rounding: up to ~1e-2
here (SIGN_INPUT_GAP bounds it, read from the JAX side through a debug
callback), and the grids agree exactly only while no sign input falls
inside that gap. NOISE_SEED is one where none does (every margin also
clears 1e-3, the guard of test_reference_parity.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdance_tpu.models import qwen3 as jq
from bitdance_tpu.models.connector import MLPConnector as JConnector
from bitdance_tpu.models.diff_head import DiffHead as JHead
from bitdance_tpu.models.tokenizer import VQModel as JVQ
from bitdance_tpu.ops.rotary import pos_embed_2d as j_pos_embed_2d
from bitdance_tpu.pipelines import t2i as jt2i
from bitdance_tpu_torch.io.from_jax import flax_state_from_jax, load_into, qwen3_from_jax
from bitdance_tpu_torch.models import diff_head as tdh
from bitdance_tpu_torch.models import qwen3 as tq
from bitdance_tpu_torch.models.connector import MLPConnector
from bitdance_tpu_torch.models.tokenizer import VQModel
from bitdance_tpu_torch.ops.rotary import pos_embed_2d
from bitdance_tpu_torch.pipelines import t2i as tt2i

torch.set_num_threads(2)
TINY_DD = dict(z_channels=8, in_channels=3, out_ch=3, ch=32, ch_mult=[1, 2],
               num_res_blocks=1)
LLM = dict(vocab_size=64, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           head_dim=16, rope_theta=10000.0)
HEAD = dict(ch_target=8, ch_cond=64, ch_latent=128, depth_latent=2,
            depth_adanln=2, parallel_num=4, use_swiglu=True)
NOISE_SEED = 8
SIGN_MARGIN = 1e-3
# largest |port - JAX| sign input over 13 noise seeds: 1.04e-2 (int4 head),
# 8.6e-3 (int8 head), 3.7e-3 (unquantized head); a bound 2x that
SIGN_INPUT_GAP = 2e-2
CONFIGS = {"int4": ("int4", "int4"), "int8": ("int8", True),
           "int4_llm_bf16_head": ("int4", False)}
START = [20, 21, 21, 31, 32, 33]          # vision_start, res_h, res_w, queries
ROWS = [[3, 4, 5, 6, 7], [0, 0, 0, 3, 9]]
PADS = [0, 3]


def _shaped_noise(shape):
    seed = NOISE_SEED
    for d in shape:
        seed = (seed * 131 + int(d) + 7) % (2**31 - 1)
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _randomized(tree, seed, scale=0.05):
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(scale * rng.normal(size=l.shape), jnp.float32) for l in leaves])


@pytest.fixture(scope="module")
def weights():
    cfg = jq.Qwen3Config(**LLM)
    llm = jq.init_qwen3_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    llm.pop("lm_head", None)
    hp = _randomized(JHead(**HEAD).init(jax.random.PRNGKey(1), jnp.zeros((2, 4, 8)),
                                        jnp.zeros((2, 4, 64)), jax.random.PRNGKey(2)), 3)
    aep = JVQ(ddconfig=TINY_DD).init(jax.random.PRNGKey(4), jnp.zeros((1, 4, 4, 8)),
                                     method=JVQ.decode)
    pp = _randomized(JConnector(out_dim=64).init(jax.random.PRNGKey(5),
                                                 jnp.zeros((1, 8))), 6, 0.2)
    return cfg, llm, hp, aep, pp


def _bundles(weights, config):
    cfg, llm, hp, aep, pp = weights
    llm_mode, head_quant = CONFIGS[config]
    jllm = (jq.quantize_qwen3_params_int4(llm) if llm_mode == "int4"
            else jq.quantize_qwen3_params(llm))
    head = JHead(**HEAD, sample_weight_quant=head_quant)
    jb = jt2i.T2IModelBundle(
        llm_cfg=cfg, llm_params=jllm, ae=JVQ(ddconfig=TINY_DD), ae_params=aep,
        head=head, head_params=None, projector=JConnector(out_dim=64),
        projector_params=pp, parallel_num=4, hidden_size=64, vae_patch_size=2,
        pe_max_len=64,
        head_stacked=head.apply(hp, method=JHead._stack_for_sampler))
    thead = load_into(tdh.DiffHead(**HEAD, sample_weight_quant=head_quant),
                      flax_state_from_jax(hp))
    tb = tt2i.T2IModelBundle(
        llm=qwen3_from_jax(tq.Qwen3Config(**LLM), jllm),
        ae=load_into(VQModel(TINY_DD), flax_state_from_jax(aep)), head=thead,
        projector=load_into(MLPConnector(8, 64), flax_state_from_jax(pp)),
        parallel_num=4, hidden_size=64, vae_patch_size=2, pe_max_len=64,
        head_stacked=thead._stack_for_sampler())
    return jb, tb


def _generate(weights, config, monkeypatch, steps=4):
    jb, tb = _bundles(weights, config)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=jnp.float32:
                        jnp.asarray(_shaped_noise(tuple(shape)), dtype))
    j_inputs = []
    real_j_sign = jt2i.sign_quantize

    def j_spy(x):
        jax.debug.callback(lambda v: j_inputs.append(np.asarray(v)), x)
        return real_j_sign(x)

    monkeypatch.setattr(jt2i, "sign_quantize", j_spy)
    pe_j = j_pos_embed_2d(jt2i.build_pos_table(jb), 4, 4, 2)
    want = np.asarray(jt2i.generate_tokens(
        jb, jnp.asarray(ROWS, jnp.int32), jnp.asarray(PADS, jnp.int32),
        jnp.asarray(START, jnp.int32), pe_j, jax.random.PRNGKey(0),
        latent_h=4, latent_w=4, num_images=1, guidance_scale=2.0,
        num_sampling_steps=steps, kv_int8=True))

    def table_noise(generator, half, ch, num_steps, device):
        return (torch.from_numpy(_shaped_noise((half, ch))),
                torch.from_numpy(_shaped_noise((num_steps, half, ch))))

    t_inputs = []
    real_sign = tt2i.sign_quantize

    def spy_sign(x):
        t_inputs.append(x.float().numpy().copy())
        return real_sign(x)

    monkeypatch.setattr(tdh, "draw_sampler_noise", table_noise)
    monkeypatch.setattr(tt2i, "sign_quantize", spy_sign)
    pe_t = pos_embed_2d(tt2i.build_pos_table(tb), 4, 4, 2)
    got = tt2i.generate_tokens(
        tb, torch.tensor(ROWS), torch.tensor(PADS, dtype=torch.int32),
        torch.tensor(START), pe_t, torch.Generator(), latent_h=4, latent_w=4,
        num_images=1, guidance_scale=2.0, num_sampling_steps=steps,
        kv_int8=True).numpy()
    return got, want, t_inputs, j_inputs, tb


def _check_sign_inputs(t_inputs, j_inputs):
    """Every port sign input clears SIGN_MARGIN and lies within
    SIGN_INPUT_GAP of the JAX one of the same AR step."""
    assert len(t_inputs) == len(j_inputs) == 4
    margin = min(float(np.abs(t).min()) for t in t_inputs)
    assert margin > SIGN_MARGIN, (
        f"borderline sign margin {margin}: pick another NOISE_SEED")
    gap = max(float(np.abs(t - j.reshape(t.shape)).max())
              for t, j in zip(t_inputs, j_inputs))
    assert gap < SIGN_INPUT_GAP, gap


@pytest.mark.parametrize("config", ["int4", "int8"])
def test_quantized_generate_tokens_exact(weights, config, monkeypatch):
    got, want, t_inputs, j_inputs, tb = _generate(weights, config, monkeypatch)
    assert got.shape == want.shape == (1, 16, 8)
    np.testing.assert_array_equal(got, want, err_msg="±1 token grids diverge")
    _check_sign_inputs(t_inputs, j_inputs)
    img = tt2i.decode_image(tb, torch.from_numpy(got), 4, 4)
    assert img.shape == (1, 8, 8, 3) and torch.isfinite(img).all()


def test_quant_flag_reaches_the_sampler(weights, monkeypatch):
    """The same int4 LLM with the int4 head and with the unquantized head:
    the grids differ on both sides, and each side's pair is the other's."""
    q_got, q_want, *_ = _generate(weights, "int4", monkeypatch)
    f_got, f_want, t_inputs, j_inputs, _ = _generate(weights, "int4_llm_bf16_head",
                                                     monkeypatch)
    np.testing.assert_array_equal(f_got, f_want)
    _check_sign_inputs(t_inputs, j_inputs)
    assert (q_got != f_got).any() and (q_want != f_want).any()


def test_pipeline_kv_int8_surface(weights):
    """T2IPipeline(kv_int8=True).generate on the int4 bundle: uint8 images,
    ±1 tokens, the phase timing; on the CPU no kernel is launched."""
    from bitdance_tpu_torch.ops.decode_attention import decode_attention_fusedkv
    from bitdance_tpu_torch.ops.fused_head import fused_em_sample
    from bitdance_tpu_torch.ops.int4 import int4_matmul

    class Tok:
        def encode(self, text):
            return [3, 4, 5, 6, 7] if "cat" in text else [3, 9]

        def convert_tokens_to_ids(self, tok):
            return {"<|vision_start|>": 20, "<|res_4|>": 21}.get(tok, 31)

    _, tb = _bundles(weights, "int4")
    pipe = tt2i.T2IPipeline(tb, Tok(), kv_int8=True)
    counts = lambda: (decode_attention_fusedkv.launches, fused_em_sample.launches,  # noqa: E731
                      int4_matmul.launches)
    before = counts()
    img, tok = pipe.generate("A cat", 8, 8, num_sampling_steps=2,
                             guidance_scale=2.0, seed=3, return_tokens=True)
    assert img.dtype == np.uint8 and img.shape == (1, 8, 8, 3)
    assert tok.shape == (1, 16, 8) and set(np.unique(tok)) <= {-1.0, 1.0}
    assert set(pipe.last_timing) == {"prefill", "decode", "vae", "clock"}
    assert counts() == before
