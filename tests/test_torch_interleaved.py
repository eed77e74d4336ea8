"""The interleaved-generation slice against the JAX package on shared tiny
weights (fp32, carried through io/from_jax.py, lm_head and VQ encoder
included):

  - InterleavedGenerator.generate gives EXACTLY the JAX generator's text ids,
    ±1 image grids and last_spans on the canonical 5-item plan of
    tests/test_interleaved_plan.py and on example_interleaved.py's order, at
    cfg 2.0 (two streams, the whole sampler) and 1.0 (one stream, the
    per-call head), and at cfg 2.0 with the int8 LLM and int8 lm_head; the
    decoded images agree within IMAGE_TOL;
  - lm_logits agrees with JAX's (untied, tied, int8 embedding, int8
    lm_head) and raises where JAX reads the embedding of an untied model
    (C11); the weight bridge carries lm_head;
  - remove_first_user_block and plan_parity_matchable equal JAX's;
  - a plan longer than max_seq_len raises in the port, where the JAX cache
    update clamps and overwrites (C12).

Randomness: text is greedy (top_k=1), and every gaussian draw of the head
comes from a shape-keyed table on both sides (the pattern of
tests/test_torch_t2i.py: jax.random.normal patched, the port's
draw_sampler_noise given the same table). Guards: every sign input of the
port (head and encoder) clears SIGN_MARGIN and the port's head sign inputs
lie within that margin of JAX's; at each greedy step the port's top-2 logit
gap is more than twice the largest port-JAX logit difference.
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
from bitdance_tpu.pipelines import interleaved as jinter
from bitdance_tpu.pipelines import t2i as jt2i
from bitdance_tpu_torch.io.from_jax import flax_state_from_jax, load_into, qwen3_from_jax
from bitdance_tpu_torch.models import diff_head as tdh
from bitdance_tpu_torch.models import qwen3 as tq
from bitdance_tpu_torch.models import tokenizer as ttok
from bitdance_tpu_torch.models.connector import MLPConnector
from bitdance_tpu_torch.pipelines import interleaved as tinter
from bitdance_tpu_torch.pipelines import t2i as tt2i
from tests.test_t2i_pipeline import StubTokenizer

torch.set_num_threads(2)
TINY_DD = dict(z_channels=8, in_channels=3, out_ch=3, ch=32, ch_mult=[1, 2],
               num_res_blocks=1)
LLM = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           head_dim=16, rope_theta=10000.0)
HEAD = dict(ch_target=8, ch_cond=64, ch_latent=128, depth_latent=2,
            depth_adanln=2, parallel_num=4, use_swiglu=True)
NOISE_SEED = 66       # every sign input of every case clears SIGN_MARGIN
SIGN_MARGIN = 1e-3
IMAGE_TOL = 2e-4
STEPS, MAX_TEXT = 2, 4
USER_TEXT = "<|im_start|>user\nhello<|im_end|>\nassistant:"


class Tok(StubTokenizer):
    """tests/test_interleaved_plan.py's tokenizer: chat markers 190-192."""

    def __init__(self):
        super().__init__()
        for i, t in enumerate(("<|im_start|>", "<|im_end|>", "<|vision_end|>")):
            self.special[t] = 190 + i

    def decode(self, ids):
        return " ".join(str(i) for i in ids)


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


USER_IMAGE = np.random.default_rng(6).uniform(-1, 1, (8, 8, 3)).astype(np.float32)


def _plan(kind, item):
    ut = item(type="text", source="user", text=USER_TEXT)
    ui = item(type="image", source="user", image=USER_IMAGE)
    mt = item(type="text", source="model")
    mi = item(type="image", source="model", image_size=(8, 8))
    return {"canonical": [ut, mt, mi, ui, mt], "example": [ut, ui, mt, mi]}[kind]


@pytest.fixture(scope="module")
def weights():
    cfg = jq.Qwen3Config(**LLM)
    llm = jq.init_qwen3_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    hp = _randomized(JHead(**HEAD).init(jax.random.PRNGKey(1), jnp.zeros((2, 4, 8)),
                                        jnp.zeros((2, 4, 64)), jax.random.PRNGKey(2)), 3)
    aep = JVQ(ddconfig=TINY_DD).init(jax.random.PRNGKey(4), jnp.zeros((1, 8, 8, 3)))
    pp = _randomized(JConnector(out_dim=64).init(jax.random.PRNGKey(5),
                                                 jnp.zeros((1, 8))), 6, 0.2)
    return cfg, llm, hp, aep, pp


def _bundles(weights, llm_mode):
    cfg, llm, hp, aep, pp = weights
    if llm_mode == "int8":
        llm = jq.quantize_qwen3_params(llm)          # lm_head int8 too
    jb = jt2i.T2IModelBundle(
        llm_cfg=cfg, llm_params=llm, ae=JVQ(ddconfig=TINY_DD), ae_params=aep,
        head=JHead(**HEAD), head_params=hp, projector=JConnector(out_dim=64),
        projector_params=pp, parallel_num=4, hidden_size=64, vae_patch_size=2,
        pe_max_len=64)
    tb = tt2i.T2IModelBundle(
        llm=qwen3_from_jax(tq.Qwen3Config(**LLM), llm),
        ae=load_into(ttok.VQModel(TINY_DD, encoder=True), flax_state_from_jax(aep)),
        head=load_into(tdh.DiffHead(**HEAD), flax_state_from_jax(hp)),
        projector=load_into(MLPConnector(8, 64), flax_state_from_jax(pp)),
        parallel_num=4, hidden_size=64, vae_patch_size=2, pe_max_len=64)
    return jb, tb


CASES = [("canonical", 2.0, "f32"), ("canonical", 1.0, "f32"), ("example", 2.0, "f32"),
         ("example", 1.0, "f32"), ("canonical", 2.0, "int8")]


def _spy(record, fn, conv):
    def wrapped(*args):
        out = fn(*args)
        record.append(conv(args[-1], out))
        return out
    return wrapped


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-cfg{c[1]}-{c[2]}")
def run(request, weights):
    """One plan through both generators; the spies' records beside each."""
    plan_kind, cfg_scale, llm_mode = request.param
    jb, tb = _bundles(weights, llm_mode)
    kw = dict(cfg_scale=cfg_scale, sample_steps=STEPS, max_length_text=MAX_TEXT,
              top_k=1, seed=0)
    rec = {k: [] for k in ("j_sign", "j_logits", "t_sign", "t_enc", "t_logits")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", lambda key, shape=(), dtype=jnp.float32:
                   jnp.asarray(_shaped_noise(tuple(shape)), dtype))
        mp.setattr(jinter, "sign_quantize", _spy(
            rec["j_sign"], jinter.sign_quantize, lambda x, y: (np.asarray(x), np.asarray(y))))
        mp.setattr(jq, "lm_logits", _spy(rec["j_logits"], jq.lm_logits,
                                         lambda h, y: np.asarray(y)))
        jgen = jinter.InterleavedGenerator(jb, Tok(), max_seq_len=256)
        jout = jgen.generate(_plan(plan_kind, jinter.PlanItem), **kw)

        def table_noise(generator, half, ch, num_steps, device):
            t = torch.from_numpy(_shaped_noise((1, half, ch))).reshape(half, ch)
            return t.clone(), t[None].repeat(num_steps, 1, 1)

        mp.setattr(tdh, "draw_sampler_noise", table_noise)
        mp.setattr(tinter, "sign_quantize", _spy(
            rec["t_sign"], tinter.sign_quantize, lambda x, y: x.float().numpy().copy()))
        mp.setattr(ttok, "sign_quantize", _spy(
            rec["t_enc"], ttok.sign_quantize, lambda x, y: x.float().numpy().copy()))
        mp.setattr(tq, "lm_logits", _spy(rec["t_logits"], tq.lm_logits,
                                         lambda h, y: y.numpy().copy()))
        tgen = tinter.InterleavedGenerator(tb, Tok(), max_seq_len=256)
        tout = tgen.generate(_plan(plan_kind, tinter.PlanItem), **kw)
    return dict(case=request.param, jgen=jgen, jout=jout, tgen=tgen, tout=tout, **rec)


def test_text_ids_exact(run):
    assert run["tout"]["generated_text"] == run["jout"]["generated_text"]
    n = [len(t.split()) for t in run["tout"]["generated_text"]]
    assert max(n) >= 2, f"every text span stopped early: {n}"


def test_image_grids_exact(run):
    """The ±1 grids the port decoded equal the sign outputs of the JAX run,
    image by image (4 AR steps of 4 tokens each)."""
    j = [y[0] for _, y in run["j_sign"]]
    want = [np.concatenate(j[i:i + 4]) for i in range(0, len(j), 4)]
    got = [g.numpy() for g in run["tgen"].last_image_tokens]
    assert len(got) == len(want) == 1
    for g, w in zip(got, want):
        assert g.shape == (16, 8) and set(np.unique(g)) <= {-1.0, 1.0}
        np.testing.assert_array_equal(g, w)


def test_last_spans_exact_and_paired(run):
    spans = run["tgen"].last_spans
    assert spans == run["jgen"].last_spans
    by = {"cond": [], "uncond": []}
    for name, *rest in spans:
        by[name].append(rest)
    if run["case"][1] <= 1.0:
        assert by["uncond"] == []
        return
    tok = Tok()
    clen = {i: e - s for i, _, s, e in by["cond"]}
    ulen = {i: e - s for i, _, s, e in by["uncond"]}
    assert clen[0] == len(tok.encode(USER_TEXT))
    assert ulen[0] == len(tok.encode(tinter.remove_first_user_block(USER_TEXT)))
    delta = clen[0] - ulen[0]
    for (_, _, _, ce), (_, _, _, ue) in zip(by["cond"], by["uncond"]):
        assert ce - ue == delta
    for i, kind, s, e in by["cond"]:
        assert {"user_image": 3 + 16 + 1, "model_image": 2 + 4 + 16}.get(kind, e - s) == e - s


def test_images_close(run):
    got, want = run["tout"]["generated_image"], run["jout"]["generated_image"]
    assert len(got) == len(want) == 1
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == (8, 8, 3)
        np.testing.assert_allclose(g, w, rtol=IMAGE_TOL, atol=IMAGE_TOL)


def test_guards(run):
    """Exactness rests on margins, not on one machine's bits."""
    t_sign, j_in = run["t_sign"], [x for x, _ in run["j_sign"]]
    assert len(t_sign) == len(j_in) == 4
    margin = min(float(np.abs(x).min()) for x in t_sign + run["t_enc"])
    gap = max(float(np.abs(t - j.reshape(t.shape)).max()) for t, j in zip(t_sign, j_in))
    assert margin > SIGN_MARGIN and gap < margin, (margin, gap)
    user_images = sum(i.type == "image" and i.source == "user"
                      for i in _plan(run["case"][0], tinter.PlanItem))
    assert len(run["t_enc"]) == user_images
    assert len(run["t_logits"]) == len(run["j_logits"]) >= 3
    for t, j in zip(run["t_logits"], run["j_logits"]):
        top2 = np.sort(t[0])[-2:]
        diff = float(np.abs(t - j).max())
        assert top2[1] - top2[0] > max(2 * diff, 1e-5), (top2, diff)


# ---- lm_logits and the weight bridge ---------------------------------------

def _hidden(n=3):
    return np.random.default_rng(11).standard_normal((n, 64)).astype(np.float32)


@pytest.mark.parametrize("kind", ["untied", "tied", "tied_int8_embed", "int8_lm_head"])
def test_lm_logits_matches_jax(weights, kind):
    cfg, llm, *_ = weights
    if kind.startswith("tied"):
        cfg = jq.Qwen3Config(**LLM, tie_word_embeddings=True)
        llm = {k: v for k, v in llm.items() if k != "lm_head"}
    if kind == "tied_int8_embed":
        from bitdance_tpu.ops.int8 import quantize_linear

        llm = dict(llm, embed_tokens=quantize_linear(llm["embed_tokens"]))
    if kind == "int8_lm_head":
        llm = jq.quantize_qwen3_params(llm)
    tm = qwen3_from_jax(tq.Qwen3Config(**{**LLM, "tie_word_embeddings": cfg.tie_word_embeddings}),
                        llm)
    assert isinstance(getattr(tm, "lm_head", None),
                      {"untied": torch.nn.Linear, "int8_lm_head": tq.QLinear}.get(kind,
                                                                                  type(None)))
    h = _hidden()
    with torch.no_grad():
        got = tq.lm_logits(tm, torch.from_numpy(h))
    want = np.asarray(jq.lm_logits(llm, cfg, jnp.asarray(h)))
    assert got.dtype == torch.float32 and got.shape == (3, 512)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_lm_logits_raises_without_a_text_head(weights):
    """C11: an untied model that lost its lm_head (the int4 quantizer drops
    it) has no text head. JAX silently reads the embedding there; the port's
    lm_logits raises, and so does a plan that generates text."""
    cfg, llm, *_ = weights
    j4 = jq.quantize_qwen3_params_int4(llm)
    assert "lm_head" not in j4 and not cfg.tie_word_embeddings
    assert np.asarray(jq.lm_logits(j4, cfg, jnp.asarray(_hidden()))).shape == (3, 512)
    for tm in (qwen3_from_jax(tq.Qwen3Config(**LLM), j4),
               tq.quantize_qwen3_(qwen3_from_jax(tq.Qwen3Config(**LLM), llm), "int4")):
        assert not hasattr(tm, "lm_head")
        with pytest.raises(ValueError, match="no text head"):
            tq.lm_logits(tm, torch.from_numpy(_hidden()))
    _, tb = _bundles(weights, "f32")
    tq.quantize_qwen3_(tb.llm, "int4")
    with pytest.raises(ValueError, match="no lm_head"):
        tinter.InterleavedGenerator(tb, Tok(), 64).generate(
            _plan("example", tinter.PlanItem), cfg_scale=2.0, sample_steps=1)


def test_quantize_qwen3_int8_makes_the_jax_lm_head(weights):
    """quantize_qwen3_(int8) turns lm_head into the bytes of JAX's
    quantize_qwen3_params(quantize_lm_head=True); the bridge round-trips a
    float lm_head through the port's state dict and JAX's converter."""
    from bitdance_tpu.io.torch_import import convert_qwen3_state

    _, llm, *_ = weights
    tm = qwen3_from_jax(tq.Qwen3Config(**LLM), llm)
    np.testing.assert_array_equal(tm.lm_head.weight.detach().numpy(),
                                  np.asarray(llm["lm_head"]).T)
    back = convert_qwen3_state(tm.state_dict(), LLM["num_hidden_layers"], dtype=jnp.float32)
    np.testing.assert_array_equal(np.asarray(back["lm_head"]), np.asarray(llm["lm_head"]))
    tq.quantize_qwen3_(tm, "int8")
    j8 = jq.quantize_qwen3_params(llm)["lm_head"]
    np.testing.assert_array_equal(tm.lm_head.q.numpy(), np.asarray(j8.q).T)
    np.testing.assert_array_equal(tm.lm_head.s.numpy(), np.asarray(j8.s).reshape(-1))


# ---- helpers and the cache bound -------------------------------------------

TEXTS = ["<|im_start|>user\nA<|im_end|>\n<|im_start|>user\nB<|im_end|>\n",
         "no block", "<|im_start|>user\nX", USER_TEXT, "",
         "sys<|im_start|>user\nhi<|im_end|>\n<|im_start|>assistant\n",
         "<|im_start|>user\n<|im_end|>\n"]


@pytest.mark.parametrize("text", TEXTS)
def test_remove_first_user_block_equals_jax(text):
    assert tinter.remove_first_user_block(text) == jinter.remove_first_user_block(text)


@pytest.mark.parametrize("plan", ["ut mi", "ut mt", "ut mt mt", "ut mt mi", "ut mi mi",
                                  "ut mi mt", "ut ui mt mi", "ut mt mi ui mt", "ui mi ut",
                                  "mi", ""])
def test_plan_parity_matchable_equals_jax(plan):
    def build(item):
        kinds = {"ut": ("text", "user"), "ui": ("image", "user"),
                 "mt": ("text", "model"), "mi": ("image", "model")}
        return [item(type=kinds[k][0], source=kinds[k][1]) for k in plan.split()]

    assert (tinter.plan_parity_matchable(build(tinter.PlanItem))
            == jinter.plan_parity_matchable(build(jinter.PlanItem)))


def test_plan_longer_than_the_cache_raises(weights):
    """C12: the JAX cache update clamps a start past the end and overwrites
    the newest slots without a word; the port's generator raises before the
    span that would not fit, and plan_slots sizes a cache that fits."""
    cfg, llm, *_ = weights
    cache = jq.init_kv_cache(cfg, 1, 8)
    emb = jnp.ones((1, 4, 64), jnp.float32)
    _, after = jq.qwen3_forward_cached(llm, cfg, emb, jnp.arange(6, 10)[None], cache,
                                       jnp.int32(6), jnp.zeros((1,), jnp.int32), causal_block=True)
    assert np.abs(np.asarray(after["k"][:, :, :, 4:6])).max() > 0   # clamped to 4

    _, tb = _bundles(weights, "f32")
    tok = Tok()
    plan = _plan("example", tinter.PlanItem)
    need = tinter.plan_slots(plan, tok, tb, MAX_TEXT)
    assert need == len(tok.encode(USER_TEXT)) + (3 + 16 + 1) + MAX_TEXT + (2 + 4 + 16)
    small = len(tok.encode(USER_TEXT)) + 10      # the user image does not fit
    with pytest.raises(ValueError, match="past max_seq_len"):
        tinter.InterleavedGenerator(tb, tok, small).generate(
            plan, cfg_scale=2.0, sample_steps=1, max_length_text=MAX_TEXT)
    gen = tinter.InterleavedGenerator(tb, tok, need)
    gen.generate(plan, cfg_scale=2.0, sample_steps=1, max_length_text=MAX_TEXT)
    assert max(e for *_, e in gen.last_spans) <= need
