"""Package boundary of the port: no JAX and nothing of bitdance_tpu, in the
source and at import time (the port keeps its own special_tokens, which
gives the JAX module's results; the release readers need no safetensors or
transformers package); the weight bridge round-trips; the kernels'
no-backward guard is a pure predicate."""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
ALLOWED_FROM_JAX_PACKAGE: set = set()

torch.set_num_threads(2)


def _port_files():
    files = sorted((ROOT / "bitdance_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"] + sorted((ROOT / "scripts").glob("torch_*.py"))


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.module == "bitdance_tpu" or node.module == "bitdance_tpu.data":
                for a in node.names:
                    yield f"{node.module}.{a.name}"
            else:
                yield node.module


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_port_imports_no_jax(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "optax", "orbax"), (path, mod)
        if top == "bitdance_tpu":
            assert mod in ALLOWED_FROM_JAX_PACKAGE, (path, mod)


# modules added with kernel #5 and the release directory; the AST check
# above covers every file, this list makes sure none of them goes missing
RELEASE_SLICE_MODULES = (
    "bitdance_tpu_torch.cli.t2i", "bitdance_tpu_torch.io.release",
    "bitdance_tpu_torch.io.safetensors", "bitdance_tpu_torch.pipelines.loader",
    "bitdance_tpu_torch.train.checkpoints", "bitdance_tpu_torch.utils.precision",
)
# the training entry points (ROADMAP A10) and their support modules
TRAINING_SLICE_MODULES = (
    "bitdance_tpu_torch.cli.common", "bitdance_tpu_torch.cli.sample_fid",
    "bitdance_tpu_torch.cli.train_imagenet", "bitdance_tpu_torch.cli.train_mllm",
    "bitdance_tpu_torch.config", "bitdance_tpu_torch.data.imagenet",
    "bitdance_tpu_torch.data.native", "bitdance_tpu_torch.eval.fid",
    "bitdance_tpu_torch.train.tokenizer_train", "bitdance_tpu_torch.utils.fs",
    "bitdance_tpu_torch.utils.logging", "bitdance_tpu_torch.utils.profiler",
)
# interleaved generation (ROADMAP A12)
INTERLEAVED_SLICE_MODULES = (
    "bitdance_tpu_torch.cli.interleaved", "bitdance_tpu_torch.ops.token_sampling",
    "bitdance_tpu_torch.pipelines.interleaved",
)
# tensor-parallel serving (ROADMAP A11b)
TP_SLICE_MODULES = ("bitdance_tpu_torch.parallel.mesh", "bitdance_tpu_torch.parallel.tp")
# the tokenizer family and the head leftovers (ROADMAP A5 / A9, A2 / A3)
TOKENIZER_SLICE_MODULES = (
    "bitdance_tpu_torch.models.tokenizer_uni", "bitdance_tpu_torch.models.vt_encode",
    "bitdance_tpu_torch.models.alt_heads", "bitdance_tpu_torch.cli.recon",
    "bitdance_tpu_torch.eval.recon",
)


def test_every_port_module_imports_without_jax():
    """Import every module of the port in a fresh process where importing
    jax, flax, optax, orbax, safetensors, transformers or bitdance_tpu
    raises: no module reaches them at import time, directly or not."""
    import subprocess
    import sys

    files = sorted((ROOT / "bitdance_tpu_torch").rglob("*.py"))
    mods = [".".join(f.relative_to(ROOT).with_suffix("").parts) for f in files]
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m for m in mods]
    assert set(RELEASE_SLICE_MODULES) <= set(mods)
    assert set(TRAINING_SLICE_MODULES) <= set(mods)
    assert set(INTERLEAVED_SLICE_MODULES) <= set(mods)
    assert set(TP_SLICE_MODULES) <= set(mods)
    assert set(TOKENIZER_SLICE_MODULES) <= set(mods)
    script = (
        "import importlib, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'orbax',\n"
        "                                  'safetensors', 'transformers', 'bitdance_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok', len(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0 and res.stdout.startswith("ok"), res.stderr[-3000:]


class _StubTokenizer:
    """Ids for any token string, the same on both sides."""

    def convert_tokens_to_ids(self, tok):
        return sum(ord(c) * (i + 1) for i, c in enumerate(tok))


def test_special_tokens_module_is_jax_free():
    """The port's special_tokens gives the JAX module's results (chatml
    prompts; image start ids at 512 and 1024 px for parallel_num 16 and 64)."""
    import bitdance_tpu.data.special_tokens as jst
    import bitdance_tpu_torch.data.special_tokens as tst

    for prompt in ("A cat", "", "a lighthouse at dusk, 1024\nsecond line"):
        assert tst.chatml_prompts(prompt) == jst.chatml_prompts(prompt)
    tok = _StubTokenizer()
    for px in (512, 1024):
        for p in (16, 64):
            got = tst.image_start_ids(tok, px // 16, px // 16, p)
            assert got == jst.image_start_ids(tok, px // 16, px // 16, p)
            assert len(got) == 2 + p
    assert tst.IMAGE_SIZE_LIST == jst.IMAGE_SIZE_LIST
    assert not [m for m in _imports(Path(tst.__file__))
                if m.split(".")[0] in ("jax", "flax", "bitdance_tpu")]


def _np(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _assert_tree_equal(got, want, path=""):
    assert set(got) == set(want), (path, sorted(set(got) ^ set(want)))
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                          err_msg=f"{path}/{k}")


def _rand_tree(tree, seed):
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(rng.normal(size=l.shape), jnp.float32) for l in leaves])


def test_round_trip_qwen3():
    from bitdance_tpu.io.torch_import import convert_qwen3_state
    from bitdance_tpu.models import qwen3 as jq
    from bitdance_tpu_torch.io.from_jax import load_into, qwen3_state_from_jax
    from bitdance_tpu_torch.models import qwen3 as tq

    cfg = jq.Qwen3Config.tiny(vocab_size=32)
    params = _rand_tree(jq.init_qwen3_params(jax.random.PRNGKey(0), cfg), 0)
    params.pop("lm_head")
    tm = load_into(tq.Qwen3Model(tq.Qwen3Config.tiny(vocab_size=32)),
                   qwen3_state_from_jax(params))
    back = convert_qwen3_state(tm.state_dict(), cfg.num_hidden_layers,
                               dtype=jnp.float32)
    _assert_tree_equal(back, params)


def test_round_trip_head_projector_and_vq_decoder():
    from bitdance_tpu.io.torch_import import (
        convert_ae_state,
        convert_diffhead_state,
        convert_projector_state,
    )
    from bitdance_tpu.models.connector import MLPConnector as JC
    from bitdance_tpu.models.diff_head import DiffHead as JH
    from bitdance_tpu.models.tokenizer import VQModel as JVQ
    from bitdance_tpu_torch.io.from_jax import flax_state_from_jax, load_into
    from bitdance_tpu_torch.models.connector import MLPConnector
    from bitdance_tpu_torch.models.diff_head import DiffHead
    from bitdance_tpu_torch.models.tokenizer import VQModel

    kw = dict(ch_target=8, ch_cond=16, ch_latent=128, depth_latent=2,
              depth_adanln=2, parallel_num=4, use_swiglu=True)
    hp = _rand_tree(JH(**kw).init(jax.random.PRNGKey(1), jnp.zeros((2, 4, 8)),
                                  jnp.zeros((2, 4, 16)), jax.random.PRNGKey(2)), 1)
    th = load_into(DiffHead(**kw), flax_state_from_jax(hp))
    _assert_tree_equal(convert_diffhead_state(_np(th)), hp)

    pp = _rand_tree(JC(out_dim=16).init(jax.random.PRNGKey(3), jnp.zeros((1, 8))), 2)
    tp = load_into(MLPConnector(8, 16), flax_state_from_jax(pp))
    _assert_tree_equal(convert_projector_state(_np(tp)), pp)

    dd = dict(z_channels=8, in_channels=3, out_ch=3, ch=32, ch_mult=[1, 2],
              num_res_blocks=1)
    ap = _rand_tree(JVQ(ddconfig=dd).init(jax.random.PRNGKey(4),
                                          jnp.zeros((1, 4, 4, 8)),
                                          method=JVQ.decode), 3)
    ta = load_into(VQModel(dd), flax_state_from_jax(ap))
    _assert_tree_equal(convert_ae_state(_np(ta)), ap)


def test_no_grad_guard_is_a_pure_predicate():
    from bitdance_tpu_torch.ops._cuda import needs_grad, refuse_grad

    w = torch.zeros(3, requires_grad=True)
    x = torch.zeros(3)
    assert needs_grad(x, w)
    assert not needs_grad(x, None)
    with torch.no_grad():
        assert not needs_grad(x, w)
        refuse_grad("k", x, w)                        # fine without grad
    with pytest.raises(RuntimeError, match="no backward"):
        refuse_grad("k", x, w)


def test_kernel_wrappers_refuse_non_cuda_non_cpu_devices():
    from bitdance_tpu_torch.ops.decode_attention import (
        decode_attention,
        decode_attention_fusedkv,
    )
    from bitdance_tpu_torch.ops.fused_head import fused_em_sample
    from bitdance_tpu_torch.ops.int4 import Q4Tensor, int4_matmul

    q = torch.zeros((1, 1, 2, 128), device="meta")
    k = torch.zeros((1, 1, 4, 128), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        decode_attention(q, k, k, torch.ones(1, dtype=torch.int32))
    kv = torch.zeros((1, 1, 4, 256), dtype=torch.int8, device="meta")
    sc = torch.zeros((1, 1, 2, 4), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        decode_attention_fusedkv(q, kv, torch.ones(1, dtype=torch.int32), None, sc)
    w = Q4Tensor(torch.zeros((64, 64), dtype=torch.int8, device="meta"),
                 torch.zeros(64, device="meta"))
    with pytest.raises(RuntimeError, match="no kernel"):
        int4_matmul(torch.zeros((4, 128), device="meta"), w)
    x0 = torch.zeros((4, 8), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        fused_em_sample({}, x0, torch.zeros((2, 4, 8), device="meta"), None,
                        [0.0, 0.5, 0.9], [0.5, 0.4, 0.0], 2.0, num_blocks=2,
                        num_ada=2, quant="int4")
    from bitdance_tpu_torch.ops.fused_head import fused_diffnet_forward

    with pytest.raises(RuntimeError, match="no kernel"):
        fused_diffnet_forward({}, x0, torch.zeros(4, device="meta"), x0,
                              num_blocks=2, num_ada=2, attention=False)
