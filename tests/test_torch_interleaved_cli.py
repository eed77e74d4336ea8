"""The interleaved slice's entry points on the CPU: cli/common.py's PNG
reader against PIL (every filter type PIL writes, RGB and RGBA, the refused
kinds), load_t2i_pipeline(interleaved=True) keeping the lm_head and the VQ
encoder that the default still drops, and cli.interleaved on a tiny exported
release directory, whose text and PNG equal an in-memory run of the loaded
pipeline on the same plan and seed."""

import io
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from bitdance_tpu_torch.cli import interleaved as cli
from bitdance_tpu_torch.cli.common import read_png
from bitdance_tpu_torch.cli.t2i import write_png
from bitdance_tpu_torch.io.random_init import build_random_bundle
from bitdance_tpu_torch.io.safetensors import save_file
from bitdance_tpu_torch.models.qwen3 import QLinear, Qwen3Config
from bitdance_tpu_torch.pipelines.interleaved import InterleavedGenerator, plan_slots
from bitdance_tpu_torch.pipelines.loader import load_t2i_pipeline
from bitdance_tpu_torch.train.checkpoints import export_hf_qwen3, export_release_dir
from tests.test_t2i_pipeline import StubTokenizer

torch.set_num_threads(2)
TINY_DD = dict(z_channels=8, in_channels=3, out_ch=3, ch=32, ch_mult=[1, 2],
               num_res_blocks=1)
GEOMETRY = dict(parallel_num=4, vae_patch_size=2, ddconfig=TINY_DD,
                head=dict(ch_target=8, ch_cond=64, ch_latent=128, depth_latent=2,
                          depth_adanln=2, parallel_num=4, use_swiglu=True))
LLM = Qwen3Config(vocab_size=512, hidden_size=64, intermediate_size=128,
                  num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                  head_dim=16, rope_theta=10000.0)


class Tok(StubTokenizer):
    def __init__(self):
        super().__init__()
        for i, t in enumerate(("<|im_start|>", "<|im_end|>", "<|vision_end|>")):
            self.special[t] = 190 + i

    def decode(self, ids):
        return " ".join(str(i) for i in ids)


def _filters(data: bytes) -> set:
    """The row filter types of a PNG file's image data."""
    pos, idat = 8, b""
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IHDR":
            w, h, _, color = struct.unpack(">IIBB", data[pos + 8:pos + 18])
        elif kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    stride = 1 + w * (3 if color == 2 else 4)
    raw = zlib.decompress(idat)
    return {raw[y * stride] for y in range(h)}


def _photo(seed: int, side: int = 48) -> np.ndarray:
    """Gradients, noise rows, a noisy row repeated down (vertical stripes)
    and a flat patch: PIL's optimizer then picks every one of the five
    filters somewhere."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 255, side)
    img = np.stack([x[None, :] + 0 * x[:, None], x[:, None] + 0 * x[None, :],
                    x[None, :] * x[:, None] / 255], -1)
    img[side // 4:side // 3] = rng.integers(0, 256, (side // 3 - side // 4, side, 3))
    img[side // 3:side // 2] = rng.integers(0, 256, (1, side, 3))
    img[side // 2:, side // 2:] = 77 + rng.integers(0, 9, (side - side // 2,) * 2 + (3,))
    return img.astype(np.uint8)


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
@pytest.mark.parametrize("optimize", [False, True])
def test_read_png_matches_pil(tmp_path, mode, optimize):
    img = _photo(1)
    if mode == "RGBA":
        img = np.dstack([img, 255 - img[..., :1]])
    path = tmp_path / "x.png"
    Image.fromarray(img).save(path, optimize=optimize)
    got = read_png(path)
    assert got.dtype == np.uint8 and got.shape == (48, 48, 3)
    np.testing.assert_array_equal(got, np.asarray(Image.open(path).convert("RGB")))
    if optimize:
        assert _filters(path.read_bytes()) == {0, 1, 2, 3, 4}


def test_read_png_reads_write_png_and_refuses_other_kinds(tmp_path):
    img = _photo(2, 20)
    write_png(tmp_path / "w.png", img)
    np.testing.assert_array_equal(read_png(tmp_path / "w.png"), img)
    for name, arr in (("grey", img[..., 0]), ("palette", None)):
        pil = (Image.fromarray(arr) if arr is not None
               else Image.fromarray(img).convert("P"))
        pil.save(tmp_path / f"{name}.png")
        with pytest.raises(ValueError, match="color type"):
            read_png(tmp_path / f"{name}.png")
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    bad = bytearray(buf.getvalue())
    bad[40] ^= 0xFF                          # inside the first IDAT chunk
    (tmp_path / "bad.png").write_bytes(bytes(bad))
    with pytest.raises(ValueError, match="CRC"):
        read_png(tmp_path / "bad.png")


@pytest.fixture(scope="module")
def release(tmp_path_factory):
    """A random tiny bundle with lm_head and encoder, exported as a release
    directory (fp32 LLM, the rest fp32 too), and a user image PNG."""
    root = tmp_path_factory.mktemp("interleaved_release")
    b = build_random_bundle("cpu", llm_cfg=LLM, geometry=GEOMETRY, dtype=torch.float32,
                            seed=3, lm_head=True, encoder=True)
    export_release_dir(str(root), ae=b.ae, head=b.head, projector=b.projector,
                       configs={"ae_config": {"ddconfig": TINY_DD, "gan_decoder": False},
                                "vision_head_config": GEOMETRY["head"]})
    export_hf_qwen3(b.llm, str(root))
    write_png(root / "user.png", _photo(3, 8))
    return root, b


def test_random_bundle_draws_lm_head_and_encoder_last(release):
    _, b = release
    plain = build_random_bundle("cpu", llm_cfg=LLM, geometry=GEOMETRY,
                                dtype=torch.float32, seed=3)
    assert not hasattr(plain.llm, "lm_head") and not hasattr(plain.ae, "encoder")
    own = plain.llm.state_dict() | {f"ae.{k}": v for k, v in plain.ae.state_dict().items()}
    full = b.llm.state_dict() | {f"ae.{k}": v for k, v in b.ae.state_dict().items()}
    assert set(full) - set(own) == {"lm_head.weight"} | {
        f"ae.{k}" for k in b.ae.state_dict() if k.startswith("encoder.")}
    for k, v in own.items():
        assert torch.equal(v, full[k]), k


@pytest.mark.parametrize("interleaved", [False, True])
@pytest.mark.parametrize("quantize_llm", [False, True])
def test_loader_keeps_the_text_head_and_encoder_only_when_asked(release, interleaved,
                                                                quantize_llm):
    root, b = release
    pipe = load_t2i_pipeline(str(root), dtype=torch.float32, quantize_llm=quantize_llm,
                             device="cpu", tokenizer=Tok(), interleaved=interleaved)
    llm, ae = pipe.bundle.llm, pipe.bundle.ae
    assert hasattr(llm, "lm_head") == interleaved == hasattr(ae, "encoder")
    if interleaved and quantize_llm:
        assert isinstance(llm.lm_head, QLinear)
    elif interleaved:
        assert torch.equal(llm.lm_head.weight, b.llm.lm_head.weight)
        assert torch.equal(ae.encoder.conv_in.weight, b.ae.encoder.conv_in.weight)


def test_loader_refuses_a_directory_without_lm_head(release, tmp_path):
    root, b = release
    for f in root.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    state = {k: v for k, v in b.llm.state_dict().items() if not k.startswith("lm_head.")}
    save_file(state, str(tmp_path / "model.safetensors"), dtype=torch.float32)
    load_t2i_pipeline(str(tmp_path), dtype=torch.float32, device="cpu", tokenizer=Tok())
    with pytest.raises(ValueError, match="no lm_head"):
        load_t2i_pipeline(str(tmp_path), dtype=torch.float32, device="cpu",
                          tokenizer=Tok(), interleaved=True)


@pytest.mark.parametrize("cfg,extra", [("2.0", []), ("1.0", ["--prompt", "Draw a cat."]),
                                       ("2.0", ["--quantize-llm"])])
def test_cli_equals_the_in_memory_generator(release, tmp_path, capsys, cfg, extra):
    root, _ = release
    out = tmp_path / "gen.png"
    argv = [str(root), "--image", str(root / "user.png"), "--image-size", "8",
            "--cfg", cfg, "--steps", "2", "--max-length-text", "3", "--seed", "5",
            "--device", "cpu", "--out", str(out), *extra]
    assert cli.main(argv, tokenizer=Tok()) == 0
    said = capsys.readouterr().out.splitlines()[0]

    pipe = load_t2i_pipeline(str(root), dtype=torch.bfloat16, device="cpu",
                             tokenizer=Tok(), interleaved=True,
                             quantize_llm="--quantize-llm" in extra)
    prompt = extra[1] if extra[:1] == ["--prompt"] else cli.PROMPT
    plan = cli.example_plan(prompt, read_png(root / "user.png"), 8)
    slots = plan_slots(plan, pipe.tokenizer, pipe.bundle, 3)
    gen = InterleavedGenerator(pipe.bundle, pipe.tokenizer, max_seq_len=slots)
    want = gen.generate(plan, cfg_scale=float(cfg), sample_steps=2, max_length_text=3,
                        seed=5)
    assert said == "model said: " + want["generated_text"][0]
    np.testing.assert_array_equal(read_png(out), cli.to_uint8(want["generated_image"][0]))
    assert [s[2] for s in gen.last_spans if s[0] == "cond"] == [
        "user_text", "user_image", "model_text", "model_image"]
    assert max(e for *_, e in gen.last_spans) <= slots
    assert set(gen.last_timing) == {"0:user_text", "1:user_image", "2:model_text",
                                    "3:model_image", "clock"}
