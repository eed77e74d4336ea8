"""The port's demo server (bitdance_tpu_torch/cli/app.py) on the CPU, against
the root app.py of the JAX package (tests/test_app.py).

The stdlib fallback servers of both packages on port 0 in threads: the same
page (the control ids, the resolution buckets), a generate round trip whose
images equal the port's ``T2IPipeline.generate``, the JAX app's answer to the
same request within one level (both pipelines loaded from one tiny JAX
export, fp32, every gaussian draw from a shape-keyed table, every sign input
clear of SIGN_MARGIN), the same error JSON, and ``main`` serving a release
directory.
"""

import base64
import io
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import app as jax_app
from bitdance_tpu_torch.cli import app as tapp
from tests.test_torch_eval import jax_export

CONTROLS = ("prompt", "resolution", "steps", "cfg", "num_images", "seed")
NOISE_SEED = 71       # every sign input of the compared request clears SIGN_MARGIN
SIGN_MARGIN = 1e-3
REQUEST = {"prompt": "a tiny cat", "resolution": "8x8", "steps": 4, "cfg": 2.0,
           "num_images": 2, "seed": 7}
torch.set_num_threads(2)


def _shaped_noise(shape):
    seed = NOISE_SEED
    for d in shape:
        seed = (seed * 131 + int(d) + 7) % (2**31 - 1)
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _serve(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{srv.server_address[1]}"


def _get(url) -> str:
    return urllib.request.urlopen(url, timeout=30).read().decode()


def _post(url, req: dict, path="/generate") -> dict:
    r = urllib.request.urlopen(urllib.request.Request(
        url + path, data=json.dumps(req).encode(),
        headers={"Content-Type": "application/json"}), timeout=600)
    return json.loads(r.read())


def _images(out: dict) -> np.ndarray:
    from PIL import Image

    assert not out.get("error"), out.get("error")
    return np.stack([np.asarray(Image.open(io.BytesIO(base64.b64decode(b))).convert("RGB"))
                     for b in out["images"]])


@pytest.fixture(scope="module")
def export(tmp_path_factory):
    from tests.test_torch_release import HEAD_JSON

    return jax_export(str(tmp_path_factory.mktemp("release")), HEAD_JSON)


@pytest.fixture(scope="module")
def servers(export):
    """Both servers on port 0 over the fp32 pipelines of the export."""
    from bitdance_tpu.pipelines.loader import load_t2i_pipeline as j_load
    from bitdance_tpu_torch.pipelines.loader import load_t2i_pipeline

    pipes = {"jax": j_load(export["dir"], dtype=jnp.float32),
             "port": load_t2i_pipeline(export["dir"], dtype=torch.float32, device="cpu")}
    srvs = {"jax": jax_app.make_fallback_server(pipes["jax"], port=0,
                                                resolutions=["8x8", "8x16"]),
            "port": tapp.make_fallback_server(pipes["port"], port=0,
                                              resolutions=["8x8", "8x16"])}
    yield {k: _serve(s) for k, s in srvs.items()}, pipes
    for s in srvs.values():
        s.shutdown()
        s.server_close()


def test_page_is_the_jax_apps(servers):
    urls, _ = servers
    page = _get(urls["port"] + "/")
    assert page == _get(urls["jax"] + "/")
    for needle in [f'id="{c}"' for c in CONTROLS] + [
            'id="generate"', 'id="gallery"', '<option value="8x8"', '<option value="8x16"']:
        assert needle in page, needle


def test_default_resolutions_are_the_18_buckets():
    from bitdance_tpu.data.special_tokens import IMAGE_SIZE_LIST

    pages = []
    for mod in (tapp, jax_app):
        srv = mod.make_fallback_server(object(), port=0)
        try:
            pages.append(_get(_serve(srv) + "/"))
        finally:
            srv.shutdown()
            srv.server_close()
    assert pages[0] == pages[1]
    assert pages[0].count("<option") == len(IMAGE_SIZE_LIST) == 18
    assert '<option value="1024x1024" selected>' in pages[0]


def test_generate_equals_the_pipelines(servers):
    """The server's PNGs decode to the images ``generate`` returns for the
    same request, and two requests give the same bytes."""
    urls, pipes = servers
    out = _post(urls["port"], REQUEST)
    got = _images(out)
    want = pipes["port"].generate("a tiny cat", 8, 8, num_sampling_steps=4,
                                  guidance_scale=2.0, num_images=2, seed=7)
    assert got.shape == (2, 8, 8, 3)
    np.testing.assert_array_equal(got, want)
    assert _post(urls["port"], REQUEST) == out


def test_generate_agrees_with_the_jax_app(servers, monkeypatch):
    """The same request to both servers under the shape-keyed draws: the
    port's images lie within one level of the JAX app's."""
    from bitdance_tpu_torch.models import diff_head as tdh
    from bitdance_tpu_torch.pipelines import t2i as tt2i

    urls, pipes = servers
    margins = []
    real_sign = tt2i.sign_quantize

    def table_noise(generator, half, ch, num_steps, device):
        t = torch.from_numpy(_shaped_noise((half // 4, 4, ch))).reshape(half, ch)
        return t.clone(), t[None].repeat(num_steps, 1, 1)

    def spy_sign(x):
        margins.append(float(x.abs().min()))
        return real_sign(x)

    monkeypatch.setattr(jax.random, "normal", lambda key, shape=(), dtype=jnp.float32:
                        jnp.asarray(_shaped_noise(tuple(shape)), dtype))
    monkeypatch.setattr(tdh, "draw_sampler_noise", table_noise)
    monkeypatch.setattr(tt2i, "sign_quantize", spy_sign)
    want = _images(_post(urls["jax"], REQUEST)).astype(int)
    got = _images(_post(urls["port"], REQUEST)).astype(int)
    assert len(margins) == 4 and min(margins) > SIGN_MARGIN, (
        f"borderline sign margin {min(margins)}: pick another NOISE_SEED")
    assert got.shape == want.shape == (2, 8, 8, 3)
    assert np.abs(got - want).max() <= 1


def test_errors_are_the_jax_apps(servers):
    """A request that fails answers {"images": [], "error": ...} on both
    servers, the same text; unknown paths are 404."""
    urls, _ = servers
    bad = dict(REQUEST, resolution="eight")
    outs = [_post(urls[k], bad) for k in ("port", "jax")]
    assert outs[0] == outs[1]
    assert outs[0]["images"] == [] and "invalid literal" in outs[0]["error"]
    for url in urls.values():
        for call in (lambda: _get(url + "/nope"), lambda: _post(url, REQUEST, "/other")):
            with pytest.raises(urllib.error.HTTPError) as e:
                call()
            assert e.value.code == 404


def test_build_demo_without_gradio(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_gradio(name, *a, **k):
        if name == "gradio":
            raise ImportError(name)
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_gradio)
    with pytest.raises(SystemExit, match="gradio is not installed in this environment"):
        tapp.build_demo(object())


def test_main_serves_a_release(export, monkeypatch):
    """``main`` loads the directory (bf16, the loader's default) and serves
    it: one request through the started server, then a shutdown."""
    from bitdance_tpu_torch.pipelines.loader import load_t2i_pipeline

    got = {}
    real = tapp.make_fallback_server

    def served(pipe, port=7860, resolutions=None, host="127.0.0.1"):
        assert port == 7860
        srv = real(pipe, 0, resolutions, host)

        def client():
            url = f"http://127.0.0.1:{srv.server_address[1]}"
            try:
                got["out"] = _post(url, REQUEST)
            finally:
                srv.shutdown()

        threading.Thread(target=client, daemon=True).start()
        return srv

    monkeypatch.setattr(tapp, "make_fallback_server", served)
    assert tapp.main(["--model_path", export["dir"], "--device", "cpu"],
                     tokenizer=export["tok"]) == 0
    want = load_t2i_pipeline(export["dir"], device="cpu", tokenizer=export["tok"]).generate(
        "a tiny cat", 8, 8, num_sampling_steps=4, guidance_scale=2.0, num_images=2, seed=7)
    np.testing.assert_array_equal(_images(got["out"]), want)
