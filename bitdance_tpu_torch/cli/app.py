"""The demo server (port of the root app.py; the reference's app.py).

Two frontends over ``T2IPipeline.generate``, with the resolution list of
the 18 aspect-ratio buckets, steps, cfg, image count and seed:

  * :func:`build_demo`: a gradio Blocks app, when gradio is installed;
  * :func:`make_fallback_server`: a stdlib ``http.server`` with the same
    controls: ``GET /`` serves the page and ``POST /generate`` takes
    {prompt, resolution "HxW", steps, cfg, num_images, seed} and answers
    {"images": [base64 PNG, ...]}, or {"images": [], "error": "..."} when
    the request fails.

    python -m bitdance_tpu_torch.cli.app --model_path models/BitDance-14B-64x

serves the release directory from the card (``--device``) on
http://127.0.0.1:7860 (gradio's frontend with ``--gradio``).
"""

from __future__ import annotations

import argparse
import base64
import json
import sys

import numpy as np

from bitdance_tpu_torch.cli.common import png_bytes
from bitdance_tpu_torch.data.special_tokens import IMAGE_SIZE_LIST


def build_demo(pipe):
    try:
        import gradio as gr
    except ImportError as e:
        raise SystemExit(
            "gradio is not installed in this environment; "
            "run the app without --gradio to use the built-in server") from e

    resolutions = [f"{h}x{w}" for h, w in IMAGE_SIZE_LIST]

    def generate(prompt, resolution, steps, cfg, num_images, seed):
        h, w = map(int, resolution.split("x"))
        images = pipe.generate(prompt, height=h, width=w, num_sampling_steps=int(steps),
                               guidance_scale=float(cfg), num_images=int(num_images),
                               seed=int(seed))
        return list(images)

    with gr.Blocks(title="BitDance-TPU") as demo:
        gr.Markdown("# BitDance-TPU text-to-image")
        with gr.Row():
            with gr.Column():
                prompt = gr.Textbox(label="Prompt", lines=3)
                resolution = gr.Dropdown(resolutions, value="1024x1024",
                                         label="Resolution (HxW)")
                steps = gr.Slider(10, 100, value=50, step=1, label="Sampling steps")
                cfg = gr.Slider(1.0, 20.0, value=7.5, step=0.5, label="Guidance scale")
                num_images = gr.Slider(1, 4, value=1, step=1, label="Images")
                seed = gr.Number(value=1234, label="Seed", precision=0)
                btn = gr.Button("Generate", variant="primary")
            gallery = gr.Gallery(label="Results", columns=2)
        btn.click(generate, [prompt, resolution, steps, cfg, num_images, seed], gallery)
    return demo


_PAGE = """<!doctype html>
<html><head><title>BitDance-TPU</title><style>
body {{ font-family: sans-serif; max-width: 960px; margin: 2em auto; }}
label {{ display: block; margin-top: .8em; }}
#gallery img {{ max-width: 45%; margin: .5em; image-rendering: pixelated; }}
#status {{ color: #666; margin-top: 1em; }}
</style></head><body>
<h1>BitDance-TPU text-to-image</h1>
<form id="f">
<label>Prompt <textarea id="prompt" rows="3" cols="70"></textarea></label>
<label>Resolution (HxW) <select id="resolution">{options}</select></label>
<label>Sampling steps <input id="steps" type="number" value="50"
  min="10" max="100"></label>
<label>Guidance scale <input id="cfg" type="number" value="7.5"
  min="1.0" max="20.0" step="0.5"></label>
<label>Images <input id="num_images" type="number" value="1" min="1"
  max="4"></label>
<label>Seed <input id="seed" type="number" value="1234"></label>
<button id="generate" type="submit">Generate</button>
</form>
<div id="status"></div>
<div id="gallery"></div>
<script>
document.getElementById('f').addEventListener('submit', async (e) => {{
  e.preventDefault();
  const g = (id) => document.getElementById(id).value;
  document.getElementById('status').textContent = 'generating...';
  const r = await fetch('/generate', {{method: 'POST',
    headers: {{'Content-Type': 'application/json'}},
    body: JSON.stringify({{prompt: g('prompt'), resolution: g('resolution'),
      steps: +g('steps'), cfg: +g('cfg'), num_images: +g('num_images'),
      seed: +g('seed')}})}});
  const out = await r.json();
  const gal = document.getElementById('gallery');
  gal.innerHTML = '';
  for (const b64 of out.images) {{
    const img = document.createElement('img');
    img.src = 'data:image/png;base64,' + b64;
    gal.appendChild(img);
  }}
  document.getElementById('status').textContent =
    out.error ? ('error: ' + out.error) : (out.images.length + ' image(s)');
}});
</script></body></html>
"""


def make_fallback_server(pipe, port: int = 7860, resolutions=None, host: str = "127.0.0.1"):
    """The stdlib HTTP server of the demo, not yet started (call
    ``serve_forever()``; port 0 takes a free port, ``server_address`` says
    which). Requests are served one thread each; their generate calls run
    one at a time, since they share the pipeline and its card."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    lock = threading.Lock()

    res_list = resolutions or [f"{h}x{w}" for h, w in IMAGE_SIZE_LIST]
    options = "".join(
        f'<option value="{r}"{" selected" if r == "1024x1024" else ""}>{r}</option>'
        for r in res_list)
    page = _PAGE.format(options=options).encode()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, body, ctype):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                self._send(200, page, "text/html; charset=utf-8")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/generate":
                self._send(404, b"not found", "text/plain")
                return
            n = int(self.headers.get("Content-Length", "0"))
            try:
                req = json.loads(self.rfile.read(n) or b"{}")
                h, w = map(int, str(req.get("resolution", "1024x1024")).split("x"))
                with lock:
                    images = pipe.generate(
                        str(req.get("prompt", "")), height=h, width=w,
                        num_sampling_steps=int(req.get("steps", 50)),
                        guidance_scale=float(req.get("cfg", 7.5)),
                        num_images=int(req.get("num_images", 1)),
                        seed=int(req.get("seed", 1234)))
                b64s = [base64.b64encode(png_bytes(np.asarray(img, np.uint8))).decode()
                        for img in np.asarray(images)]
                body = json.dumps({"images": b64s}).encode()
            except Exception as e:  # the page shows the error
                body = json.dumps({"images": [], "error": str(e)}).encode()
            self._send(200, body, "application/json")

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None, tokenizer=None) -> int:
    """Load the release directory and serve it until interrupted;
    ``tokenizer`` replaces the directory's HF tokenizer."""
    p = argparse.ArgumentParser(description="BitDance text-to-image demo")
    p.add_argument("--model_path", type=str, default="models/BitDance-14B-64x")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--gradio", action="store_true",
                   help="force the gradio frontend (default: gradio when importable, "
                        "else the stdlib server)")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    from bitdance_tpu_torch.cli.common import require_device
    from bitdance_tpu_torch.pipelines.loader import load_t2i_pipeline

    pipe = load_t2i_pipeline(args.model_path, device=require_device(args.device),
                             tokenizer=tokenizer)
    try:
        import gradio  # noqa: F401
        has_gradio = True
    except ImportError:
        has_gradio = False
    if args.gradio or has_gradio:
        build_demo(pipe).launch(server_name="0.0.0.0", server_port=args.port)
        return 0
    srv = make_fallback_server(pipe, args.port)
    print(f"gradio not installed; serving the stdlib fallback UI on "
          f"http://127.0.0.1:{srv.server_address[1]}", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
