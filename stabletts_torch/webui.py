"""Web UI for interactive synthesis (reference: webui.py:22-133).

The reference uses gradio; this is a dependency-free stdlib HTTP server (the
JAX package's `webui.py`, the same page but its title) exposing the same
control surface: text, reference audio upload, language, ODE steps,
temperature, length scale, solver, CFG — returning the waveform and a
mel-spectrogram plot. It serves the port's `StableTTSAPI` on the GPU unless
`--device cpu`; one synthesis runs at a time.

Usage: python -m stabletts_torch.webui --tts-ckpt ... --vocoder-ckpt ... [--port 7860] [--device cuda]
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import re
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

SOLVERS = [
    "euler", "midpoint", "heun2", "heun3", "rk4", "implicit_adams",
    "dopri5", "bosh3", "fehlberg2", "adaptive_heun",
]

_PAGE = """<!DOCTYPE html>
<html><head><title>StableTTS (PyTorch)</title><style>
body {{ font-family: sans-serif; max-width: 760px; margin: 2em auto; }}
label {{ display: block; margin-top: .8em; font-weight: bold; }}
textarea, input, select {{ width: 100%; box-sizing: border-box; }}
button {{ margin-top: 1em; padding: .6em 2em; }}
img {{ max-width: 100%; margin-top: 1em; }}
.row {{ display: flex; gap: 1em; }} .row > div {{ flex: 1; }}
</style></head><body>
<h2>StableTTS</h2>
<p>Next-generation TTS model using flow-matching and DiT, inspired by Stable Diffusion 3.</p>
<label>Text</label><textarea id="text" rows="4">Hello world, this is a test.</textarea>
<label>Reference audio (wav)</label><input type="file" id="ref" accept=".wav">
<div class="row">
  <div><label>Language</label><select id="language">
    <option>english</option><option>chinese</option><option>japanese</option><option>auto</option></select></div>
  <div><label>Solver</label><select id="solver">{solvers}</select></div>
</div>
<div class="row">
  <div><label>Steps (<span id="sv">25</span>)</label>
    <input type="range" id="step" min="1" max="100" value="25" oninput="sv.innerText=this.value"></div>
  <div><label>CFG (<span id="cv">3</span>)</label>
    <input type="range" id="cfg" min="0" max="10" step="0.5" value="3" oninput="cv.innerText=this.value"></div>
</div>
<div class="row">
  <div><label>Temperature (<span id="tv">1</span>)</label>
    <input type="range" id="temperature" min="0" max="2" step="0.05" value="1" oninput="tv.innerText=this.value"></div>
  <div><label>Length scale (<span id="lv">1</span>)</label>
    <input type="range" id="length_scale" min="0.5" max="5" step="0.05" value="1" oninput="lv.innerText=this.value"></div>
</div>
<button onclick="synth()">Synthesize</button>
<div id="status"></div>
<audio id="audio" controls style="width:100%; margin-top:1em; display:none"></audio>
<img id="mel" style="display:none">
<script>
async function synth() {{
  const status = document.getElementById('status');
  const refFile = document.getElementById('ref').files[0];
  if (!refFile) {{ status.innerText = 'choose a reference wav first'; return; }}
  status.innerText = 'synthesizing...';
  const buf = await refFile.arrayBuffer();
  const b64 = btoa(new Uint8Array(buf).reduce((s, b) => s + String.fromCharCode(b), ''));
  const body = {{
    text: document.getElementById('text').value,
    language: document.getElementById('language').value,
    solver: document.getElementById('solver').value,
    step: +document.getElementById('step').value,
    cfg: +document.getElementById('cfg').value,
    temperature: +document.getElementById('temperature').value,
    length_scale: +document.getElementById('length_scale').value,
    ref_audio_b64: b64,
  }};
  const r = await fetch('/synthesize', {{method: 'POST', body: JSON.stringify(body)}});
  if (!r.ok) {{ status.innerText = 'error: ' + await r.text(); return; }}
  const out = await r.json();
  status.innerText = 'done (' + out.seconds.toFixed(2) + 's of audio)';
  const a = document.getElementById('audio');
  a.src = 'data:audio/wav;base64,' + out.wav_b64; a.style.display = 'block';
  if (out.mel_png_b64) {{
    const m = document.getElementById('mel');
    m.src = 'data:image/png;base64,' + out.mel_png_b64; m.style.display = 'block';
  }}
}}
</script></body></html>
"""


def remove_newlines_after_punctuation(text: str) -> str:
    """(reference: webui.py:48-50)."""
    pattern = r"([，。！？、“”‘’《》【】；：,.!?\'\"<>()\[\]{}])\n"
    return re.sub(pattern, r"\1", text)


def plot_mel_png(mel: np.ndarray) -> bytes | None:
    """Mel [n_mels, T] -> PNG bytes (reference: webui.py:40-46).

    Uses the object-oriented matplotlib API only — no pyplot. pyplot's
    figure registry is global mutable state, and this runs on
    ThreadingHTTPServer worker threads outside the synthesis lock; two
    concurrent requests through pyplot can corrupt or close each other's
    figures."""
    try:
        from matplotlib.backends.backend_agg import FigureCanvasAgg
        from matplotlib.figure import Figure
    except Exception:
        return None
    fig = Figure(figsize=(20, 8))
    FigureCanvasAgg(fig)
    ax = fig.add_subplot()
    ax.imshow(mel, aspect="auto", origin="lower")
    ax.set_axis_off()
    fig.subplots_adjust(left=0, right=1, top=1, bottom=0)
    buf = io.BytesIO()
    fig.savefig(buf, format="png")
    return buf.getvalue()


def make_handler(api):
    from stabletts_torch.utils.audio_io import save_wav

    lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def do_GET(self):
            if self.path not in ("/", "/index.html"):
                self.send_error(404)
                return
            page = _PAGE.format(
                solvers="".join(f"<option>{s}</option>" for s in SOLVERS)
            ).encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(page)))
            self.end_headers()
            self.wfile.write(page)

        def do_POST(self):
            if self.path != "/synthesize":
                self.send_error(404)
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length))
                text = remove_newlines_after_punctuation(req["text"])
                if req["language"] == "chinese":
                    text = text.replace(" ", "")
                with tempfile.NamedTemporaryFile(suffix=".wav") as tmp:
                    tmp.write(base64.b64decode(req["ref_audio_b64"]))
                    tmp.flush()
                    with lock:  # one synthesis at a time (one card)
                        wav, mel = api.inference(
                            text, tmp.name, req["language"],
                            step=int(req.get("step", 25)),
                            temperature=float(req.get("temperature", 1.0)),
                            length_scale=float(req.get("length_scale", 1.0)),
                            solver=req.get("solver", "euler"),
                            cfg=float(req.get("cfg", 3.0)),
                        )
                audio = wav[0]
                peak = np.abs(audio).max()
                if peak > 1:
                    audio = audio / peak  # peak normalize (webui.py:32-34)
                buf = io.BytesIO()
                save_wav(buf, audio, api.mel_config.sample_rate)
                png = plot_mel_png(mel[0])
                resp = json.dumps({
                    "wav_b64": base64.b64encode(buf.getvalue()).decode(),
                    "mel_png_b64": base64.b64encode(png).decode() if png else None,
                    "seconds": len(audio) / api.mel_config.sample_rate,
                }).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(resp)))
                self.end_headers()
                self.wfile.write(resp)
            except Exception as e:  # noqa: BLE001
                msg = str(e).encode()
                self.send_response(500)
                self.send_header("Content-Length", str(len(msg)))
                self.end_headers()
                self.wfile.write(msg)

    return Handler


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tts-ckpt")
    ap.add_argument("--vocoder-ckpt")
    ap.add_argument("--vocoder", default="vocos", choices=["vocos", "ffgan"])
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from stabletts_torch.api import StableTTSAPI

    api = StableTTSAPI(args.tts_ckpt, args.vocoder_ckpt, args.vocoder, device=args.device)
    tts_m, voc_m = api.get_params()
    print(f"tts: {tts_m:.1f}M params, vocoder: {voc_m:.1f}M params")
    server = ThreadingHTTPServer((args.host, args.port), make_handler(api))
    print(f"serving on http://{args.host}:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
