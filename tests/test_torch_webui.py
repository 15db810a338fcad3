"""The port's web UI (stabletts_torch/webui.py) against the JAX package's
(stabletts_tpu/webui.py) on the CPU: the solver list, the newline cleanup and
the page (but its title) equal; a synthesis round trip over real HTTP against
a CPU API whose WAV is bit-equal to a direct `inference` call with the same
arguments; the error paths; and the mel plot."""

import base64
import http.client
import io
import json
import threading

import numpy as np
import pytest
import torch

from stabletts_tpu import webui as jwebui
from stabletts_torch import webui
from stabletts_torch.config import ModelConfig, VocosConfig
from stabletts_torch.utils.audio_io import save_wav

torch.set_num_threads(2)

CLEANUP_CASES = ["你好。\n世界", "a,\nb\nc", "Hello!\nWorld?\nyes\n", "「引用」\n次。\n", "no punctuation\nhere",
                 "(x)\n[y]\n{z}\n<w>\n", "“quote”\n‘single’\n", "", "\n\n", "end.\n"]


def test_solvers_match_jax():
    assert webui.SOLVERS == jwebui.SOLVERS


@pytest.mark.parametrize("text", CLEANUP_CASES)
def test_newline_cleanup_matches_jax(text):
    assert webui.remove_newlines_after_punctuation(text) == jwebui.remove_newlines_after_punctuation(text)


def test_page_matches_jax_but_its_title():
    assert "<title>StableTTS (PyTorch)</title>" in webui._PAGE
    assert webui._PAGE.replace("StableTTS (PyTorch)", "StableTTS (TPU)") == jwebui._PAGE


@pytest.fixture(scope="module")
def served():
    from http.server import ThreadingHTTPServer

    from stabletts_torch.api import StableTTSAPI

    api = StableTTSAPI(
        None, None, "vocos",
        model_config=ModelConfig(hidden_channels=32, filter_channels=64, n_heads=2, n_enc_layers=1, n_dec_layers=2,
                                 kernel_size=3, p_dropout=0.1, gin_channels=32),
        vocos_config=VocosConfig(dim=32, intermediate_dim=64, num_layers=1),
        max_mel_len=128, device="cpu",
    )
    srv = ThreadingHTTPServer(("127.0.0.1", 0), webui.make_handler(api))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield api, srv.server_address
    srv.shutdown()
    srv.server_close()


def _ref_wav_bytes(sr=44100, seconds=0.6):
    rng = np.random.default_rng(0)
    wav = (0.1 * rng.standard_normal(int(sr * seconds))).astype(np.float32)
    buf = io.BytesIO()
    save_wav(buf, wav, sr)
    return buf.getvalue()


def _request(address, method, path, body=None):
    conn = http.client.HTTPConnection(*address, timeout=600)
    conn.request(method, path, body=body)
    r = conn.getresponse()
    return r.status, r.read()


def test_page_serves(served):
    _, address = served
    status, body = _request(address, "GET", "/")
    assert status == 200 and body.decode() == webui._PAGE.format(
        solvers="".join(f"<option>{s}</option>" for s in webui.SOLVERS))


def test_synthesis_round_trip_is_the_direct_call(served, tmp_path):
    api, address = served
    ref = _ref_wav_bytes()
    req = {"text": "Hello world.\nAgain.", "language": "english", "solver": "midpoint", "step": 2, "cfg": 1.5,
           "temperature": 0.8, "length_scale": 1.1, "ref_audio_b64": base64.b64encode(ref).decode()}
    status, body = _request(address, "POST", "/synthesize", json.dumps(req))
    assert status == 200, body[:300]
    out = json.loads(body)
    got = base64.b64decode(out["wav_b64"])

    ref_path = tmp_path / "ref.wav"
    ref_path.write_bytes(ref)
    wav, mel = api.inference("Hello world.Again.", str(ref_path), "english", step=2, temperature=0.8,
                             length_scale=1.1, solver="midpoint", cfg=1.5)
    audio = wav[0]
    peak = np.abs(audio).max()
    if peak > 1:
        audio = audio / peak
    buf = io.BytesIO()
    save_wav(buf, audio, api.mel_config.sample_rate)
    assert got[:4] == b"RIFF" and got == buf.getvalue()
    assert out["seconds"] == len(audio) / api.mel_config.sample_rate > 0
    png = base64.b64decode(out["mel_png_b64"])
    assert png == webui.plot_mel_png(mel[0]) and png[:8] == b"\x89PNG\r\n\x1a\n"


def test_unknown_paths_are_404(served):
    _, address = served
    assert _request(address, "GET", "/nothing")[0] == 404
    assert _request(address, "POST", "/nothing", "{}")[0] == 404


def test_bad_request_is_500_with_the_message(served):
    _, address = served
    status, body = _request(address, "POST", "/synthesize", json.dumps({"text": "hi"}))
    assert status == 500 and b"language" in body
    req = {"text": "hi", "language": "klingon", "ref_audio_b64": base64.b64encode(_ref_wav_bytes()).decode()}
    status, body = _request(address, "POST", "/synthesize", json.dumps(req))
    assert status == 500 and b"klingon" in body


def test_plot_mel_png():
    mel = np.random.default_rng(1).standard_normal((16, 40)).astype(np.float32)
    png = webui.plot_mel_png(mel)
    assert png[:8] == b"\x89PNG\r\n\x1a\n" and len(png) > 1000
