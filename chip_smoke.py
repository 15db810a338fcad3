"""Drive the PyTorch port (stabletts_torch) on one CUDA GPU and check it.

    python3 chip_smoke.py            # one card; exits 0 only if every phase passed

Phases, one JSON line each; any failure exits nonzero:
  1. environment (torch/CUDA versions, card name and power limit)
  2. kernel build (every csrc/*.cu, one nvcc each, in parallel)
  3. each kernel against its plain PyTorch version on the card, at the
     serving path's shapes, f32 and bf16, with times and bounds
  4. serving: StableTTSAPI at the flagship config (random weights from a
     numpy seed, adaLN randomised): English requests, one batch request and
     a bf16 synthesise + Vocos batch at the bench shape (B=8, 1000 frames),
     with the launch counts of each kernel on that path
  5. device time by kernel over one request (torch.profiler)
  6. one request on the GPU (kernels) against the same request on the CPU
     (plain versions), same weights and noise
  7. the `kernels` line (launches: over the `inference` requests of phase 4;
     times: the bf16 bench shape); then the card line and the result line.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # H100 SXM, dense, no tensor-core f32
PEAK_BYTES = 3.35e12
BARS = {"dit_block": {torch.float32: 5e-3, torch.bfloat16: 2e-2},
        "convnext": {torch.float32: 2e-2, torch.bfloat16: 2e-2},
        "istft": {torch.float32: 1e-4, torch.bfloat16: 1e-3}}
KERNEL_INFO = {
    "dit_block": ("stabletts_torch/csrc/dit_block.cu", "stabletts_tpu/ops/dit_block_pallas.py:98"),
    "convnext": ("stabletts_torch/csrc/convnext.cu", "stabletts_tpu/ops/convnext_pallas.py:84"),
    "istft": ("stabletts_torch/csrc/istft.cu", "stabletts_tpu/ops/istft_pallas.py:55"),
}
DT_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median device time of fn in ms (CUDA events around each call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(flops: float, nbytes: float, dtype) -> tuple:
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        return math.inf, math.inf
    abs_err = (got - ref).abs().max().item()
    return abs_err / max(ref.abs().max().item(), 1e-30), abs_err


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------- kernels --


def measure(kernel: str, dtype, shape: dict, run, run_plain, flops: float, io_bytes: float) -> dict:
    """One kernel case: error against the plain version on the same inputs,
    median times of both, and the bound of the work."""
    rel, ab = rel_err(run(), run_plain())
    bar = BARS[kernel][dtype]
    bound, bound_by = bound_ms(flops, io_bytes, dtype)
    return {"kernel": kernel, "dtype": DT_NAME[dtype], **shape, "rel_err": rel, "max_abs_err": ab,
            "bar": bar, "ok": rel <= bar, "ms": time_ms(run), "plain_ms": time_ms(run_plain, iters=5),
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None}


def check_dit(rng, b, t, dtype, dev):
    from stabletts_torch.ops.dit_block_cuda import DiTWeights, dit_block, dit_block_plain

    c, f, heads = 256, 1024, 4
    g = lambda *s, scale=1.0: torch.from_numpy((rng.standard_normal(s) * scale).astype(np.float32)).to(dev, dtype)
    w = DiTWeights(g(c, 3 * c, scale=c ** -0.5), g(3 * c, scale=0.02), g(c, c, scale=c ** -0.5),
                   g(c, scale=0.02), g(3, c, f, scale=(3 * c) ** -0.5), g(f, scale=0.02),
                   g(3, f, c, scale=(3 * f) ** -0.5), g(c, scale=0.02))
    lengths = torch.tensor([t - (i * 37) % max(1, t // 2) for i in range(b)], device=dev)
    mask = (torch.arange(t, device=dev)[None, :] < lengths[:, None]).float()
    x = g(b, t, c) * mask[..., None].to(dtype)
    mods = g(b, 6, c, scale=0.1)
    flops = 2 * b * t * c * 4 * c + 4 * b * heads * t * t * (c // heads) + 4 * b * t * 3 * c * f
    return measure("dit_block", dtype, {"B": b, "T": t}, lambda: dit_block(x, mods, mask, w, heads),
                   lambda: dit_block_plain(x, mods, mask, w, heads), flops, nbytes(x, mods, mask, *w, x))


def check_convnext(rng, b, t, dtype, dev):
    from stabletts_torch.ops.convnext_cuda import ConvNeXtWeights, convnext_block, convnext_block_plain

    c, f = 512, 1536
    g = lambda *s, scale=1.0, off=0.0: torch.from_numpy(
        (rng.standard_normal(s) * scale + off).astype(np.float32)).to(dev, dtype)
    w = ConvNeXtWeights(g(7, c, scale=7 ** -0.5), g(c, scale=0.02), g(c, scale=0.1, off=1.0), g(c, scale=0.02),
                        g(c, f, scale=c ** -0.5), g(f, scale=0.02), g(f, c, scale=f ** -0.5), g(c, scale=0.02),
                        g(c, scale=0.05, off=1.0 / 8))
    x = g(b, t, c)
    return measure("convnext", dtype, {"B": b, "T": t}, lambda: convnext_block(x, w),
                   lambda: convnext_block_plain(x, w), 4 * b * t * c * f + 14 * b * t * c, nbytes(x, *w, x))


def check_istft(rng, b, t, dtype, dev, with_lengths=False):
    from stabletts_torch.ops.istft import idft_matrix_windowed
    from stabletts_torch.ops.istft_cuda import istft_head

    n_fft, hop = 2048, 512
    nf = n_fft // 2 + 1
    mag = np.exp(np.clip(rng.standard_normal((b, t, nf)), None, math.log(100.0)))
    phase = rng.uniform(-np.pi, np.pi, (b, t, nf))
    re = torch.from_numpy((mag * np.cos(phase)).astype(np.float32)).to(dev)
    im = torch.from_numpy((mag * np.sin(phase)).astype(np.float32)).to(dev)
    lengths = None
    if with_lengths:
        lengths = torch.tensor([t - (i * 53) % max(1, t // 2) for i in range(b)], device=dev)
    md = None if dtype == torch.float32 else dtype
    w = idft_matrix_windowed(n_fft, n_fft, dev, dtype)
    io = 2 * b * t * nf * w.element_size() + nbytes(w) + b * t * hop * 4
    return measure("istft", dtype, {"B": b, "T": t, "lengths": with_lengths},
                   lambda: istft_head(re, im, n_fft, hop, md, lengths),
                   lambda: _istft_plain_on(re, im, n_fft, hop, md, lengths), 2 * b * t * (n_fft + 2) * n_fft, io)


def _istft_plain_on(re, im, n_fft, hop, md, lengths):
    from stabletts_torch.ops.istft import istft_same_real

    fm = None
    if lengths is not None:
        fm = (torch.arange(re.shape[1], device=re.device)[None, :] < lengths[:, None]).float()
    return istft_same_real(re, im, n_fft, hop, n_fft, md, fm)


def phase_kernels(dev) -> dict:
    """Every kernel against its plain version at the path's shapes, f32 and
    bf16; returns the bench-shape rows (bf16; DiT at 2B=16, T=1024;
    ConvNeXt/ISTFT at B=8, T=1000) keyed by kernel, for the kernels line."""
    rng = np.random.default_rng(1234)
    rows, bench_rows = [], {}
    f32, bf = torch.float32, torch.bfloat16
    cases = [(check_dit, dict(b=b, t=t, dtype=dt)) for b, t in ((2, 1024), (16, 1024), (2, 97)) for dt in (f32, bf)]
    cases += [(fn, dict(b=b, t=t, dtype=dt)) for fn in (check_convnext, check_istft)
              for b, t in ((1, 1000), (8, 1000), (1, 333)) for dt in (f32, bf)]
    cases.append((check_istft, dict(b=8, t=1000, dtype=f32, with_lengths=True)))
    for fn, kw in cases:
        row = fn(rng, dev=dev, **kw)
        emit({"phase": "kernel_check", **row})
        rows.append(row)
        if kw["dtype"] == bf and kw["b"] == (16 if fn is check_dit else 8) and kw["t"] >= 1000:
            bench_rows[row["kernel"]] = row
    bad = [r for r in rows if not r["ok"]]
    if bad:
        fail(f"{len(bad)} kernel check(s) over their bar: {bad}")
    return bench_rows


# ---------------------------------------------------------------- serving --


def counters():
    from stabletts_torch.ops.convnext_cuda import convnext_block
    from stabletts_torch.ops.dit_block_cuda import dit_block
    from stabletts_torch.ops.istft_cuda import istft_head

    return {"dit_block": dit_block, "convnext": convnext_block, "istft": istft_head}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in counters().items()}


def randomise(api, seed: int) -> None:
    """adaLN and the CFG embeddings from a numpy seed (adaLN-Zero would make
    every DiT block the identity)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in api.tts_model.named_parameters():
            if "adaLN_modulation" in name or name.startswith("fake_"):
                scale = 0.1 if "adaLN" in name else 0.5
                p.copy_(torch.from_numpy((rng.standard_normal(tuple(p.shape)) * scale).astype(np.float32)))


def reference_wave(seed: int, seconds: float = 3.0, sr: int = 44100) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    wav = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 330 * t) + 0.02 * rng.standard_normal(t.size)
    return wav.astype(np.float32)


SENTENCES = [
    "The quick brown fox jumps over the lazy dog.",
    "Flow matching turns noise into a mel spectrogram in ten steps.",
    "Please call Stella and ask her to bring these things with her from the store.",
]


def phase_serving(dev, card: str) -> tuple:
    import stabletts_torch.api as api_mod
    from stabletts_torch.api import StableTTSAPI
    from stabletts_torch.models.sampler import cast_model, synthesise
    from stabletts_torch.text import symbols

    n_synth = [0]
    real_synth = api_mod.synthesise

    def counting_synth(*a, **k):
        n_synth[0] += 1
        return real_synth(*a, **k)

    api_mod.synthesise = counting_synth
    api = StableTTSAPI(device=dev)
    randomise(api, seed=7)
    tts_m, voc_m = api.get_params()
    emit({"phase": "serving_model", "tts_params_M": tts_m, "vocoder_params_M": voc_m})
    ref = reference_wave(3)
    sr, hop = api.mel_config.sample_rate, api.mel_config.hop_length

    api.inference(SENTENCES[0], ref, "english", step=10, cfg=3.0)  # warm: allocator, cuDNN plans
    torch.cuda.synchronize()
    main_counts = {"dit_block": 0, "convnext": 0, "istft": 0}  # over the inference requests
    for i, text in enumerate(SENTENCES):
        reset_counts()
        n_synth[0] = 0
        t0 = time.time()
        wav, mel = api.inference(text, ref, "english", step=10, cfg=3.0, seed=i)
        wall = time.time() - t0
        counts = read_counts()
        for k, v in counts.items():
            main_counts[k] += v
        expect = {"dit_block": 63 * n_synth[0], "convnext": 8, "istft": 1}
        ok = counts == expect and np.isfinite(wav).all() and wav.shape[1] == mel.shape[2] * hop
        emit({"phase": "serving_request", "text_chars": len(text), "frames": int(mel.shape[2]),
              "wall_ms": wall * 1e3, "audio_s_per_s": wav.shape[1] / sr / wall, "launches": counts,
              "expected_launches": expect, "card": card, "ok": bool(ok)})
        if not ok:
            fail(f"serving request {i}: launches {counts} vs {expect}, or bad output shape/values")

    reset_counts()
    n_synth[0] = 0
    t0 = time.time()
    wavs = api.batch_inference([(s, "english") for s in SENTENCES], ref, step=10, cfg=3.0)
    wall = time.time() - t0
    counts = read_counts()
    expect = {"dit_block": 63 * n_synth[0], "convnext": 8, "istft": 1}
    ok = counts == expect and len(wavs) == len(SENTENCES) and all(np.isfinite(w).all() for w in wavs)
    emit({"phase": "serving_batch", "items": len(wavs), "wall_ms": wall * 1e3,
          "audio_s_per_s": sum(w.shape[0] for w in wavs) / sr / wall, "launches": counts,
          "expected_launches": expect, "card": card, "ok": bool(ok)})
    if not ok:
        fail(f"batch_inference: launches {counts} vs {expect}, or bad outputs")
    api_mod.synthesise = real_synth

    # bench shape: B=8, 96 phoneme ids, 1000 frames, 10 Euler steps, CFG 3, bf16
    b, frames, tx = 8, 1000, 96
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(1, len(symbols), size=(b, tx))).to(dev)
    x_lengths = torch.full((b,), tx, device=dev)
    noise = torch.from_numpy(rng.standard_normal((b, frames, 128)).astype(np.float32)).to(dev)
    y_ref = torch.from_numpy(rng.standard_normal((b, 300, 128)).astype(np.float32)).to(dev)
    tts16 = cast_model(api.tts_model, torch.bfloat16)
    voc16 = cast_model(api.vocoder_model, torch.bfloat16)

    def pipeline():
        out = synthesise(tts16, x, x_lengths, noise, y_ref, n_timesteps=10, cfg=3.0, max_mel_len=frames,
                         compute_dtype=torch.bfloat16, device=dev)
        return voc16(out["decoder_outputs"].to(torch.bfloat16))

    pipeline()
    torch.cuda.synchronize()
    reset_counts()
    iters = 3
    t0 = time.time()
    for _ in range(iters):
        wav = pipeline()
    torch.cuda.synchronize()
    wall = (time.time() - t0) / iters
    counts = read_counts()
    expect = {"dit_block": 63 * iters, "convnext": 8 * iters, "istft": iters}
    ok = counts == expect and tuple(wav.shape) == (b, frames * hop) and bool(torch.isfinite(wav).all())
    emit({"phase": "serving_bench_bf16", "B": b, "frames": frames, "steps": 10, "cfg": 3.0,
          "wall_ms": wall * 1e3, "audio_s_per_s": b * frames * hop / sr / wall, "launches": counts,
          "expected_launches": expect, "card": card, "ok": ok})
    if not ok:
        fail(f"bf16 bench batch: launches {counts} vs {expect}, or bad output")
    return api, main_counts, pipeline


def phase_profile(label: str, fn, card: str) -> None:
    """Device time by kernel and the device's busy share over one call of
    fn (torch.profiler, CUDA activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    # kernels only: the aten ops that launched them report the same time again
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    emit({"phase": f"profile_{label}", "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
          "device_idle_share": max(0.0, 1.0 - busy_us / wall_us) if busy_us else None,
          "kernel_launches": sum(e.count for e in events),
          "top": [{"name": e.key[:100], "calls": e.count, "device_ms": e.self_device_time_total / 1e3}
                  for e in top], "card": card})


def phase_gpu_vs_cpu(api, ref_wave) -> None:
    from stabletts_torch.api import StableTTSAPI

    cpu = StableTTSAPI(device="cpu")
    cpu.tts_model.load_state_dict({k: v.cpu() for k, v in api.tts_model.state_dict().items()})
    cpu.vocoder_model.load_state_dict({k: v.cpu() for k, v in api.vocoder_model.state_dict().items()})
    text = SENTENCES[1]
    wav_g, mel_g = api.inference(text, ref_wave, "english", step=10, cfg=3.0, seed=11)
    wav_c, mel_c = cpu.inference(text, ref_wave, "english", step=10, cfg=3.0, seed=11)
    row = {"phase": "gpu_vs_cpu", "frames_gpu": int(mel_g.shape[2]), "frames_cpu": int(mel_c.shape[2]),
           "bar": 5e-3, "ok": False}
    if mel_g.shape == mel_c.shape and wav_g.shape == wav_c.shape:
        row["mel_rel_err"] = float(np.abs(mel_g - mel_c).max() / np.abs(mel_c).max())
        row["wav_rel_err"] = float(np.abs(wav_g - wav_c).max() / np.abs(wav_c).max())
        row["ok"] = row["mel_rel_err"] <= 5e-3 and row["wav_rel_err"] <= 5e-3
    emit(row)
    if not row["ok"]:
        fail(f"GPU vs CPU end to end: {row}")


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    try:
        from stabletts_torch.ops import _build
    except ImportError as e:
        fail(f"stabletts_torch is not importable here ({e}); run from the repository root")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False).stdout.strip().splitlines()
    card = smi[0] if smi else "unknown"
    emit({"phase": "environment", "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "card": card})

    t0 = time.time()
    _build.build_all()
    emit({"phase": "build", "seconds": time.time() - t0, "libraries": sorted(_build._libs)})

    bench = phase_kernels(dev)
    api, counts, bench_pipeline = phase_serving(dev, card)
    ref = reference_wave(5)
    phase_profile("request_f32", lambda: api.inference(SENTENCES[2], ref, "english", step=10, cfg=3.0), card)
    phase_profile("bench_bf16", bench_pipeline, card)
    phase_gpu_vs_cpu(api, reference_wave(3))
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        fail(f"kernels never launched on the serving path: {missing}")

    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        r = bench[name]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": counts[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"], "shape": {"B": r["B"], "T": r["T"]},
                        "dtype": r["dtype"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
