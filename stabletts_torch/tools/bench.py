"""The port's serving bench: audio-seconds generated per second per card at
10 ODE steps, in the JSON schema of the JAX package's bench.py.

Drives the full inference pipeline (phoneme ids -> StableTTS flow-matching
mel -> Vocos waveform) batched, with the 31M-parameter flagship config and
random weights from a seed, as bench.py does (bench.py:109-149):

  * B items of 96 phoneme ids (np.random.default_rng(0)), noise
    [B, frames, 128], a 300-frame reference mel;
  * `synthesise(..., solver="euler", max_mel_len=frames, compute_dtype=...)`,
    then Vocos with its weights in the compute dtype (bench.py:97-101);
  * one warm call (`compile_s`: its wall, with the kernels already built;
    the kernel build is `build_s`), then `iters` calls queued and one
    synchronize (`wall_s` per call);
  * CFG 3 at half the batch (96 at the default 192: the same estimator batch,
    bench.py:155-161) and the B=1, CFG 3 latency, the median of 10 calls each
    ended by a synchronize (bench.py:166-196).

Throughput counts every item's full `frames` (audio-s = B * frames * hop /
sample_rate), whatever the random duration predictor gives.

On the card, unless `--skip-selftest`, the gate (`stabletts_torch/tools/
selftest.py`) first holds the bench's three kernels to their plain versions;
a failing check exits non-zero and prints no metric line. `detail` adds
`build_s`, `card` (nvidia-smi's name and power limit) and `launches`, each
kernel's launches during the timed iterations.

    python -m stabletts_torch.tools.bench                       # B=192, 1000 frames, bf16, on the card
    python -m stabletts_torch.tools.bench --device cpu --batch 2 --frames 32 --steps 2 --iters 1

`--profile DIR` traces 2 steady calls of each batched measurement with
torch.profiler: DIR/trace_b{B}_cfg{cfg}.json (a Chrome trace) and
DIR/summary_b{B}_cfg{cfg}.json (wall, device busy ms and idle share, launches,
device ms by kernel).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from stabletts_torch.config import MelConfig, VocosConfig
from stabletts_torch.models import build_stabletts
from stabletts_torch.models.sampler import cast_model, synthesise
from stabletts_torch.models.vocos import Vocos
from stabletts_torch.ops.convnext_cuda import convnext_block
from stabletts_torch.ops.dit_block_cuda import dit_block
from stabletts_torch.ops.istft_cuda import istft_head
from stabletts_torch.utils.device import resolve_device

TEXT_LEN = 96
REF_FRAMES = 300
# the kernels of the default serving path, by the name their launches are reported under
KERNELS = {"dit_block": dit_block, "convnext": convnext_block, "istft": istft_head}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=192)
    ap.add_argument("--frames", type=int, default=1000, help="mel frames per utterance (1000 = 11.6 s)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--cfg", type=float, default=1.0)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--skip-selftest", action="store_true", help="skip the kernel gate on the card")
    ap.add_argument("--skip-cfg3", action="store_true", help="skip the CFG=3 operating-point measurement")
    ap.add_argument("--skip-b1", action="store_true", help="skip the B=1 serving-latency measurement")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of 2 steady iterations of each batched measurement")
    return ap.parse_args(argv)


def card_name() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False).stdout.strip().splitlines()
    return smi[0] if smi else "unknown"


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def profile_summary(fn, path: str) -> dict:
    """Traces two calls of fn; writes the Chrome trace to `path` and returns
    wall ms, device busy ms, idle share, launches and device ms by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    prof.export_chrome_trace(path)
    by = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            by[e.key[:120]] = by.get(e.key[:120], 0.0) + e.self_device_time_total / 1e3
    busy_ms = sum(by.values())
    return {"calls": 2, "wall_ms": wall_us / 1e3, "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms * 1e3 / wall_us),
            "kernel_launches": sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
            "device_ms_by_kernel": dict(sorted(by.items(), key=lambda kv: -kv[1]))}


def main(argv=None) -> dict:
    """Runs the bench, prints its JSON line and returns it as a dict."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    if args.profile and not on_card:
        raise SystemExit("--profile traces the card's kernels; it does not run with --device cpu")
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    build_s = 0.0
    if on_card:
        from stabletts_torch.ops import _build

        t0 = time.time()
        _build.build_all()
        build_s = time.time() - t0

    selftest = "skipped"
    if on_card and not args.skip_selftest:
        from stabletts_torch.tools.selftest import run as selftest_run

        rows = selftest_run(dev)
        bad = [r for r in rows if not r["ok"]]
        if bad:
            print(json.dumps({"error": "kernel selftest failed", "checks": bad}), file=sys.stderr)
            raise SystemExit(1)
        selftest = "pass"

    mel_cfg = MelConfig()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_stabletts(mel_cfg=mel_cfg, device="cpu")
        torch.manual_seed(3)
        vocos = Vocos(VocosConfig(), mel_cfg, device="cpu")
    compute_dtype = torch.bfloat16 if args.dtype == "bfloat16" else None
    # the weights in the compute dtype once, as bench.py casts vvars (synthesise would copy an f32 model each call)
    model = cast_model(model.to(dev).eval(), compute_dtype or torch.float32)
    vocos = cast_model(vocos.to(dev), compute_dtype or torch.float32)
    frames = args.frames
    hop, sr = mel_cfg.hop_length, mel_cfg.sample_rate

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def inputs(b: int) -> tuple:
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.integers(1, 400, size=(b, TEXT_LEN))).to(dev)
        x_lengths = torch.full((b,), TEXT_LEN, dtype=torch.long, device=dev)
        gen = torch.Generator(device=dev)
        noise = torch.randn(b, frames, mel_cfg.n_mels, generator=gen.manual_seed(1), device=dev)
        y_ref = torch.randn(b, REF_FRAMES, mel_cfg.n_mels, generator=gen.manual_seed(2), device=dev)
        return x, x_lengths, noise, y_ref

    def pipeline_of(b: int, cfg: float):
        x, x_lengths, noise, y_ref = inputs(b)

        def pipeline():
            out = synthesise(model, x, x_lengths, noise, y_ref, n_timesteps=args.steps, cfg=cfg, solver="euler",
                             max_mel_len=frames, compute_dtype=compute_dtype, device=dev)
            mel = out["decoder_outputs"]
            if compute_dtype is not None:
                mel = mel.to(compute_dtype)
            return vocos(mel)

        return pipeline

    def measure(b: int, cfg: float) -> dict:
        """Full pipeline throughput at batch b and CFG cfg."""
        pipeline = pipeline_of(b, cfg)
        t0 = time.time()
        pipeline()
        sync()
        compile_s = time.time() - t0
        pipeline()
        sync()
        if args.profile:
            os.makedirs(args.profile, exist_ok=True)
            tag = f"b{b}_cfg{cfg:g}"
            summary = profile_summary(pipeline, os.path.join(args.profile, f"trace_{tag}.json"))
            with open(os.path.join(args.profile, f"summary_{tag}.json"), "w") as f:
                json.dump({"batch": b, "cfg": cfg, "dtype": args.dtype, "card": card_name(), **summary}, f, indent=1)
        for fn in KERNELS.values():
            fn.launches = 0
        # steady state: queue every iteration, synchronize once
        t0 = time.time()
        wavs = [pipeline() for _ in range(args.iters)]
        sync()
        wall = (time.time() - t0) / args.iters
        launches = launch_counts()
        if not all(bool(torch.isfinite(w).all()) and tuple(w.shape) == (b, frames * hop) for w in wavs):
            raise RuntimeError(f"bench: a waveform at B={b}, cfg={cfg} is not finite or not [B, frames * hop]")
        audio_seconds = b * frames * hop / sr
        return {"audio_s_per_s": audio_seconds / wall, "rtf": wall / audio_seconds, "wall_s": wall,
                "compile_s": compile_s, "launches": launches}

    b = args.batch
    head = measure(b, args.cfg)

    # the reference's recommended operating point (CFG 3) at the same estimator batch
    cfg3 = None
    if not args.skip_cfg3 and args.cfg != 3.0:
        b3 = max(1, b // 2)
        m = measure(b3, 3.0)
        cfg3 = {"audio_s_per_s": round(m["audio_s_per_s"], 3), "rtf": round(m["rtf"], 5), "batch": b3,
                "launches": m["launches"]}

    # B=1 latency: one utterance at CFG 3, each call ended by a synchronize
    b1 = None
    if not args.skip_b1:
        serve_once = pipeline_of(1, 3.0)
        serve_once()
        sync()
        lat = []
        for _ in range(10):
            t0 = time.time()
            serve_once()
            sync()
            lat.append(time.time() - t0)
        median = statistics.median(lat)
        audio_s1 = frames * hop / sr
        b1 = {"latency_ms": round(median * 1e3, 1), "rtf": round(median / audio_s1, 5),
              "audio_s": round(audio_s1, 2), "cfg": 3.0}

    result = {
        "metric": "audio_seconds_per_s_per_chip_10steps",
        "value": round(head["audio_s_per_s"], 3),
        "unit": "audio-s/s/chip",
        "vs_baseline": round(head["audio_s_per_s"], 3),
        "detail": {
            "batch": b,
            "mel_frames": frames,
            "ode_steps": args.steps,
            "cfg": args.cfg,
            "rtf": round(head["rtf"], 5),
            "wall_s": round(head["wall_s"], 4),
            "compile_s": round(head["compile_s"], 1),
            "dtype": args.dtype,
            "platform": "gpu" if on_card else "cpu",
            "kernel_selftest": selftest,
            "build_s": round(build_s, 1),
            "card": card_name() if on_card else None,
            "launches": head["launches"],
        },
    }
    if cfg3 is not None:
        result["detail"]["cfg3"] = cfg3
    if b1 is not None:
        result["detail"]["b1"] = b1
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
