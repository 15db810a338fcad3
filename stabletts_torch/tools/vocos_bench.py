"""The port's Vocos GAN training bench: audio-seconds of training data per
second per card, in the JSON schema of the JAX package's tools/vocos_bench.py.

Times `train.train_vocos.vocos_train_step` (the discriminator step, then the
generator step, MPD(2, 3, 5, 7, 11) + MRD(2048, 1024, 512)) at the
reference's training shapes (tools/vocos_bench.py:44-53): the training Vocos
(dim 768, intermediate 2048, 12 layers; vocoders/vocos/config.py:21-26),
segment 20480, B=16, state from `init_vocos_training` (seed 0,
total_steps=10000) and audio from np.random.default_rng(0) x 0.1.

Two warm steps (the first one's wall is `compile_s`, with the kernels
already built; the build is `build_s`), then `iters` steps queued and one
synchronize (`ms_per_step`). `detail` adds `compile_s`, `iters`,
`gen_loss_total`, `peak_memory_gb` (over the warm and timed steps), `card`
(nvidia-smi's name and power limit) and `build_s`.

    python -m stabletts_torch.tools.vocos_bench                   # B=16, f32, on the card
    python -m stabletts_torch.tools.vocos_bench --dtype bfloat16
    python -m stabletts_torch.tools.vocos_bench --device cpu --batch 1 --iters 1

`--profile DIR` traces 2 steady steps with torch.profiler: DIR/trace_vocos.json
and DIR/summary_vocos.json.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from stabletts_torch.config import MelConfig, VocosConfig, VocosTrainConfig
from stabletts_torch.tools.bench import card_name, profile_summary
from stabletts_torch.train.train_tts import resolve_compute_dtype
from stabletts_torch.train.train_vocos import init_vocos_training, vocos_train_step
from stabletts_torch.utils.device import resolve_device

# the reference's training Vocos (vocoders/vocos/config.py:21-26), not the 512 / 1536 / 8 flagship
TRAIN_VOCOS = VocosConfig(dim=768, intermediate_dim=2048, num_layers=12)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of 2 steady-state steps")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Runs the bench, prints its JSON line last and returns it as a dict."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    if args.profile and not on_card:
        raise SystemExit("--profile traces the card's kernels; it does not run with --device cpu")

    build_s = 0.0
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from stabletts_torch.ops import _build

        t0 = time.time()
        _build.build_all()
        build_s = time.time() - t0

    mel_cfg = MelConfig()
    train_cfg = VocosTrainConfig(batch_size=args.batch, compute_dtype=args.dtype)
    state = init_vocos_training(TRAIN_VOCOS, mel_cfg, train_cfg, 10000, device=dev)
    compute_dtype = resolve_compute_dtype(args.dtype)
    b, seg = args.batch, train_cfg.segment_size
    audio = torch.from_numpy((np.random.default_rng(0).standard_normal((b, seg)) * 0.1).astype(np.float32)).to(dev)

    def step() -> dict:
        return vocos_train_step(state, audio, mel_cfg, train_cfg.mel_loss_coeff, train_cfg.grad_clip, compute_dtype)

    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    first = float(step()["gen_loss_total"])
    compile_s = time.time() - t0
    print(f"compile: {compile_s:.1f}s, gen_loss_total {first:.3f}")
    step()

    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        summary = profile_summary(step, os.path.join(args.profile, "trace_vocos.json"))
        with open(os.path.join(args.profile, "summary_vocos.json"), "w") as f:
            json.dump({"batch": b, "segment": seg, "dtype": args.dtype, "card": card_name(), **summary}, f, indent=1)

    t0 = time.time()
    for _ in range(args.iters):
        metrics = step()
    loss = float(metrics["gen_loss_total"])  # the one synchronize
    wall = (time.time() - t0) / args.iters
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else None
    audio_seconds = b * seg / mel_cfg.sample_rate
    print(f"vocos GAN step: {wall * 1e3:.1f} ms at B={b} seg={seg} -> {audio_seconds / wall:.1f} audio-s/s/chip")

    result = {
        "metric": "vocos_gan_train_audio_s_per_s_per_chip",
        "value": round(audio_seconds / wall, 2),
        "unit": "audio-s/s/chip",
        "detail": {"ms_per_step": round(wall * 1e3, 1), "batch": b, "segment": seg, "dtype": args.dtype,
                   "platform": "gpu" if on_card else "cpu", "compile_s": round(compile_s, 1), "iters": args.iters,
                   "gen_loss_total": loss, "peak_memory_gb": peak_gb, "card": card_name() if on_card else None,
                   "build_s": round(build_s, 1)},
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
