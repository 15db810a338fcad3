"""The port's TTS training bench: audio-seconds of training data per second
per card, in the JSON schema of the JAX package's tools/train_bench.py.

Times the full training step (the training forward with MAS on the device,
the backward and the AdamW update of `train.train_tts.train_step`) at the JAX
bench's shapes and inputs (tools/train_bench.py:57-72): the flagship model
from `torch.manual_seed(0)`, the trainer's optimizer and schedule at
total_steps=10000, B items of `text_len` random ids (np.random.default_rng(0))
against `mel_frames` random mel frames and a 256-frame reference mel.

  * one warm step (`compile_s`: its wall, with the kernels already built;
    the kernel build is `build_s`), then `iters` steps queued and one
    synchronize (`ms_per_step`);
  * `--from-disk`: the same model trained from .npy mels written from
    default_rng(7) through the bucket sampler, collate and (with
    `--loader-workers` > 0) the prefetch threads, synchronous and prefetched,
    against the synthetic batch (tools/train_bench.py:108-177);
  * MAS alone at [B, mel_frames, text_len] through the dispatch the step
    uses (`ops.mas_cuda.mas`), queued, with one synchronize.

`detail` adds `compile_s`, `iters`, the first and last loss, `peak_memory_gb`
(over the warm and timed steps) and `peak_memory_over_resident_gb` (that peak
less what was allocated before the warm step: the model, the batch and
whatever else the process holds), `card` (nvidia-smi's name and power limit),
`build_s`, `launches_per_step` (each training kernel's launches over the
timed steps, divided by `iters`), `mas_ms` and `from_disk`.

    python -m stabletts_torch.tools.train_bench                  # B=32, 1000 frames, text 384, f32, on the card
    python -m stabletts_torch.tools.train_bench --dtype bfloat16
    python -m stabletts_torch.tools.train_bench --remat --from-disk
    python -m stabletts_torch.tools.train_bench --device cpu --batch 2 --mel-frames 64 --text-len 32 --iters 1

`--profile DIR` traces 2 steady steps with torch.profiler: DIR/trace_train.json
and DIR/summary_train.json (wall, device busy ms and idle share, launches,
device ms by kernel).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import numpy as np
import torch

from stabletts_torch.config import MelConfig, ModelConfig, TrainConfig
from stabletts_torch.models import build_stabletts
from stabletts_torch.ops import dit_attention_train_cuda, ffn_train_cuda
from stabletts_torch.ops.mas_cuda import mas
from stabletts_torch.tools.bench import card_name, profile_summary
from stabletts_torch.train.scheduler import make_scheduler
from stabletts_torch.train.train_tts import _to_device, make_optimizer, resolve_compute_dtype, train_step
from stabletts_torch.utils.device import resolve_device

REF_FRAMES = 256
# the kernels of the training step, by the name their launches are reported under
KERNELS = {"dit_attention_train_fwd": dit_attention_train_cuda.dit_attention_train_fwd,
           "dit_attention_train_bwd": dit_attention_train_cuda.dit_attention_train_bwd,
           "ffn_train_fwd": ffn_train_cuda.ffn_train_fwd, "ffn_train_bwd": ffn_train_cuda.ffn_train_bwd,
           "mas": mas}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--mel-frames", type=int, default=1000)
    ap.add_argument("--text-len", type=int, default=384)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--remat", action="store_true", help="recompute the estimator blocks (ModelConfig.remat)")
    ap.add_argument("--from-disk", action="store_true",
                    help="also feed .npy mels from disk through the sampler and the prefetch threads")
    ap.add_argument("--loader-workers", type=int, default=4)
    ap.add_argument("--prefetch-depth", type=int, default=8)
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of 2 steady-state steps")
    return ap.parse_args(argv)


def synthetic_batch(b: int, ty: int, tx: int, n_mels: int, dev) -> tuple:
    """The JAX bench's batch (tools/train_bench.py:64-72): ids, lengths, mels
    and a 256-frame reference mel from np.random.default_rng(0), on `dev`.
    Returns the batch and the generator, which the MAS timing draws from
    next."""
    rng = np.random.default_rng(0)
    host = (rng.integers(1, 400, (b, tx)).astype(np.int32), np.full((b,), tx, np.int32),
            rng.standard_normal((b, ty, n_mels)).astype(np.float32), np.full((b,), ty, np.int32),
            rng.standard_normal((b, REF_FRAMES, n_mels)).astype(np.float32), np.full((b,), REF_FRAMES, np.int32))
    return tuple(torch.from_numpy(a).to(dev) for a in host), rng


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def _from_disk(args, step, wall: float, dev, mel_cfg: MelConfig) -> dict:
    """Train steps fed from .npy mels on disk: the warm-up step, then
    max(iters, 4) steps timed, synchronous and then through the prefetch
    threads. Returns their ms a step and the prefetched overhead against the
    synthetic batch's `wall`."""
    from stabletts_torch.data.dataset import StableDataset, collate
    from stabletts_torch.data.prefetch import prefetch
    from stabletts_torch.data.sampler import DistributedBucketSampler

    b, ty, tx = args.batch, args.mel_frames, args.text_len
    rng_d = np.random.default_rng(7)
    n_items = max(4 * b, 64)
    with tempfile.TemporaryDirectory(prefix="stabletts_bench_") as tmp:
        fl_path = os.path.join(tmp, "filelist.jsonl")
        with open(fl_path, "w", encoding="utf-8") as fh:
            for i in range(n_items):
                t_i = int(rng_d.integers(int(ty * 0.9), ty + 1))
                mel_path = os.path.join(tmp, f"{i}.npy")
                np.save(mel_path, rng_d.standard_normal((t_i, mel_cfg.n_mels)).astype(np.float32))
                phones = ["a1", "i1", "u1", "e1", "o1"] * (tx // 12)
                fh.write(json.dumps({"mel_path": mel_path, "phone": phones, "mel_length": t_i}) + "\n")

        dataset = StableDataset(fl_path)
        sampler = DistributedBucketSampler(dataset.lengths, b, [32, ty], num_replicas=1, rank=0)
        sampler.set_epoch(0)

        def make_batch(work):
            batch_idx, (bucket, indices) = work
            r = np.random.default_rng(np.random.SeedSequence([0, batch_idx]))
            hb = collate(dataset, indices, sampler.bucket_mel_len(bucket), tx, mel_cfg.n_mels, r)
            return tuple(_to_device(a, dev) for a in hb.as_tuple())

        def run_epochs(n_steps: int, workers: int, depth: int) -> float:
            done, t_start, metrics = 0, None, None
            while done < n_steps + 1:
                work = enumerate(sampler)
                stream = prefetch(work, make_batch, workers, depth) if workers > 0 else map(make_batch, work)
                for batch in stream:
                    metrics = step(batch)
                    done += 1
                    if done == 1:  # the warm-up step is not timed
                        float(metrics["loss"])
                        t_start = time.time()
                    if done >= n_steps + 1:
                        break
            float(metrics["loss"])
            return (time.time() - t_start) / n_steps

        n_steps = max(args.iters, 4)
        wall_sync = run_epochs(n_steps, 0, 0)
        wall_pre = run_epochs(n_steps, args.loader_workers, args.prefetch_depth)
    print(f"from-disk step: sync {wall_sync * 1e3:.1f} ms | prefetch {wall_pre * 1e3:.1f} ms "
          f"(workers={args.loader_workers}) | synthetic {wall * 1e3:.1f} ms -> overhead "
          f"{(wall_pre / wall - 1) * 100:+.1f}% vs synthetic")
    return {"sync_ms_per_step": wall_sync * 1e3, "prefetch_ms_per_step": wall_pre * 1e3, "steps": n_steps,
            "loader_workers": args.loader_workers, "prefetch_depth": args.prefetch_depth,
            "overhead_vs_synthetic": wall_pre / wall - 1}


def main(argv=None) -> dict:
    """Runs the bench, prints its JSON line last and returns it as a dict."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    if args.profile and not on_card:
        raise SystemExit("--profile traces the card's kernels; it does not run with --device cpu")

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    build_s = 0.0
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from stabletts_torch.ops import _build

        t0 = time.time()
        _build.build_all()
        build_s = time.time() - t0

    b, ty, tx = args.batch, args.mel_frames, args.text_len
    mel_cfg = MelConfig()
    train_cfg = TrainConfig()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_stabletts(dataclasses.replace(ModelConfig(), remat=args.remat), mel_cfg, device=dev)
    model.train()
    optimizer = make_optimizer(model, train_cfg)
    scheduler = make_scheduler(optimizer, train_cfg.learning_rate, train_cfg.warmup_steps, 10000)
    compute_dtype = resolve_compute_dtype(args.dtype)
    gen = torch.Generator(device=dev)

    def step(batch) -> dict:
        gen.manual_seed(1)  # the same draws every step, as the JAX bench passes one key
        return train_step(model, optimizer, scheduler, batch, gen, compute_dtype)

    batch, rng = synthetic_batch(b, ty, tx, mel_cfg.n_mels, dev)

    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        resident = torch.cuda.memory_allocated(dev)
    t0 = time.time()
    loss0 = float(step(batch)["loss"])
    compile_s = time.time() - t0
    print(f"compile: {compile_s:.1f}s, first loss {loss0:.3f}")

    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        summary = profile_summary(lambda: step(batch), os.path.join(args.profile, "trace_train.json"))
        with open(os.path.join(args.profile, "summary_train.json"), "w") as f:
            json.dump({"batch": b, "ty": ty, "tx": tx, "dtype": args.dtype, "remat": args.remat,
                       "card": card_name(), **summary}, f, indent=1)

    reset_counts()
    t0 = time.time()
    for _ in range(args.iters):
        metrics = step(batch)
    loss = float(metrics["loss"])  # the one synchronize
    wall = (time.time() - t0) / args.iters
    launches = {k: v / args.iters for k, v in launch_counts().items()}
    peak = torch.cuda.max_memory_allocated(dev) if on_card else None
    audio_s = b * ty * mel_cfg.hop_length / mel_cfg.sample_rate
    print(f"train step: {wall * 1e3:.1f} ms at B={b} Ty={ty} Tx={tx} -> {audio_s / wall:.1f} audio-s/s/chip "
          f"(loss {loss:.3f})")

    from_disk = _from_disk(args, step, wall, dev, mel_cfg) if args.from_disk else None

    # MAS alone at the step's shape, through the step's dispatch: every call
    # queued, one synchronize (a synchronize a call would time the round trip)
    neg_cent = torch.from_numpy(rng.standard_normal((b, ty, tx)).astype(np.float32)).to(dev)
    mask = torch.ones((b, ty, tx), device=dev)
    float(mas(neg_cent, mask).sum())
    n = max(args.iters * 4, 20)
    t0 = time.time()
    outs = [mas(neg_cent, mask) for _ in range(n)]
    float(outs[-1].sum())
    mas_ms = (time.time() - t0) / n * 1e3
    del outs
    print(f"MAS [B={b},{ty},{tx}]: {mas_ms:.2f} ms")

    result = {
        "metric": "tts_train_audio_s_per_s_per_chip",
        "value": round(audio_s / wall, 2),
        "unit": "audio-s/s/chip",
        "detail": {"ms_per_step": round(wall * 1e3, 1), "batch": b, "ty": ty, "tx": tx, "dtype": args.dtype,
                   "remat": args.remat, "platform": "gpu" if on_card else "cpu", "compile_s": round(compile_s, 1),
                   "iters": args.iters, "first_loss": loss0, "loss": loss,
                   "peak_memory_gb": peak / 1e9 if on_card else None,
                   "peak_memory_over_resident_gb": (peak - resident) / 1e9 if on_card else None,
                   "card": card_name() if on_card else None, "build_s": round(build_s, 1),
                   "launches_per_step": launches, "mas_ms": mas_ms, "from_disk": from_disk},
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
