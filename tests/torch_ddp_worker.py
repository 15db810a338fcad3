"""One rank of the port's data-parallel CPU tests (tests/test_torch_parallel.py).

Joins a gloo process group through a file rendezvous, checks the mesh's
bookkeeping as tests/mp_worker.py checks the JAX package's, runs the real
`train()` (or `train_vocos()`) on the CPU, checks that resuming from the
checkpoints restores the final state bit for bit, and saves its final state,
the metrics it logged and the checkpoints it wrote for the parent to compare.

    python tests/torch_ddp_worker.py --kind tts --rank 0 --world 2 --init <file> --data <dir> --out <dir>

`--kind tts_world1` runs `train()` once without a process group and once in a
gloo group of one, and saves both results.
"""

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import torch  # noqa: E402

from stabletts_torch.config import MelConfig, ModelConfig, TrainConfig, VocosConfig, VocosTrainConfig  # noqa: E402

# the JAX multi-process test's tiny model (tests/mp_worker.py), dropout on
TINY = ModelConfig(hidden_channels=32, filter_channels=64, n_heads=2, n_enc_layers=1, n_dec_layers=2, kernel_size=3,
                   p_dropout=0.1, gin_channels=32)
TINY_MEL = MelConfig(n_mels=16)
BATCH = 4  # per rank
EPOCHS = 2
# a tiny Vocos with the real discriminators (tests/test_torch_gan.py)
GAN_MEL = MelConfig(n_fft=256, win_length=256, hop_length=64, n_mels=20)
GAN_VOCOS = VocosConfig(input_channels=20, dim=32, intermediate_dim=64, num_layers=2)
GAN_SEGMENT = 2048
GAN_BATCH = 2  # per rank


def write_tts_dataset(root, n_items=16, n_mels=16):
    """16 random mels of 40-60 frames (the JAX test's `_write_dataset`), each
    with 3-8 phonemes, so two ranks' text and mel sums differ."""
    rng = np.random.default_rng(0)
    filelist = os.path.join(root, "filelist.jsonl")
    phones = ["a", "b", "d", "e", "f", "h", "i", "k"]
    with open(filelist, "w") as f:
        for i in range(n_items):
            t = int(rng.integers(40, 60))
            mel_path = os.path.join(root, f"mel_{i}.npy")
            np.save(mel_path, rng.standard_normal((t, n_mels)).astype(np.float32))
            f.write(json.dumps({"mel_path": mel_path, "phone": phones[: 3 + i % 6], "mel_length": t}) + "\n")
    return filelist


def write_wavs(root, count=8, sr=44100, seconds=0.1, seed=0):
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(count):
        wav = (rng.standard_normal(int(sr * seconds * (1 + 0.3 * i))) * 0.2).clip(-1, 1)
        wavfile.write(os.path.join(root, f"clip_{i}.wav"), sr, (wav * 32767).astype(np.int16))
    return root


def tts_config(filelist, save_path=None) -> TrainConfig:
    return TrainConfig(train_dataset_path=filelist, batch_size=BATCH, num_epochs=EPOCHS,
                       model_save_path=save_path or "unused", warmup_steps=1, bucket_boundaries=(32, 64, 128),
                       max_text_len=16, log_interval=1, loader_workers=0)


def vocos_config(wav_dir, save_path=None) -> VocosTrainConfig:
    return VocosTrainConfig(train_dataset_path=wav_dir, segment_size=GAN_SEGMENT, batch_size=GAN_BATCH, num_epochs=1,
                            model_save_path=save_path or "unused", log_interval=1, warmup_steps=1, learning_rate=1e-3,
                            loader_workers=0)


def _join(args, world):
    from stabletts_torch.parallel import mesh as mesh_lib

    mesh = mesh_lib.init_distributed("gloo", "cpu", f"file://{args.init}", args.rank, world)
    # the world as torch.distributed sees it, and this rank's rows of a global batch
    assert (mesh.rank, mesh.world, mesh.group, mesh.device) == (args.rank, world, True, torch.device("cpu"))
    shard = mesh_lib.shard_batch(mesh, BATCH)
    assert (shard.global_rows, shard.local_rows, shard.row0) == (world * BATCH, BATCH, args.rank * BATCH), shard
    return mesh


def _run_tts(args, save_path):
    from stabletts_torch.models import build_stabletts
    from stabletts_torch.train import train_tts
    from stabletts_torch.train.state import continue_training

    saves = []
    real_save = train_tts.save_checkpoint
    train_tts.save_checkpoint = lambda path, epoch, *a: (saves.append(epoch), real_save(path, epoch, *a))
    logged = []
    try:
        cfg = tts_config(os.path.join(args.data, "filelist.jsonl"), save_path)
        state = train_tts.train(cfg, TINY, TINY_MEL, log_fn=lambda s, m: logged.append([s, m]), device="cpu")
    finally:
        train_tts.save_checkpoint = real_save
    # resume: the newest checkpoint restores the final state bit for bit
    model = build_stabletts(TINY, TINY_MEL, device="cpu")
    opt = train_tts.make_optimizer(model, cfg)
    assert continue_training(save_path, model, opt) == EPOCHS
    final = state.model.state_dict()
    assert all(torch.equal(v, final[k]) for k, v in model.state_dict().items())
    return final, {"saves": saves, "logged": logged, "step": state.step}


def _run_vocos(args, save_path):
    from stabletts_torch.train import train_vocos as tv

    saves = []
    real_save = tv.save_checkpoint_named
    tv.save_checkpoint_named = lambda path, epoch, parts: (saves.append(epoch), real_save(path, epoch, parts))
    logged = []
    try:
        cfg = vocos_config(os.path.join(args.data, "wavs"), save_path)
        state = tv.train_vocos(cfg, GAN_VOCOS, GAN_MEL, log_fn=lambda s, m: logged.append([s, m]), device="cpu")
    finally:
        tv.save_checkpoint_named = real_save
    final = {f"{name}.{k}": v for name in ("gen", "mpd", "mrd") for k, v in getattr(state, name).state_dict().items()}
    for name in ("generator", "mpd", "mrd"):
        saved = torch.load(os.path.join(save_path, f"{name}_0.pt"), weights_only=True)
        part = {"generator": state.gen, "mpd": state.mpd, "mrd": state.mrd}[name]
        assert all(torch.equal(v, saved[k]) for k, v in part.state_dict().items())
    return final, {"saves": saves, "logged": logged, "step": state.step}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kind", choices=["tts", "vocos", "tts_world1"], required=True)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--init", required=True, help="the rendezvous file")
    ap.add_argument("--data", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    torch.set_num_threads(1)
    import torch.distributed as dist

    out = os.path.join(args.out, f"rank{args.rank}")
    if args.kind == "tts_world1":
        alone, _ = _run_tts(args, os.path.join(out, "alone"))
        _join(args, 1)
        grouped, info = _run_tts(args, os.path.join(out, "group"))
        torch.save({"alone": alone, "group": grouped}, os.path.join(args.out, "world1.pt"))
    else:
        _join(args, args.world)
        run = _run_tts if args.kind == "tts" else _run_vocos
        final, info = run(args, os.path.join(args.out, "ckpt"))
        torch.save(final, os.path.join(args.out, f"final_rank{args.rank}.pt"))
    with open(os.path.join(args.out, f"info_rank{args.rank}.json"), "w") as f:
        json.dump(info, f)
    dist.destroy_process_group()
    print(f"rank {args.rank}: OK", flush=True)


if __name__ == "__main__":
    main()
