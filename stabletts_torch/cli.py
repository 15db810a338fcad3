"""Command-line interface of the port: the subcommands, flags and defaults of
the JAX package's `cli.py` (entry points mirror the reference's train.py /
preprocess.py / api.py), plus `--device` on each subcommand that computes
(the GPU unless it says "cpu").

Usage:
  python -m stabletts_torch.cli preprocess --input filelist.txt --language english
  python -m stabletts_torch.cli train --dataset filelists/filelist.json
  python -m stabletts_torch.cli train-vocos --dataset audio_dir/
  python -m stabletts_torch.cli synth --text "hello" --ref ref.wav --language english \\
      --tts-ckpt checkpoints/checkpoint_9.pt --vocoder-ckpt vocos.pt --vocoder vocos --out out.wav

`train` and `train-vocos` run data-parallel under torchrun (one process per
card; NCCL on the GPU, gloo with `--device cpu`):
  torchrun --nproc_per_node 4 -m stabletts_torch.cli train --dataset filelists/filelist.json

`--tts-ckpt` is a `.pt` state dict with the reference StableTTS names: the
`checkpoint_{epoch}.pt` that `train` writes, or a reference checkpoint. The
JAX package's `convert` and `export` (orbax <-> `.pt`) have no counterpart:
the port's checkpoints are already the reference `.pt`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os


def _log(step, metrics):
    print(json.dumps({"step": step, **{k: float(v) for k, v in metrics.items()}}))


def _join_group(device) -> None:
    """Join torchrun's process group when it started more than one process."""
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        from stabletts_torch.parallel.mesh import init_distributed

        init_distributed(device=device)


def cmd_preprocess(args):
    from stabletts_torch.data.preprocess import DataConfig, preprocess

    cfg = DataConfig(
        input_filelist_path=args.input,
        output_filelist_path=args.output,
        mel_output_dir=args.mel_dir,
        language=args.language,
    )
    n = preprocess(cfg, device=args.device)
    print(f"preprocessed {n} utterances -> {args.output}")


def cmd_train(args):
    from stabletts_torch.config import ModelConfig, TrainConfig
    from stabletts_torch.train.train_tts import train

    cfg = TrainConfig()
    cfg = dataclasses.replace(
        cfg,
        train_dataset_path=args.dataset or cfg.train_dataset_path,
        batch_size=args.batch_size or cfg.batch_size,
        num_epochs=args.epochs or cfg.num_epochs,
        model_save_path=args.save_path or cfg.model_save_path,
        learning_rate=args.lr or cfg.learning_rate,
        compute_dtype=args.compute_dtype or cfg.compute_dtype,
    )
    model_cfg = dataclasses.replace(ModelConfig(), remat=args.remat)
    _join_group(args.device)
    train(cfg, model_cfg, log_fn=_log, device=args.device)


def cmd_train_vocos(args):
    from stabletts_torch.config import VocosTrainConfig
    from stabletts_torch.train.train_vocos import train_vocos

    cfg = VocosTrainConfig()
    cfg = dataclasses.replace(
        cfg,
        train_dataset_path=args.dataset or cfg.train_dataset_path,
        batch_size=args.batch_size or cfg.batch_size,
        model_save_path=args.save_path or cfg.model_save_path,
    )
    _join_group(args.device)
    train_vocos(cfg, num_epochs=args.epochs, log_fn=_log, device=args.device)


def cmd_preprocess_vocos(args):
    from stabletts_torch.data.vocos_dataset import vocos_preprocess

    n = vocos_preprocess(args.input, args.output)
    print(f"found {n} audio files -> {args.output}")


def cmd_synth(args):
    from stabletts_torch.api import StableTTSAPI
    from stabletts_torch.utils.audio_io import save_wav

    api = StableTTSAPI(args.tts_ckpt, args.vocoder_ckpt, args.vocoder, device=args.device)
    tts_m, voc_m = api.get_params()
    print(f"tts: {tts_m:.1f}M params, vocoder: {voc_m:.1f}M params")
    wav, mel = api.inference(
        args.text, args.ref, args.language,
        step=args.steps, temperature=args.temperature,
        length_scale=args.length_scale, solver=args.solver, cfg=args.cfg,
    )
    save_wav(args.out, wav[0], api.mel_config.sample_rate)
    print(f"wrote {args.out} ({wav.shape[1] / api.mel_config.sample_rate:.2f}s)")


def _device_flag(p):
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")


def main(argv=None):
    p = argparse.ArgumentParser(prog="stabletts_torch")
    sub = p.add_subparsers(dest="command", required=True)

    pp = sub.add_parser("preprocess", help="audio+text filelist -> mels + training filelist")
    pp.add_argument("--input", required=True, help="filelist of 'audio_path|text' lines")
    pp.add_argument("--output", default="filelists/filelist.json")
    pp.add_argument("--mel-dir", default="./mels")
    pp.add_argument("--language", default="chinese", choices=["chinese", "english", "japanese"])
    _device_flag(pp)
    pp.set_defaults(fn=cmd_preprocess)

    pt = sub.add_parser("train", help="train the TTS acoustic model")
    pt.add_argument("--dataset")
    pt.add_argument("--batch-size", type=int)
    pt.add_argument("--epochs", type=int)
    pt.add_argument("--save-path")
    pt.add_argument("--lr", type=float)
    pt.add_argument("--compute-dtype", choices=["float32", "bfloat16"],
                    help="bf16 compute vs f32 master params (default f32, like the reference)")
    pt.add_argument("--remat", action="store_true",
                    help="recompute the estimator blocks in the backward: more step time for less activation memory")
    _device_flag(pt)
    pt.set_defaults(fn=cmd_train)

    pv = sub.add_parser("train-vocos", help="train the Vocos GAN vocoder")
    pv.add_argument("--dataset")
    pv.add_argument("--batch-size", type=int)
    pv.add_argument("--epochs", type=int)
    pv.add_argument("--save-path")
    _device_flag(pv)
    pv.set_defaults(fn=cmd_train_vocos)

    pvp = sub.add_parser("preprocess-vocos", help="scan an audio dir into a vocoder filelist")
    pvp.add_argument("--input", required=True, help="audio directory")
    pvp.add_argument("--output", default="filelists/filelist.txt")
    pvp.set_defaults(fn=cmd_preprocess_vocos)

    ps = sub.add_parser("synth", help="synthesise speech")
    ps.add_argument("--text", required=True)
    ps.add_argument("--ref", required=True, help="reference audio (voice to clone)")
    ps.add_argument("--language", default="english", choices=["chinese", "english", "japanese"])
    ps.add_argument("--tts-ckpt", help="a .pt state dict (checkpoint_{epoch}.pt from train)")
    ps.add_argument("--vocoder-ckpt")
    ps.add_argument("--vocoder", default="vocos", choices=["vocos", "ffgan"])
    ps.add_argument("--steps", type=int, default=10)
    ps.add_argument("--temperature", type=float, default=1.0)
    ps.add_argument("--length-scale", type=float, default=1.0)
    ps.add_argument("--solver", default="euler")
    ps.add_argument("--cfg", type=float, default=3.0)
    ps.add_argument("--out", default="output.wav")
    _device_flag(ps)
    ps.set_defaults(fn=cmd_synth)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
