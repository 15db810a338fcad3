"""The program under test, built from a configuration file and a state dict:
the port's own constructors and `load_state_dict`, nothing else."""

from __future__ import annotations

import time

import torch


def build_kernels(device) -> float:
    """Builds (first run in a checkout) or loads the port's CUDA kernels;
    returns the seconds it took. Nothing to build on the CPU."""
    if torch.device(device).type != "cuda":
        return 0.0
    from stabletts_torch.ops import _build

    t0 = time.time()
    _build.build_all()
    return time.time() - t0


def configs(cfg: dict) -> tuple:
    from stabletts_torch.config import MelConfig, ModelConfig, VocosConfig

    model = ModelConfig(hidden_channels=cfg["hidden_channels"], filter_channels=cfg["filter_channels"],
                        n_heads=cfg["n_heads"], n_enc_layers=cfg["n_enc_layers"], n_dec_layers=cfg["n_dec_layers"],
                        kernel_size=cfg["kernel_size"], p_dropout=cfg["p_dropout"], gin_channels=cfg["gin_channels"])
    mel = MelConfig(sample_rate=cfg["sample_rate"], n_fft=cfg["n_fft"], win_length=cfg["win_length"],
                    hop_length=cfg["hop_length"], n_mels=cfg["n_mels"], mel_scale=cfg["mel_scale"])
    v = cfg["vocoder"]
    vocos = VocosConfig(input_channels=cfg["n_mels"], dim=v["dim"], intermediate_dim=v["intermediate_dim"],
                        num_layers=v["num_layers"])
    return model, mel, vocos


def build(cfg: dict, tts_sd: dict, voc_sd: dict, device, dtype=None) -> tuple:
    """(acoustic model, Vocos) on `device` in eval mode holding the given
    weights, cast once to `dtype` where given (as the port's bench casts)."""
    from stabletts_torch.models import build_stabletts
    from stabletts_torch.models.sampler import cast_model
    from stabletts_torch.models.vocos import Vocos

    model_cfg, mel_cfg, vocos_cfg = configs(cfg)
    model = build_stabletts(model_cfg, mel_cfg, n_vocab=cfg["n_vocab"], device=device)
    model.load_state_dict(tts_sd, strict=True)
    vocos = Vocos(vocos_cfg, mel_cfg, device=device)
    vocos.load_state_dict(voc_sd, strict=True)
    model, vocos = model.eval(), vocos.eval()
    if dtype is not None:
        model, vocos = cast_model(model, dtype), cast_model(vocos, dtype)
    return model, vocos
