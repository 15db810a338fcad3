"""Model package: StableTTS acoustic model, F5-TTS (`f5tts.py`), Vocos vocoder, sampler."""

from __future__ import annotations

from stabletts_torch.config import MelConfig, ModelConfig
from stabletts_torch.models.stabletts import StableTTS


def build_stabletts(model_cfg: ModelConfig | None = None, mel_cfg: MelConfig | None = None,
                    n_vocab: int | None = None, device=None) -> StableTTS:
    """Construct a StableTTS module from configs, on `device` (the GPU unless
    the caller passes "cpu")."""
    from stabletts_torch.text import symbols

    model_cfg = model_cfg or ModelConfig()
    mel_cfg = mel_cfg or MelConfig()
    return StableTTS(
        n_vocab=n_vocab or len(symbols),
        mel_channels=mel_cfg.n_mels,
        hidden_channels=model_cfg.hidden_channels,
        filter_channels=model_cfg.filter_channels,
        n_heads=model_cfg.n_heads,
        n_enc_layers=model_cfg.n_enc_layers,
        n_dec_layers=model_cfg.n_dec_layers,
        kernel_size=model_cfg.kernel_size,
        gin_channels=model_cfg.gin_channels,
        p_dropout=model_cfg.p_dropout,
        remat=model_cfg.remat,
        device=device,
    )
