"""Configuration dataclasses for the PyTorch port (same fields and defaults as
the JAX package's `MelConfig`, `ModelConfig`, `TrainConfig`, `VocosConfig` and
`VocosTrainConfig`; reference StableTTS config.py:1-50)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MelConfig:
    """Log-mel front-end config. `pad` defaults to (n_fft - hop_length) // 2,
    which gives "same"-style framing: N samples yield ceil(N / hop) frames."""

    sample_rate: int = 44100
    n_fft: int = 2048
    win_length: int = 2048
    hop_length: int = 512
    f_min: float = 0.0
    f_max: Optional[float] = None
    pad: int = 0
    n_mels: int = 128
    center: bool = False
    pad_mode: str = "reflect"
    mel_scale: str = "slaney"

    def __post_init__(self):
        if self.pad == 0:
            object.__setattr__(self, "pad", (self.n_fft - self.hop_length) // 2)

    @property
    def frames_per_second(self) -> float:
        return self.sample_rate / self.hop_length


@dataclass(frozen=True)
class ModelConfig:
    """StableTTS acoustic model config (flagship: 31M parameters)."""

    hidden_channels: int = 256
    filter_channels: int = 1024
    n_heads: int = 4
    n_enc_layers: int = 3
    n_dec_layers: int = 6
    kernel_size: int = 3
    p_dropout: float = 0.1
    gin_channels: int = 256
    # recompute each estimator block in the backward (torch.utils.checkpoint):
    # one more forward of those blocks for less activation memory in training;
    # no effect on inference or on the state dict
    remat: bool = False


@dataclass(frozen=True)
class F5Config:
    """F5-TTS v1 Base (SWivid/F5-TTS src/f5_tts/configs/F5TTS_v1_Base.yaml, the
    DiT backbone's and the modules' defaults, and infer/utils_infer.py's
    sampling defaults): a 336M DiT flow-matching model over [noisy mel,
    masked prompt mel, text]. `text_num_embeds` is the published vocab's size
    (its vocab.txt, which is not in this repository); `max_duration` is
    cfm.py's cap on the total frames. The published sampling is 32 steps at
    CFG 2 (`synthesise(..., n_timesteps=32, cfg=2.0)`) on the sway grid.
    Its vocoder is charactr/vocos-mel-24khz (`MelConfig` at 24 kHz, 100 htk
    mels, n_fft 1024, hop 256; `VocosConfig(input_channels=100)`). The
    sampler takes the prompt's mel as given: the port's log-mel front end
    computes slaney mels with "same" framing, not that vocoder's centred
    frames."""

    dim: int = 1024
    depth: int = 22
    heads: int = 16
    dim_head: int = 64
    ff_mult: int = 2
    text_dim: int = 512
    text_num_embeds: int = 2545
    conv_layers: int = 4
    mel_dim: int = 100
    freq_embed_dim: int = 256
    conv_pos_kernel: int = 31
    conv_pos_groups: int = 16
    sway_sampling_coef: float = -1.0
    max_duration: int = 4096


@dataclass(frozen=True)
class TrainConfig:
    """TTS training config: the JAX package's `TrainConfig`, field for field
    (reference StableTTS config.py:32-43 plus seed, buckets, text cap, compute
    and transfer dtypes and the loader). `compute_dtype="bfloat16"` runs the
    forward and backward in bf16 against f32 master parameters and optimizer
    state; `transfer_dtype="float16"` ships mels to the device as f16 and
    widens them there."""

    train_dataset_path: str = "filelists/filelist.json"
    batch_size: int = 32
    learning_rate: float = 1e-4
    num_epochs: int = 10000
    model_save_path: str = "./checkpoints"
    log_dir: str = "./runs"
    log_interval: int = 16
    save_interval: int = 1
    warmup_steps: int = 200
    seed: int = 0
    bucket_boundaries: Tuple[int, ...] = (32, 300, 400, 500, 600, 700, 800, 900, 1000)
    max_text_len: int = 512
    compute_dtype: str = "float32"  # or "bfloat16"
    loader_workers: int = 4
    prefetch_depth: int = 8
    transfer_dtype: str = "float32"  # or "float16"


@dataclass(frozen=True)
class VocosConfig:
    """Vocos generator config (inference default)."""

    input_channels: int = 128
    dim: int = 512
    intermediate_dim: int = 1536
    num_layers: int = 8


@dataclass(frozen=True)
class VocosTrainConfig:
    """Vocos GAN training config (reference: vocoders/vocos/config.py:28-47):
    the JAX package's `VocosTrainConfig`, field for field.
    `compute_dtype="bfloat16"` runs the generator and both discriminators in
    bf16 against f32 master parameters; the mel-loss STFTs, the loss
    reductions, the gradients and the optimizers stay f32."""

    train_dataset_path: str = "filelists/filelist.txt"
    segment_size: int = 20480
    batch_size: int = 16
    learning_rate: float = 1e-4
    num_epochs: int = 10000
    model_save_path: str = "./checkpoints_vocos"
    log_dir: str = "./runs_vocos"
    log_interval: int = 64
    save_interval: int = 1
    warmup_steps: int = 200
    mel_loss_coeff: float = 15.0
    grad_clip: float = 1000.0
    seed: int = 0
    compute_dtype: str = "float32"  # or "bfloat16"
    loader_workers: int = 4
    prefetch_depth: int = 8
    transfer_dtype: str = "float32"  # or "float16"
