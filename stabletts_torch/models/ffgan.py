"""FireflyGAN vocoder, inference only: a ConvNeXt encoder backbone and a HiFiGAN
transposed-conv head (reference: vocoders/ffgan/{model,backbone,head}.py).
Parameters carry the reference names and torch layouts with weight norm
already folded (`utils.convert.load_ffgan_state_dict` folds it), so every conv
here is plain. Plain PyTorch throughout: the JAX package has no kernel here.

Layout: mel [B, T, n_mels] channels-last -> waveform [B, T * hop_length].

Lengths mode (`FireflyGANBase.forward(mel, lengths)`, the fixed-shape serving
mode that `models/vocos.py` has too): frames >= lengths[i] are absent. Every
tensor that a conv of kernel > 1 reads is kept at zero past the item's length
at that tensor's own rate (frames, then frames x 8, 64, 128, 256 and 512
samples), as the trimmed item's zero padding is, so the result equals
vocoding each trimmed mel alone, with zeros past lengths[i] x 512 samples.
The masks ride on passes that are there anyway where they can: each ConvNeXt
block's residual add and each ResBlock pair's residual add become one
`addcmul`; what is left is one multiply after the stem and each downsample,
the backbone's output, `conv_pre`, each transposed conv, the SiLU before each
pair's second conv, and the waveform.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from stabletts_torch.nn.blocks import conv1d_same
from stabletts_torch.ops.conv import conv1d_dilated, conv_transpose_1d
from stabletts_torch.utils.device import resolve_device
from stabletts_torch.utils.metrics import count, span

FFGAN_CONFIG = {
    # reference: vocoders/ffgan/model.py:7-29 (the hard-coded fishaudio config)
    "backbone": {
        "input_channels": 128,
        "depths": (3, 3, 9, 3),
        "dims": (128, 256, 384, 512),
        "drop_path_rate": 0.2,
        "kernel_size": 7,
    },
    "head": {
        "hop_length": 512,
        "upsample_rates": (8, 8, 2, 2, 2),
        "upsample_kernel_sizes": (16, 16, 4, 4, 4),
        "resblock_kernel_sizes": (3, 7, 11),
        "resblock_dilation_sizes": ((1, 3, 5), (1, 3, 5), (1, 3, 5)),
        "num_mels": 512,
        "upsample_initial_channel": 512,
        "pre_conv_kernel_size": 13,
        "post_conv_kernel_size": 13,
    },
}


def drop_path(x: torch.Tensor, rate: float, deterministic: bool,
              gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Stochastic depth (reference: vocoders/ffgan/backbone.py:7-31): drops
    whole items of the batch with probability `rate`, drawn from `gen`."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    mask = (torch.rand(shape, generator=gen, device=x.device) < keep).to(x.dtype)
    return x * mask / keep


def rowmask(lengths: Optional[torch.Tensor], frames: int, rate: int, dtype) -> Optional[torch.Tensor]:
    """[B, frames * rate, 1] in `dtype`: 1 before lengths[i] * rate, 0 from
    there; None without lengths."""
    if lengths is None:
        return None
    pos = torch.arange(frames * rate, device=lengths.device)
    return (pos[None, :] < lengths[:, None] * rate).to(dtype)[..., None]


def _masked_add(x: torch.Tensor, y: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """x + y, with y zeroed where `mask` is 0 (in the same pass)."""
    return x + y if mask is None else torch.addcmul(x, y, mask)


def _kernel(conv: nn.Module) -> torch.Tensor:
    """A Conv1d weight [C_out, C_in, k] as the [k, C_in, C_out] view that
    `ops.conv` takes."""
    return conv.weight.permute(2, 1, 0)


class FFConvNeXtBlock(nn.Module):
    """ConvNeXt block, fish-diffusion variant (reference: backbone.py:81-152):
    depthwise conv, LayerNorm, 4x MLP with GELU, layer scale, optional
    stochastic depth."""

    def __init__(self, dim: int, drop_path_rate: float = 0.0, layer_scale_init_value: float = 1e-6,
                 mlp_ratio: float = 4.0, kernel_size: int = 7, dilation: int = 1):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.dilation = dilation
        self.padding = int(dilation * (kernel_size - 1) / 2)
        self.dwconv = nn.Conv1d(dim, dim, kernel_size, padding=self.padding, dilation=dilation, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, int(mlp_ratio * dim))
        self.pwconv2 = nn.Linear(int(mlp_ratio * dim), dim)
        self.gamma = nn.Parameter(layer_scale_init_value * torch.ones(dim)) if layer_scale_init_value > 0 else None

    def forward(self, x, deterministic: bool = True, gen: Optional[torch.Generator] = None, mask=None):
        """x [B, T, dim] -> [B, T, dim]; `mask` [B, T, 1] zeroes the block's
        update past each item's length (x is zero there already)."""
        residual = x
        x = F.conv1d(x.transpose(1, 2), self.dwconv.weight, self.dwconv.bias, padding=self.padding,
                     dilation=self.dilation, groups=x.shape[-1]).transpose(1, 2)
        x = self.pwconv1(self.norm(x))
        # exact erf in f32, the tanh form in bf16, as the JAX package
        x = F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")
        x = self.pwconv2(x)
        if self.gamma is not None:
            x = self.gamma * x
        return _masked_add(residual, drop_path(x, self.drop_path_rate, deterministic, gen), mask)


class ConvNeXtEncoder(nn.Module):
    """(reference: vocoders/ffgan/backbone.py:155-218)."""

    def __init__(self, input_channels: int = 3, depths: Sequence[int] = (3, 3, 9, 3),
                 dims: Sequence[int] = (96, 192, 384, 768), drop_path_rate: float = 0.0,
                 layer_scale_init_value: float = 1e-6, kernel_size: int = 7):
        super().__init__()
        self.downsample_layers = nn.ModuleList([nn.Sequential(
            nn.Conv1d(input_channels, dims[0], kernel_size, padding=kernel_size // 2),
            nn.LayerNorm(dims[0], eps=1e-6))])
        for i in range(1, len(dims)):
            self.downsample_layers.append(nn.Sequential(
                nn.LayerNorm(dims[i - 1], eps=1e-6), nn.Conv1d(dims[i - 1], dims[i], 1)))
        rates = torch.linspace(0, drop_path_rate, sum(depths)).tolist()
        self.stages = nn.ModuleList()
        cur = 0
        for depth, dim in zip(depths, dims):
            self.stages.append(nn.ModuleList([
                FFConvNeXtBlock(dim, float(rates[cur + j]), layer_scale_init_value, kernel_size=kernel_size)
                for j in range(depth)]))
            cur += depth
        self.norm = nn.LayerNorm(dims[-1], eps=1e-6)

    def forward(self, x, deterministic: bool = True, gen: Optional[torch.Generator] = None, mask=None):
        """x [B, T, input_channels] -> [B, T, dims[-1]]. With `mask` [B, T, 1]
        (x zero where it is 0) every block's input and the output are zero
        there too."""
        for i, (down, stage) in enumerate(zip(self.downsample_layers, self.stages)):
            if i == 0:
                x = down[1](conv1d_same(x, down[0]))
            else:
                x = conv1d_same(down[0](x), down[1])
            if mask is not None:
                x = x * mask
            for block in stage:
                x = block(x, deterministic, gen, mask)
        x = self.norm(x)
        return x if mask is None else x * mask


class ResBlock1(nn.Module):
    """HiFiGAN residual block of dilated conv pairs (reference: head.py:26-119)."""

    def __init__(self, channels: int, kernel_size: int = 3, dilation: Tuple[int, ...] = (1, 3, 5)):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilation = tuple(dilation)
        self.convs1 = nn.ModuleList([nn.Conv1d(channels, channels, kernel_size) for _ in self.dilation])
        self.convs2 = nn.ModuleList([nn.Conv1d(channels, channels, kernel_size) for _ in self.dilation])

    def forward(self, x, mask=None):
        """x [B, T, C]; with `mask` [B, T, 1] (x zero where it is 0) the
        output is zero there too, and so is every conv's input."""
        k = self.kernel_size
        for c1, c2, d in zip(self.convs1, self.convs2, self.dilation):
            xt = conv1d_dilated(F.silu(x), _kernel(c1), d, (k * d - d) // 2, c1.bias)
            h = F.silu(xt)
            if mask is not None:
                h = h.mul_(mask)
            xt = conv1d_dilated(h, _kernel(c2), 1, (k - 1) // 2, c2.bias)
            x = _masked_add(x, xt, mask)
        return x


class ParallelBlock(nn.Module):
    """Mean of parallel ResBlocks (reference: head.py:122-139, where it is
    spelt 'ParralelBlock')."""

    def __init__(self, channels: int, kernel_sizes: Sequence[int] = (3, 7, 11),
                 dilation_sizes: Sequence[Tuple[int, ...]] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))):
        super().__init__()
        self.blocks = nn.ModuleList([ResBlock1(channels, k, tuple(d)) for k, d in zip(kernel_sizes, dilation_sizes)])

    def forward(self, x, mask=None):
        return torch.stack([block(x, mask) for block in self.blocks], dim=0).mean(dim=0)


class HiFiGANGenerator(nn.Module):
    """(reference: vocoders/ffgan/head.py:142-248, the use_template=False path)."""

    def __init__(self, hop_length: int = 512, upsample_rates: Sequence[int] = (8, 8, 2, 2, 2),
                 upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4, 4),
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilation_sizes: Sequence[Tuple[int, ...]] = ((1, 3, 5), (1, 3, 5), (1, 3, 5)),
                 num_mels: int = 128, upsample_initial_channel: int = 512, pre_conv_kernel_size: int = 7,
                 post_conv_kernel_size: int = 7):
        super().__init__()
        self.hop_length = hop_length
        self.upsample_rates = tuple(upsample_rates)
        self.conv_pre = nn.Conv1d(num_mels, upsample_initial_channel, pre_conv_kernel_size,
                                  padding=(pre_conv_kernel_size - 1) // 2)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        ch = upsample_initial_channel
        for u, k in zip(upsample_rates, upsample_kernel_sizes):
            self.ups.append(nn.ConvTranspose1d(ch, ch // 2, k, u, padding=(k - u) // 2))
            ch //= 2
            self.resblocks.append(ParallelBlock(ch, resblock_kernel_sizes, resblock_dilation_sizes))
        self.conv_post = nn.Conv1d(ch, 1, post_conv_kernel_size, padding=(post_conv_kernel_size - 1) // 2)

    def forward(self, x, lengths=None):
        """x [B, T, num_mels] -> [B, T * prod(upsample_rates), 1]. With
        `lengths` [B] (x zero past them), every tensor a conv reads is zero
        past lengths[i] at its own rate, and so is the output."""
        frames, rate = x.shape[1], 1
        x = conv1d_same(x, self.conv_pre)
        if lengths is not None:
            x = x.mul_(rowmask(lengths, frames, rate, x.dtype))
        for up, u, blocks in zip(self.ups, self.upsample_rates, self.resblocks):
            k = up.weight.shape[-1]
            # ConvTranspose1d weight [C_in, C_out, k] -> [k, C_in, C_out]
            x = conv_transpose_1d(F.silu(x), up.weight.permute(2, 0, 1), u, (k - u) // 2, up.bias)
            rate *= u
            mask = rowmask(lengths, frames, rate, x.dtype)
            if mask is not None:
                x = x.mul_(mask)
            x = blocks(x, mask)
        y = torch.tanh(conv1d_same(F.silu(x), self.conv_post))
        return y if lengths is None else y.mul_(mask)


class FireflyGANBase(nn.Module):
    """mel [B, T, 128] -> waveform [B, T * 512] (reference:
    vocoders/ffgan/model.py:44-57). Runs on `device`: the GPU unless the
    caller passes "cpu". Opens the span "vocoder" (as Vocos does), with
    "ffgan.backbone" and "ffgan.head" around its two halves and none inside
    them, and counts `vocoder.frames_valid` and `vocoder.frames_computed`
    once a call."""

    def __init__(self, device=None):
        super().__init__()
        self.backbone = ConvNeXtEncoder(**FFGAN_CONFIG["backbone"])
        self.head = HiFiGANGenerator(**FFGAN_CONFIG["head"])
        self.to(resolve_device(device))

    @torch.no_grad()
    def forward(self, mel, lengths=None, deterministic: bool = True, gen: Optional[torch.Generator] = None):
        """lengths [B] (optional, each at most T): the lengths mode of the
        module docstring."""
        b, t = mel.shape[:2]
        with span("vocoder"):
            count("vocoder.frames_valid", b * t if lengths is None else lengths)
            count("vocoder.frames_computed", b * t)
            mask = None
            if lengths is not None:
                lengths = lengths.to(mel.device)
                mask = rowmask(lengths, t, 1, mel.dtype)
                mel = mel * mask
            with span("ffgan.backbone"):
                x = self.backbone(mel, deterministic, gen, mask)
            with span("ffgan.head"):
                return self.head(x, lengths)[..., 0]
