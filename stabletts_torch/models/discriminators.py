"""GAN discriminators for vocoder training: multi-period (MPD) and
multi-resolution (MRD) (reference: vocoders/vocos/models/discriminator.py).

Audio is [B, T]; the conv stacks run in torch's NCHW. State-dict names are
the reference's, with weight norm stored as the pair
`<conv>.parametrizations.weight.original0` (g, [out, 1, 1, 1]) and
`.original1` (v, [out, in, kh, kw]). The fold is the JAX package's (flax
`nn.WeightNorm`): w = v * rsqrt(sum(v^2 over all dims but out) + 1e-12) * g,
written out here so that a train step can fold every kernel once per loss
evaluation (`fold`) and hand the folded kernels to all of its applications
(`forward(..., folded=...)`), as the JAX step does.

Feature maps are [B, C, L, W] (NCHW): the JAX package's [B, L, W, C] maps
permuted (0, 3, 1, 2).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from stabletts_torch.ops.mpd_cuda import LEAK, fold_period
from stabletts_torch.ops.stft import hann_window

Folded = List[Tuple[torch.Tensor, torch.Tensor]]  # (kernel, bias) per conv, in the module's conv order


def fold_weight_norm(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """v * rsqrt(sum(v^2, all dims but 0) + 1e-12) * g, in v's dtype."""
    norm = torch.rsqrt((v * v).sum(dim=tuple(range(1, v.ndim)), keepdim=True) + 1e-12)
    return v * norm * g


class _WeightNormPair(nn.Module):
    def __init__(self, v: torch.Tensor):
        super().__init__()
        g = v.detach().square().sum(dim=tuple(range(1, v.ndim)), keepdim=True).sqrt()
        self.original0 = nn.Parameter(g)
        self.original1 = nn.Parameter(v.detach().clone())


class WNConv2d(nn.Module):
    """Conv2d whose kernel is the weight-norm pair (g, v), initialised as
    torch's `weight_norm(nn.Conv2d(...))`."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=(1, 1), padding=(0, 0)):
        super().__init__()
        conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride, padding)
        self.stride, self.padding = tuple(conv.stride), tuple(conv.padding)
        self.parametrizations = nn.ModuleDict({"weight": _WeightNormPair(conv.weight)})
        self.bias = nn.Parameter(conv.bias.detach().clone())

    def fold(self, dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(folded kernel, bias); with `dtype`, g, v and the bias are cast
        first and the fold runs in that dtype (the JAX step's order)."""
        pair = self.parametrizations["weight"]
        g, v, b = pair.original0, pair.original1, self.bias
        if dtype is not None:
            g, v, b = g.to(dtype), v.to(dtype), b.to(dtype)
        return fold_weight_norm(g, v), b

    def forward(self, x, folded=None):
        """The conv in the wider of the input's and the kernel's types (flax's
        promotion): f32 input against bf16-folded kernels runs in f32."""
        w, b = folded if folded is not None else self.fold()
        dtype = torch.promote_types(x.dtype, w.dtype)
        return F.conv2d(x.to(dtype), w.to(dtype), b.to(dtype), self.stride, self.padding)


def _fold_all(convs, dtype) -> Folded:
    return [c.fold(dtype) for c in convs]


class DiscriminatorP(nn.Module):
    """Period discriminator: 2D convs over period-folded audio
    (reference: discriminator.py:32-75). Returns (logits [B, L5 * period],
    5 feature maps: the outputs of convs 1-4 and of conv_post; conv 0's is
    not among them, as in the JAX package)."""

    channels = (32, 128, 512, 1024, 1024)

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period = period
        pad = (kernel_size // 2, 0)
        ins = (1,) + self.channels[:-1]
        self.convs = nn.ModuleList(
            WNConv2d(cin, cout, (kernel_size, 1), (stride if i < 4 else 1, 1), pad)
            for i, (cin, cout) in enumerate(zip(ins, self.channels)))
        self.conv_post = WNConv2d(1024, 1, (3, 1), (1, 1), (1, 0))

    def all_convs(self):
        return [*self.convs, self.conv_post]

    def fold(self, dtype=None) -> Folded:
        return _fold_all(self.all_convs(), dtype)

    def forward(self, x, folded: Optional[Folded] = None):
        folded = folded if folded is not None else self.fold()
        h = fold_period(x, self.period)
        fmap = []
        for i, conv in enumerate(self.convs):
            h = F.leaky_relu(conv(h, folded[i]), LEAK)
            if i > 0:
                fmap.append(h)
        h = self.conv_post(h, folded[5])
        fmap.append(h)
        return h.flatten(1), fmap


class _MultiDiscriminator(nn.Module):
    """Several discriminators over the same audio. Real and fake are two
    calls per discriminator, as in the reference and the JAX package (which
    measured one concatenated [2B] call slower)."""

    discriminators: nn.ModuleList

    def fold(self, dtype=None) -> List[Folded]:
        return [d.fold(dtype) for d in self.discriminators]

    def forward(self, y, y_hat, folded: Optional[List[Folded]] = None):
        """-> (real logits, fake logits, real feature maps, fake feature maps), one entry per discriminator."""
        folded = folded if folded is not None else self.fold()
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        for d, f in zip(self.discriminators, folded):
            r, fr = d(y, f)
            g, fg = d(y_hat, f)
            y_d_rs.append(r)
            y_d_gs.append(g)
            fmap_rs.append(fr)
            fmap_gs.append(fg)
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs


class MultiPeriodDiscriminator(_MultiDiscriminator):
    """(reference: discriminator.py:11-29)."""

    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11)):
        super().__init__()
        self.discriminators = nn.ModuleList(DiscriminatorP(p) for p in periods)


def stft_real_imag(x: torch.Tensor, n_fft: int, hop: int, win: int) -> torch.Tensor:
    """Center-padded STFT as real/imag channels: [B, T_frames, n_freqs, 2]
    (torchaudio Spectrogram(power=None): center=True, reflect). The window
    multiplies the first `win` samples of each frame, so win == n_fft is the
    case the discriminators use. Frames, FFT and result are f32 whatever x's
    type, as the JAX package's f32 window promotes them."""
    window = torch.from_numpy(hann_window(win)).to(x.device)
    pad = n_fft // 2
    xp = F.pad(x.float()[:, None, :], (pad, pad), mode="reflect")[:, 0, :]
    frames = xp.unfold(-1, n_fft, hop) * window
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    return torch.stack([spec.real, spec.imag], dim=-1)


class DiscriminatorR(nn.Module):
    """Resolution discriminator over banded complex spectrograms
    (reference: discriminator.py:113-170). Returns (logits [B, 1, T, F'],
    feature maps [B, C, T, F''])."""

    bands = ((0.0, 0.1), (0.1, 0.25), (0.25, 0.5), (0.5, 0.75), (0.75, 1.0))

    def __init__(self, window_length: int, channels: int = 32, hop_factor: float = 0.25):
        super().__init__()
        self.window_length = window_length
        self.hop = int(window_length * hop_factor)
        n_freqs = window_length // 2 + 1
        self.band_idx = [(int(lo * n_freqs), int(hi * n_freqs)) for lo, hi in self.bands]

        def stack():
            return nn.ModuleList([
                WNConv2d(2, channels, (3, 9), (1, 1), (1, 4)),
                WNConv2d(channels, channels, (3, 9), (1, 2), (1, 4)),
                WNConv2d(channels, channels, (3, 9), (1, 2), (1, 4)),
                WNConv2d(channels, channels, (3, 9), (1, 2), (1, 4)),
                WNConv2d(channels, channels, (3, 3), (1, 1), (1, 1)),
            ])

        self.band_convs = nn.ModuleList(stack() for _ in self.bands)
        self.conv_post = WNConv2d(channels, 1, (3, 3), (1, 1), (1, 1))

    def all_convs(self):
        return [c for stack in self.band_convs for c in stack] + [self.conv_post]

    def fold(self, dtype=None) -> Folded:
        return _fold_all(self.all_convs(), dtype)

    def forward(self, x, folded: Optional[Folded] = None):
        folded = folded if folded is not None else self.fold()
        spec = stft_real_imag(x, self.window_length, self.hop, self.window_length)
        spec = spec.permute(0, 3, 1, 2)  # [B, 2, T, F]
        fmap, outs = [], []
        for bi, (stack, (lo, hi)) in enumerate(zip(self.band_convs, self.band_idx)):
            h = spec[..., lo:hi]
            for i, conv in enumerate(stack):
                h = F.leaky_relu(conv(h, folded[bi * 5 + i]), LEAK)
                if i > 0:
                    fmap.append(h)
            outs.append(h)
        h = self.conv_post(torch.cat(outs, dim=-1), folded[-1])
        fmap.append(h)
        return h, fmap


class MultiResolutionDiscriminator(_MultiDiscriminator):
    """(reference: discriminator.py:78-111)."""

    def __init__(self, fft_sizes: Sequence[int] = (2048, 1024, 512)):
        super().__init__()
        self.discriminators = nn.ModuleList(DiscriminatorR(w) for w in fft_sizes)
