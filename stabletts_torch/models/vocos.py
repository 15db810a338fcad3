"""Vocos vocoder: ConvNeXt backbone + ISTFT head, mel -> waveform in one
forward pass (reference: vocoders/vocos/models/{model,backbone,module,head}.py).

In eval mode the forward is the inference path of the JAX package's
`vocos_apply_fused`: each ConvNeXt block is one
`ops.convnext_cuda.convnext_block` call and the head, from its Dense output,
one `ops.istft_cuda.istft_head_from_logits` call (the spectrum pass and the
product: two CUDA kernels on the GPU; the span "vocoder.istft_head" of
`utils.metrics` inside the forward's span "vocoder"), under
`torch.no_grad()`. In train mode it is the differentiable composed path GAN
training needs, as the JAX generator trains through `model.apply`: library
convs and linears in the blocks and the plain linear ISTFT `istft_same_real`.
Layout: mel [B, T, n_mels] -> waveform [B, T * hop].
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from stabletts_torch.config import MelConfig, VocosConfig
from stabletts_torch.nn.blocks import conv1d_same
from stabletts_torch.ops.convnext_cuda import ConvNeXtWeights, convnext_block
from stabletts_torch.ops.istft import istft_same_real, spectrum_from_logits
from stabletts_torch.ops.istft_cuda import istft_head_from_logits
from stabletts_torch.utils.device import resolve_device
from stabletts_torch.utils.metrics import span


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, intermediate_dim: int, layer_scale_init_value: float):
        super().__init__()
        self.dwconv = nn.Conv1d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, intermediate_dim)
        self.pwconv2 = nn.Linear(intermediate_dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), float(layer_scale_init_value)))
        self._packed = None

    def kernel_weights(self) -> ConvNeXtWeights:
        """Kernel-layout copies, rebuilt only when a parameter changed."""
        params = tuple(self.parameters())
        key = tuple((p.data_ptr(), p._version, p.dtype, p.device) for p in params)
        if self._packed is None or self._packed[0] != key:
            with torch.no_grad():
                w = ConvNeXtWeights(
                    dw_w=self.dwconv.weight[:, 0, :].t().contiguous(),
                    dw_b=self.dwconv.bias.detach().clone(),
                    ln_w=self.norm.weight.detach().clone(),
                    ln_b=self.norm.bias.detach().clone(),
                    w1=self.pwconv1.weight.t().contiguous(),
                    b1=self.pwconv1.bias.detach().clone(),
                    w2=self.pwconv2.weight.t().contiguous(),
                    b2=self.pwconv2.bias.detach().clone(),
                    gamma=self.gamma.detach().clone(),
                )
            self._packed = (key, w)
        return self._packed[1]

    def forward(self, x):
        if not self.training:
            return convnext_block(x.contiguous(), self.kernel_weights())
        # differentiable composed path; GELU as the JAX package: erf form at f32, tanh form at bf16
        h = self.norm(self.dwconv(x.transpose(1, 2)).transpose(1, 2))
        h = F.gelu(self.pwconv1(h), approximate="tanh" if h.dtype == torch.bfloat16 else "none")
        return x + self.gamma * self.pwconv2(h)


class VocosBackbone(nn.Module):
    def __init__(self, input_channels: int, dim: int, intermediate_dim: int, num_layers: int):
        super().__init__()
        self.embed = nn.Conv1d(input_channels, dim, 7, padding=3)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.convnext = nn.ModuleList(
            ConvNeXtBlock(dim, intermediate_dim, 1.0 / num_layers) for _ in range(num_layers)
        )
        self.final_layer_norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x, rowmask=None):
        """rowmask [B, T, 1] (1 = valid) re-zeroes the activations after every
        block, so each SAME conv sees the zero padding of the trimmed input."""
        x = self.norm(conv1d_same(x, self.embed))
        if rowmask is not None:
            x = x * rowmask
        for block in self.convnext:
            x = block(x)
            if rowmask is not None:
                x = x * rowmask
        return self.final_layer_norm(x)


class ISTFTHead(nn.Module):
    """Linear -> (log-magnitude, phase) -> complex spectrum -> ISTFT: the
    kernels in eval, the plain differentiable ISTFT in training."""

    def __init__(self, dim: int, n_fft: int, hop_length: int):
        super().__init__()
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.out = nn.Linear(dim, n_fft + 2)

    def forward(self, x, lengths=None):
        logits = self.out(x)
        matmul_dtype = x.dtype if x.dtype != torch.float32 else None
        if not self.training:
            with span("vocoder.istft_head"):
                return istft_head_from_logits(logits, self.n_fft, self.hop_length, matmul_dtype, lengths)
        re, im = spectrum_from_logits(logits)
        if lengths is not None:
            raise ValueError("Vocos: the fixed-shape `lengths` mode is a serving mode (eval)")
        return istft_same_real(re, im, self.n_fft, self.hop_length, self.n_fft, matmul_dtype)


class Vocos(nn.Module):
    def __init__(self, vocos_config: VocosConfig | None = None, mel_config: MelConfig | None = None,
                 device=None):
        super().__init__()
        cfg = vocos_config or VocosConfig()
        mel_cfg = mel_config or MelConfig()
        if mel_cfg.win_length != mel_cfg.n_fft:
            raise ValueError("Vocos: the ISTFT head needs win_length == n_fft")
        self.backbone = VocosBackbone(cfg.input_channels, cfg.dim, cfg.intermediate_dim, cfg.num_layers)
        self.head = ISTFTHead(cfg.dim, mel_cfg.n_fft, mel_cfg.hop_length)
        self.to(resolve_device(device))
        self.eval()

    def forward(self, mel, lengths=None):
        """mel [B, T, n_mels] log-mel -> waveform [B, T * hop]. Eval mode runs
        under `torch.no_grad()` through the kernels; train mode is
        differentiable (see the module docstring).

        lengths [B] (optional): fixed-shape serving mode. Frames >= lengths[i]
        are treated as absent: the input and every block's output are zeroed
        there and the ISTFT envelope covers the valid frames only, so the
        result equals vocoding the trimmed mel and zero-padding the waveform."""
        with span("vocoder"):
            if self.training:
                return self._forward(mel, lengths)
            with torch.no_grad():
                return self._forward(mel, lengths)

    def _forward(self, mel, lengths):
        rowmask = None
        if lengths is not None:
            t = mel.shape[1]
            lengths = lengths.to(mel.device)
            rowmask = (torch.arange(t, device=mel.device)[None, :] < lengths[:, None]).to(mel.dtype)[..., None]
            mel = mel * rowmask
        x = self.backbone(mel, rowmask)
        return self.head(x, lengths)
