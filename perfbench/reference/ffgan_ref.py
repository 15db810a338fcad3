"""Plain PyTorch reference of FireflyGAN, fish-audio's firefly-gan-base
generator as KdaiP/StableTTS hard-codes it (vocoders/ffgan/model.py:7-29,
backbone.py, head.py): a ConvNeXt encoder, then a HiFiGAN generator that
upsamples by 512. Functions over a state dict under the names of the
published modules (`backbone.*`, `head.*`), one item at a time.

It imports nothing of the measured program. Every operand and result of a
convolution or linear layer, every residual sum, normalisation and mean goes
through `Precision.q` (`stabletts_ref`): the identity for the float32
reference, a rounding to a lower format for the control. The caller keeps
TF32 off, as the harness does.

Departures from the published modules:
- weight norm is folded (w = g v / ||v|| over all axes but the first), as
  a checkpoint is loaded: the state dict holds plain conv weights;
- drop path (stochastic depth) is inference's identity, and GELU is the
  exact (erf) form, the published `nn.GELU()`;
- activations are channels-last [T, C], and the published
  `LayerNorm(data_format="channels_first")` is `F.layer_norm` over C;
- `F.silu` in place of the published in-place `F.silu(x, inplace=True)`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.stabletts_ref import F32, Precision


def _conv(x, w, b, p: Precision, padding: int, dilation: int = 1, groups: int = 1):
    """x [T, C_in] channels-last, w [C_out, C_in / groups, k] -> [T', C_out]."""
    y = F.conv1d(p.q(x).t()[None], p.q(w), b, padding=padding, dilation=dilation, groups=groups)
    return p.q(y[0].t())


def _layer_norm(P, name: str, x, p: Precision):
    return p.q(F.layer_norm(x, (x.shape[-1],), P[name + ".weight"], P[name + ".bias"], eps=1e-6))


def _linear(P, name: str, x, p: Precision):
    return p.q(F.linear(p.q(x), p.q(P[name + ".weight"]), P[name + ".bias"]))


def backbone(P, mel, v: dict, p: Precision = F32):
    """ConvNeXtEncoder (backbone.py:155-218): mel [T, 128] -> [T, 512]."""
    b = v["backbone"]
    k = b["kernel_size"]
    pre = "backbone.downsample_layers."
    x = _conv(mel, P[pre + "0.0.weight"], P[pre + "0.0.bias"], p, k // 2)
    x = _layer_norm(P, pre + "0.1", x, p)
    for i, (depth, dim) in enumerate(zip(b["depths"], b["dims"])):
        if i > 0:
            x = _layer_norm(P, pre + f"{i}.0", x, p)
            x = _conv(x, P[pre + f"{i}.1.weight"], P[pre + f"{i}.1.bias"], p, 0)
        for j in range(depth):
            s = f"backbone.stages.{i}.{j}."
            h = _conv(x, P[s + "dwconv.weight"], P[s + "dwconv.bias"], p, k // 2, groups=dim)
            h = _layer_norm(P, s + "norm", h, p)
            h = p.q(F.gelu(_linear(P, s + "pwconv1", h, p)))
            h = _linear(P, s + "pwconv2", h, p)
            x = p.q(x + P[s + "gamma"] * h)
    return _layer_norm(P, "backbone.norm", x, p)


def _resblock(P, pre: str, x, k: int, dilations, p: Precision):
    """ResBlock1 (head.py:26-119): pairs of a dilated and an undilated conv."""
    for j, d in enumerate(dilations):
        xt = _conv(F.silu(x), P[pre + f"convs1.{j}.weight"], P[pre + f"convs1.{j}.bias"], p, (k * d - d) // 2, d)
        xt = _conv(F.silu(xt), P[pre + f"convs2.{j}.weight"], P[pre + f"convs2.{j}.bias"], p, (k - 1) // 2)
        x = p.q(xt + x)
    return x


def head(P, x, v: dict, p: Precision = F32):
    """HiFiGANGenerator (head.py:142-248, use_template False): [T, 512] ->
    waveform [T x prod(upsample_rates)]."""
    h = v["head"]
    kp, kq = h["pre_conv_kernel_size"], h["post_conv_kernel_size"]
    x = _conv(x, P["head.conv_pre.weight"], P["head.conv_pre.bias"], p, (kp - 1) // 2)
    for i, (u, k) in enumerate(zip(h["upsample_rates"], h["upsample_kernel_sizes"])):
        y = F.conv_transpose1d(p.q(F.silu(x)).t()[None], p.q(P[f"head.ups.{i}.weight"]), P[f"head.ups.{i}.bias"],
                               stride=u, padding=(k - u) // 2)
        x = p.q(y[0].t())
        branches = [_resblock(P, f"head.resblocks.{i}.blocks.{r}.", x, kr, dr, p)
                    for r, (kr, dr) in enumerate(zip(h["resblock_kernel_sizes"], h["resblock_dilation_sizes"]))]
        x = p.q(torch.stack(branches, dim=0).mean(dim=0))
    x = _conv(F.silu(x), P["head.conv_post.weight"], P["head.conv_post.bias"], p, (kq - 1) // 2)
    return torch.tanh(x)[:, 0]


def vocode(P, mel, v: dict, p: Precision = F32):
    """FireflyGANBase (model.py:44-57) on one unpadded mel [T, n_mels] ->
    waveform [T x 512]."""
    return head(P, backbone(P, mel.float(), v, p), v, p)


def parameter_shapes(v: dict, prefix: str = "") -> dict:
    """{name: shape} of the generator's state dict (weight norm folded), from
    the configuration's `vocoder` section, each name under `prefix`."""
    b, h = v["backbone"], v["head"]
    k, dims = b["kernel_size"], b["dims"]
    s = {}
    pre = "backbone.downsample_layers."
    s[pre + "0.0.weight"], s[pre + "0.0.bias"] = (dims[0], b["input_channels"], k), (dims[0],)
    s[pre + "0.1.weight"], s[pre + "0.1.bias"] = (dims[0],), (dims[0],)
    for i in range(1, len(dims)):
        s[pre + f"{i}.0.weight"], s[pre + f"{i}.0.bias"] = (dims[i - 1],), (dims[i - 1],)
        s[pre + f"{i}.1.weight"], s[pre + f"{i}.1.bias"] = (dims[i], dims[i - 1], 1), (dims[i],)
    for i, (depth, d) in enumerate(zip(b["depths"], dims)):
        for j in range(depth):
            st = f"backbone.stages.{i}.{j}."
            s[st + "gamma"] = (d,)
            s[st + "dwconv.weight"], s[st + "dwconv.bias"] = (d, 1, k), (d,)
            s[st + "norm.weight"], s[st + "norm.bias"] = (d,), (d,)
            s[st + "pwconv1.weight"], s[st + "pwconv1.bias"] = (4 * d, d), (4 * d,)
            s[st + "pwconv2.weight"], s[st + "pwconv2.bias"] = (d, 4 * d), (d,)
    s["backbone.norm.weight"], s["backbone.norm.bias"] = (dims[-1],), (dims[-1],)
    ch = h["upsample_initial_channel"]
    s["head.conv_pre.weight"] = (ch, h["num_mels"], h["pre_conv_kernel_size"])
    s["head.conv_pre.bias"] = (ch,)
    for i, k_up in enumerate(h["upsample_kernel_sizes"]):
        s[f"head.ups.{i}.weight"], s[f"head.ups.{i}.bias"] = (ch, ch // 2, k_up), (ch // 2,)
        ch //= 2
    ch = h["upsample_initial_channel"]
    for i in range(len(h["upsample_rates"])):
        ch //= 2
        for r, (kr, dr) in enumerate(zip(h["resblock_kernel_sizes"], h["resblock_dilation_sizes"])):
            for conv in ("convs1", "convs2"):
                for j in range(len(dr)):
                    name = f"head.resblocks.{i}.blocks.{r}.{conv}.{j}."
                    s[name + "weight"], s[name + "bias"] = (ch, ch, kr), (ch,)
    s["head.conv_post.weight"], s["head.conv_post.bias"] = (1, ch, h["post_conv_kernel_size"]), (1,)
    return {prefix + name: shape for name, shape in s.items()}
