"""Plain PyTorch reference of StableTTS v1.1 inference and of Vocos, written
from the published model (KdaiP/StableTTS models/*.py, vocoders/vocos) as
functions over a state dict with the published parameter names.

It imports nothing of the measured program. Every operand and result of a
matrix product, convolution or attention product, every residual sum and
normalisation, and the flow's state go through `Precision.q`: the identity
for the float32 reference; for the control, a rounding to a lower format
(`Precision("fp8")` to float8 e4m3 with a per-tensor scale), so that the
control computes and stores in that format as a program serving in it would.
Activations are channels-last [B, T, C]; masks [B, T] are 1 where valid.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0


@dataclass(frozen=True)
class Precision:
    """`none`: float32 operands; `bf16`: operands of every product rounded to
    bfloat16; `fp8`: rounded to float8 e4m3 with a per-tensor amax scale.
    Products accumulate in float32."""

    mode: str = "none"

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "none":
            return x
        if self.mode == "bf16":
            return x.to(torch.bfloat16).to(x.dtype)
        if self.mode != "fp8":
            raise ValueError(f"unknown precision {self.mode!r}")
        xf = x.float()
        scale = xf.abs().amax().clamp(min=1e-12) / FP8_MAX
        return (xf / scale).to(torch.float8_e4m3fn).float() * scale


F32 = Precision()


def linear(x, w, b, p: Precision):
    return p.q(F.linear(p.q(x), p.q(w), b))


def conv_same(x, w, b, p: Precision, groups: int = 1):
    """Channels-last conv with SAME zero padding; w [Cout, Cin / groups, k]."""
    k = w.shape[-1]
    if k == 1 and groups == 1:
        return p.q(F.linear(p.q(x), p.q(w[..., 0]), b))
    return p.q(F.conv1d(p.q(x).transpose(1, 2), p.q(w), b, padding=k // 2, groups=groups).transpose(1, 2))


def seq_mask(lengths: torch.Tensor, t: int) -> torch.Tensor:
    return (torch.arange(t, device=lengths.device)[None, :] < lengths[:, None]).float()


def rope(x: torch.Tensor) -> torch.Tensor:
    """Partial rotary embedding over the first head_dim / 2 features of
    x [B, T, H, D], in the concatenated-halves form."""
    t, d = x.shape[1], x.shape[-1]
    rot = d // 2
    half = rot // 2
    theta = 1.0 / (10_000.0 ** (torch.arange(half, dtype=torch.float32, device=x.device) * 2.0 / rot))
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * theta[None, :]
    cos = torch.cat([ang.cos(), ang.cos()], -1)[None, :, None, :]
    sin = torch.cat([ang.sin(), ang.sin()], -1)[None, :, None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    neg = torch.cat([-xr[..., half:], xr[..., :half]], -1)
    return torch.cat([xr * cos + neg * sin, xp], -1)


def attention(q, k, v, key_mask, p: Precision):
    """q, k, v [B, T, H, D]; key_mask [B, T] or None. Softmax in float32."""
    logits = torch.einsum("bqhd,bkhd->bhqk", p.q(q), p.q(k)) / math.sqrt(q.shape[-1])
    if key_mask is not None:
        logits = logits.masked_fill(key_mask[:, None, None, :] <= 0, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return p.q(torch.einsum("bhqk,bkhd->bqhd", p.q(probs), p.q(v)))


def dit_block(P, pre, x, c, mask, n_heads, p: Precision):
    """adaLN-Zero DiT block with a k=3 conv FFN (models/diffusion_transformer.py)."""
    b, t, ch = x.shape
    m = mask[..., None]
    x = x * m
    mods = linear(F.silu(c), P[pre + "adaLN_modulation.2.weight"], P[pre + "adaLN_modulation.2.bias"], p)
    shift_a, scale_a, gate_a, shift_f, scale_f, gate_f = mods.view(b, 6, 1, ch).unbind(1)
    h = p.q(F.layer_norm(x, (ch,), eps=1e-5) * (1 + scale_a) + shift_a)
    heads = lambda z: z.reshape(b, t, n_heads, ch // n_heads)
    proj = lambda z, name: conv_same(z, P[pre + f"attn.{name}.weight"], P[pre + f"attn.{name}.bias"], p)
    q = rope(heads(proj(h, "conv_q")))
    k = rope(heads(proj(h, "conv_k")))
    v = heads(proj(h, "conv_v"))
    att = attention(q, k, v, mask, p).reshape(b, t, ch)
    x = p.q(x + gate_a * proj(att, "conv_o") * m)
    h = p.q(F.layer_norm(x, (ch,), eps=1e-5) * (1 + scale_f) + shift_f)
    h = F.silu(conv_same(h * m, P[pre + "mlp.conv_1.weight"], P[pre + "mlp.conv_1.bias"], p))
    h = conv_same(h * m, P[pre + "mlp.conv_2.weight"], P[pre + "mlp.conv_2.bias"], p) * m
    return p.q(x + gate_f * h)


def style_encoder(P, y_ref, ref_mask, p: Precision):
    """MelStyleEncoder (models/reference_encoder.py): [B, T, n_mels] -> [B, gin]."""
    pre = "ref_encoder."
    mish = lambda z: z * torch.tanh(F.softplus(z))
    x = mish(linear(y_ref, P[pre + "spectral.0.weight"], P[pre + "spectral.0.bias"], p))
    x = mish(linear(x, P[pre + "spectral.3.weight"], P[pre + "spectral.3.bias"], p))
    for i in range(2):
        h = conv_same(x, P[pre + f"temporal.{i}.conv1.weight"], P[pre + f"temporal.{i}.conv1.bias"], p)
        a, g = h.chunk(2, dim=-1)
        x = x + a * torch.sigmoid(g)
    b, t, c = x.shape
    qkv = linear(x, P[pre + "slf_attn.in_proj_weight"], P[pre + "slf_attn.in_proj_bias"], p)
    q, k, v = (z.reshape(b, t, 2, c // 2) for z in qkv.chunk(3, dim=-1))
    x = attention(q, k, v, ref_mask, p).reshape(b, t, c)
    x = linear(x, P[pre + "slf_attn.out_proj.weight"], P[pre + "slf_attn.out_proj.bias"], p)
    x = linear(x, P[pre + "fc.weight"], P[pre + "fc.bias"], p)
    if ref_mask is None:
        return x.mean(dim=1)
    m = ref_mask[..., None]
    return (x * m).sum(dim=1) / m.sum(dim=1)


def text_encoder(P, ids, x_lengths, c, cfg, p: Precision):
    hidden = cfg["hidden_channels"]
    h = P["encoder.emb.weight"][ids] * math.sqrt(hidden)
    mask = seq_mask(x_lengths, ids.shape[1])
    for i in range(cfg["n_enc_layers"]):
        h = dit_block(P, f"encoder.encoder.{i}.", h, c, mask, cfg["n_heads"], p)
    mu_x = conv_same(h, P["encoder.proj.weight"], P["encoder.proj.bias"], p) * mask[..., None]
    return h, mu_x, mask


def duration_predictor(P, h, mask, c, p: Precision):
    """Log-durations [B, Tx] (models/duration_predictor.py, inference)."""
    m = mask[..., None]
    x = h + conv_same(c[:, None, :], P["dp.cond.weight"], P["dp.cond.bias"], p)
    for i in (1, 2):
        x = torch.relu(conv_same(x * m, P[f"dp.conv{i}.weight"], P[f"dp.conv{i}.bias"], p))
        x = F.layer_norm(x, (x.shape[-1],), P[f"dp.norm{i}.weight"], P[f"dp.norm{i}.bias"], eps=1e-5)
    return (conv_same(x * m, P["dp.proj.weight"], P["dp.proj.bias"], p) * m)[..., 0]


def alignment(frames: torch.Tensor, t_y: int) -> torch.Tensor:
    """Per-phoneme frame counts [B, Tx] -> hard monotonic path [B, Tx, Ty]."""
    end = torch.cumsum(frames, dim=1)
    start = F.pad(end, (1, 0))[:, :-1]
    pos = torch.arange(t_y, device=frames.device, dtype=frames.dtype)[None, None, :]
    return ((pos >= start[..., None]) & (pos < end[..., None])).float()


def prenet(P, mu, p: Precision):
    pre = "decoder.estimator.cond_proj."
    h = F.silu(conv_same(mu, P[pre + "0.weight"], P[pre + "0.bias"], p))
    h = F.silu(conv_same(h, P[pre + "2.weight"], P[pre + "2.bias"], p))
    return conv_same(h, P[pre + "4.weight"], P[pre + "4.bias"], p)


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device) * -(math.log(10000.0) / (half - 1)))
    args = 1000.0 * t[:, None] * freqs[None, :]
    return torch.cat([args.sin(), args.cos()], dim=-1)


def estimator(P, t, x, mask, h_mu, c, cfg, p: Precision):
    """DiT U-Net velocity (models/estimator.py) with the prenet already applied to mu."""
    pre = "decoder.estimator."
    te = timestep_embedding(t, cfg["hidden_channels"])
    te = linear(te, P[pre + "time_mlp.layer.0.weight"], P[pre + "time_mlp.layer.0.bias"], p)
    te = linear(F.silu(te), P[pre + "time_mlp.layer.2.weight"], P[pre + "time_mlp.layer.2.bias"], p)
    h = conv_same(torch.cat([x, h_mu], dim=-1), P[pre + "in_proj.weight"], P[pre + "in_proj.bias"], p)
    m = mask[..., None]
    n = cfg["n_dec_layers"]
    skips = []
    for i in range(n):
        if i < n // 2:
            skips.append(h)
        else:
            j = i - n // 2
            h = conv_same(torch.cat([h, skips.pop()], dim=-1), P[pre + f"lsc_layers.{j}.weight"],
                          P[pre + f"lsc_layers.{j}.bias"], p)
        bp = pre + f"blocks.{i}."
        film = linear(te, P[bp + "time_fusion.film.weight"][..., 0], P[bp + "time_fusion.film.bias"], p)
        gamma, beta = film[:, None, :].chunk(2, dim=-1)
        h = p.q((gamma * h + beta) * m)
        h = dit_block(P, bp + "block.", h, c, mask, cfg["n_heads"], p)
    return conv_same(h * m, P[pre + "final_proj.weight"], P[pre + "final_proj.bias"], p) * m


def encode(P, ids, x_lengths, y_ref, ref_mask, cfg, p: Precision = F32):
    """Style vector, encoder output and the float durations w = exp(logw) [B, Tx]."""
    c = style_encoder(P, y_ref, ref_mask, p)
    h, mu_x, x_mask = text_encoder(P, ids, x_lengths, c, cfg, p)
    w = torch.exp(duration_predictor(P, h, x_mask, c, p)) * x_mask
    return c, mu_x, x_mask, w


def decode(P, c, mu_x, frames, noise, cap: int, steps: int, cfg_strength: float, cfg, p: Precision = F32,
           temperature: float = 1.0):
    """Flow-matching decoder: given per-phoneme frame counts [B, Tx], Euler
    over `steps` with classifier-free guidance. noise [B, cap, n_mels].
    Returns (mel [B, cap, n_mels] masked past y_lengths, y_lengths)."""
    b = mu_x.shape[0]
    y_lengths = frames.sum(dim=1).clamp(1, cap).long()
    y_mask = seq_mask(y_lengths, cap)
    path = alignment(frames, cap) * y_mask[:, None, :]
    mu_y = torch.einsum("bxy,bxc->byc", path, mu_x)
    h_mu = prenet(P, mu_y, p)
    n_mels = mu_x.shape[-1]
    fake_mu = P["fake_content"][0, :, 0][None, None, :].expand(b, cap, n_mels)
    fake_h_mu = prenet(P, fake_mu, p)
    fake_c = P["fake_speaker"].expand(b, -1)
    two = lambda a, b_: torch.cat([a, b_], dim=0)
    x = p.q(noise.float() * temperature)
    ts = p.q(torch.linspace(0.0, 1.0, steps + 1, device=x.device))
    for i in range(steps):
        t = ts[i].expand(b)
        out = estimator(P, two(t, t), two(x, x), two(y_mask, y_mask), two(h_mu, fake_h_mu), two(c, fake_c), cfg, p)
        cond, uncond = out[:b], out[b:]
        x = p.q(x + p.q(ts[i + 1] - ts[i]) * p.q(uncond + cfg_strength * (cond - uncond)))
    return x * y_mask[..., None], y_lengths


def frames_from_w(w: torch.Tensor, length_scale: float) -> torch.Tensor:
    return torch.ceil(w) * length_scale


# ---------------------------------------------------------------- Vocos

def vocos(P, mel: torch.Tensor, n_fft: int, hop: int, n_layers: int, p: Precision = F32) -> torch.Tensor:
    """Vocos (ConvNeXt backbone + ISTFT head) on one unpadded mel [T, n_mels]
    -> waveform [T * hop]."""
    x = conv_same(mel[None].float(), P["backbone.embed.weight"], P["backbone.embed.bias"], p)
    dim = x.shape[-1]
    x = p.q(F.layer_norm(x, (dim,), P["backbone.norm.weight"], P["backbone.norm.bias"], eps=1e-6))
    for i in range(n_layers):
        pre = f"backbone.convnext.{i}."
        h = conv_same(x, P[pre + "dwconv.weight"], P[pre + "dwconv.bias"], p, groups=dim)
        h = p.q(F.layer_norm(h, (dim,), P[pre + "norm.weight"], P[pre + "norm.bias"], eps=1e-6))
        h = p.q(F.gelu(linear(h, P[pre + "pwconv1.weight"], P[pre + "pwconv1.bias"], p)))
        x = p.q(x + P[pre + "gamma"] * linear(h, P[pre + "pwconv2.weight"], P[pre + "pwconv2.bias"], p))
    x = p.q(F.layer_norm(x, (dim,), P["backbone.final_layer_norm.weight"], P["backbone.final_layer_norm.bias"],
                         eps=1e-6))
    logits = linear(x, P["head.out.weight"], P["head.out.bias"], p)[0]
    logmag, phase = logits.chunk(2, dim=-1)
    mag = torch.clamp(torch.exp(logmag), max=1e2)
    spec = torch.complex(p.q(mag * torch.cos(phase)), p.q(mag * torch.sin(phase)))
    return istft_same(spec, n_fft, hop)


def hann(n: int, device) -> torch.Tensor:
    k = torch.arange(n, dtype=torch.float64, device=device)
    return (0.5 - 0.5 * torch.cos(2.0 * math.pi * k / n)).float()


def istft_same(spec: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """[T, n_fft // 2 + 1] complex -> [T * hop]: windowed inverse real DFT of
    each frame, overlap-add, division by the squared-window envelope, and
    (n_fft - hop) / 2 samples trimmed at each end (vocos head.py ISTFT, "same")."""
    t = spec.shape[0]
    win = hann(n_fft, spec.device)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * win
    length = (t - 1) * hop + n_fft
    idx = (torch.arange(t, device=spec.device)[:, None] * hop + torch.arange(n_fft, device=spec.device)[None, :])
    y = torch.zeros(length, device=spec.device).index_add_(0, idx.reshape(-1), frames.reshape(-1))
    env = torch.zeros(length, device=spec.device).index_add_(0, idx.reshape(-1), (win ** 2).repeat(t))
    pad = (n_fft - hop) // 2
    return y[pad:length - pad] / env[pad:length - pad]


# ---------------------------------------------------------------- log-mel of a reference clip

def _hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0), f * 3.0 / 200.0)


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), m * 200.0 / 3.0)


def slaney_filterbank(sample_rate: int, n_fft: int, n_mels: int) -> np.ndarray:
    """[n_fft // 2 + 1, n_mels] slaney-scale, slaney-normalised triangles."""
    freqs = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    f_pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sample_rate / 2.0), n_mels + 2))
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - freqs[:, None]
    fb = np.maximum(0.0, np.minimum(-slopes[:, :-2] / f_diff[:-1], slopes[:, 2:] / f_diff[1:]))
    return (fb * (2.0 / (f_pts[2:] - f_pts[:-2]))[None, :]).astype(np.float32)


def log_mel(wav: torch.Tensor, sample_rate: int, n_fft: int, hop: int, n_mels: int) -> torch.Tensor:
    """[L] waveform -> [T, n_mels]: reflect padding by (n_fft - hop) / 2,
    uncentred frames, periodic Hann window, sqrt(|X|^2 + 1e-6), slaney mels,
    log(clamp(., 1e-5)) (utils/audio.py)."""
    pad = (n_fft - hop) // 2
    x = F.pad(wav.float()[None, None, :], (pad, pad), mode="reflect")[0, 0]
    frames = x.unfold(0, n_fft, hop) * hann(n_fft, wav.device)
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    mag = torch.sqrt(spec.real.square() + spec.imag.square() + 1e-6)
    fb = torch.from_numpy(slaney_filterbank(sample_rate, n_fft, n_mels)).to(wav.device)
    return torch.log(torch.clamp(mag @ fb, min=1e-5))


def parameter_shapes(cfg: dict, n_vocab: int) -> dict:
    """{name: shape} of the published state dicts (acoustic model, then the
    vocoder under `vocoder.`), from the configuration's widths."""
    H, Fc, G, M = cfg["hidden_channels"], cfg["filter_channels"], cfg["gin_channels"], cfg["n_mels"]
    k = cfg["kernel_size"]
    s = {"fake_speaker": (1, G), "fake_content": (1, M, 1), "encoder.emb.weight": (n_vocab, H)}

    def block(pre):
        for n in ("q", "k", "v", "o"):
            s[pre + f"attn.conv_{n}.weight"] = (H, H, 1)
            s[pre + f"attn.conv_{n}.bias"] = (H,)
        s[pre + "mlp.conv_1.weight"] = (Fc, H, k)
        s[pre + "mlp.conv_1.bias"] = (Fc,)
        s[pre + "mlp.conv_2.weight"] = (H, Fc, k)
        s[pre + "mlp.conv_2.bias"] = (H,)
        s[pre + "adaLN_modulation.2.weight"] = (6 * H, G)
        s[pre + "adaLN_modulation.2.bias"] = (6 * H,)

    for i in range(cfg["n_enc_layers"]):
        block(f"encoder.encoder.{i}.")
    s["encoder.proj.weight"], s["encoder.proj.bias"] = (M, H, 1), (M,)
    r = "ref_encoder."
    s[r + "spectral.0.weight"], s[r + "spectral.0.bias"] = (128, M), (128,)
    s[r + "spectral.3.weight"], s[r + "spectral.3.bias"] = (128, 128), (128,)
    for i in range(2):
        s[r + f"temporal.{i}.conv1.weight"], s[r + f"temporal.{i}.conv1.bias"] = (256, 128, 5), (256,)
    s[r + "slf_attn.in_proj_weight"], s[r + "slf_attn.in_proj_bias"] = (384, 128), (384,)
    s[r + "slf_attn.out_proj.weight"], s[r + "slf_attn.out_proj.bias"] = (128, 128), (128,)
    s[r + "fc.weight"], s[r + "fc.bias"] = (G, 128), (G,)
    s["dp.cond.weight"], s["dp.cond.bias"] = (H, G, 1), (H,)
    s["dp.conv1.weight"], s["dp.conv1.bias"] = (Fc, H, k), (Fc,)
    s["dp.norm1.weight"], s["dp.norm1.bias"] = (Fc,), (Fc,)
    s["dp.conv2.weight"], s["dp.conv2.bias"] = (Fc, Fc, k), (Fc,)
    s["dp.norm2.weight"], s["dp.norm2.bias"] = (Fc,), (Fc,)
    s["dp.proj.weight"], s["dp.proj.bias"] = (1, Fc, 1), (1,)
    e = "decoder.estimator."
    s[e + "time_mlp.layer.0.weight"], s[e + "time_mlp.layer.0.bias"] = (Fc, H), (Fc,)
    s[e + "time_mlp.layer.2.weight"], s[e + "time_mlp.layer.2.bias"] = (H, Fc), (H,)
    s[e + "cond_proj.0.weight"], s[e + "cond_proj.0.bias"] = (Fc, M, k), (Fc,)
    s[e + "cond_proj.2.weight"], s[e + "cond_proj.2.bias"] = (Fc, Fc, k), (Fc,)
    s[e + "cond_proj.4.weight"], s[e + "cond_proj.4.bias"] = (H, Fc, k), (H,)
    s[e + "in_proj.weight"], s[e + "in_proj.bias"] = (H, M + H, 1), (H,)
    s[e + "final_proj.weight"], s[e + "final_proj.bias"] = (M, H, 1), (M,)
    for i in range(cfg["n_dec_layers"]):
        s[e + f"blocks.{i}.time_fusion.film.weight"] = (2 * H, H, 1)
        s[e + f"blocks.{i}.time_fusion.film.bias"] = (2 * H,)
        block(e + f"blocks.{i}.block.")
    for i in range(cfg["n_dec_layers"] // 2):
        s[e + f"lsc_layers.{i}.weight"], s[e + f"lsc_layers.{i}.bias"] = (H, 2 * H, k), (H,)

    v = cfg["vocoder"]
    D, I = v["dim"], v["intermediate_dim"]
    s["vocoder.backbone.embed.weight"], s["vocoder.backbone.embed.bias"] = (D, M, 7), (D,)
    s["vocoder.backbone.norm.weight"], s["vocoder.backbone.norm.bias"] = (D,), (D,)
    for i in range(v["num_layers"]):
        pre = f"vocoder.backbone.convnext.{i}."
        s[pre + "gamma"] = (D,)
        s[pre + "dwconv.weight"], s[pre + "dwconv.bias"] = (D, 1, 7), (D,)
        s[pre + "norm.weight"], s[pre + "norm.bias"] = (D,), (D,)
        s[pre + "pwconv1.weight"], s[pre + "pwconv1.bias"] = (I, D), (I,)
        s[pre + "pwconv2.weight"], s[pre + "pwconv2.bias"] = (D, I), (D,)
    s["vocoder.backbone.final_layer_norm.weight"] = (D,)
    s["vocoder.backbone.final_layer_norm.bias"] = (D,)
    s["vocoder.head.out.weight"], s["vocoder.head.out.bias"] = (cfg["n_fft"] + 2, D), (cfg["n_fft"] + 2,)
    return s
