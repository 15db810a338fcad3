"""Plain PyTorch reference of F5-TTS v1 Base inference and of the 24 kHz Vocos,
written from the published code (SWivid/F5-TTS src/f5_tts/model/cfm.py
`CFM.sample`, backbones/dit.py `DiT`, modules.py; the sampling defaults of
infer/utils_infer.py: 32 steps, CFG 2, sway -1, speed 1; charactr's
vocos-mel-24khz) as functions over a state dict with the published parameter
names (`transformer.transformer_blocks.N.attn.to_q.weight`, ...).

It imports nothing of the measured program. The products, normalisations and
the flow's state go through `Precision.q` as in `stabletts_ref` (the identity
for the float32 reference; float8 e4m3 with a per-tensor scale for the
control). RoPE is x-transformers' interleaved form (`rotate_half` on pairs
(2i, 2i + 1)) on every feature of every head, as v1 Base's `pe_attn_head:
null` has it. Activations are channels-last [B, T, C].

Departures from the published code: padded keys are masked in attention
(v1 Base's attn_mask_enabled is false, so a padded batch lets them in); the
program computes in bfloat16 where F5-TTS on CUDA computes in float16. The
benchmark and the tests call `sample` on one item at a time, which is
F5-TTS's own batch of one: no padding, so the masks are all ones there.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.stabletts_ref import Precision, attention, linear, vocos

__all__ = ["F32", "Precision", "sample", "total_frames", "vocos", "parameter_shapes", "buffers"]

PRE = "transformer."
F32 = Precision()


def conv_same(x, w, b, p: Precision, groups: int = 1):
    """Channels-last conv with zero padding k // 2 on each side; w [Cout, Cin / groups, k]."""
    return p.q(F.conv1d(p.q(x).transpose(1, 2), p.q(w), b, padding=w.shape[-1] // 2, groups=groups).transpose(1, 2))


def total_frames(ref_frames: int, ref_text: str | bytes | int, gen_text: str | bytes | int, speed: float = 1.0) -> int:
    """infer/utils_infer.py: ref_audio_len + int(ref_audio_len / ref_text_len
    * gen_text_len / speed), the text lengths in UTF-8 bytes (or given as counts)."""
    nb = lambda s: s if isinstance(s, int) else len(s.encode("utf-8") if isinstance(s, str) else s)
    return ref_frames + int(ref_frames / nb(ref_text) * nb(gen_text) / speed)


def _sinus(t: torch.Tensor, dim: int, scale: float = 1000.0) -> torch.Tensor:
    """modules.py SinusPositionEmbedding."""
    half = dim // 2
    emb = torch.exp(torch.arange(half, device=t.device).float() * -(math.log(10000) / (half - 1)))
    emb = scale * t.float()[:, None] * emb[None, :]
    return torch.cat([emb.sin(), emb.cos()], dim=-1)


def _freqs_cis(dim: int, end: int, device) -> torch.Tensor:
    """modules.py precompute_freqs_cis (theta 10000)."""
    freqs = 1.0 / (10000.0 ** (torch.arange(0, dim, 2, device=device)[: dim // 2].float() / dim))
    ang = torch.outer(torch.arange(end, device=device), freqs).float()
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def _mish(x):
    return x * torch.tanh(F.softplus(x))


def _convnext_v2(P, pre, x, p: Precision):
    """modules.py ConvNeXtV2Block: dwconv 7, LayerNorm, Linear, GELU, GRN, Linear, residual."""
    dim = x.shape[-1]
    h = conv_same(x, P[pre + "dwconv.weight"], P[pre + "dwconv.bias"], p, groups=dim)
    h = p.q(F.layer_norm(h, (dim,), P[pre + "norm.weight"], P[pre + "norm.bias"], eps=1e-6))
    h = p.q(F.gelu(linear(h, P[pre + "pwconv1.weight"], P[pre + "pwconv1.bias"], p)))
    gx = torch.norm(h, p=2, dim=1, keepdim=True)
    nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
    h = p.q(P[pre + "grn.gamma"] * (h * nx) + P[pre + "grn.beta"] + h)
    return p.q(x + linear(h, P[pre + "pwconv2.weight"], P[pre + "pwconv2.bias"], p))


def text_embed(P, text, seq_len: int, drop_text: bool, cfg: dict, p: Precision = F32):
    """modules.py TextEmbedding (mask_padding, conv_layers > 0): text [B, nt]
    ids with -1 as padding -> [B, seq_len, text_dim]."""
    pre = PRE + "text_embed."
    text = (text + 1)[:, :seq_len]
    text = F.pad(text, (0, seq_len - text.shape[1]), value=0)
    text_mask = (text == 0)[..., None]
    if drop_text:
        text = torch.zeros_like(text)
    h = P[pre + "text_embed.weight"][text]
    pos = torch.arange(seq_len, device=text.device).clamp(max=4095)
    h = (h + _freqs_cis(cfg["text_dim"], 4096, text.device)[pos]).masked_fill(text_mask, 0.0)
    for i in range(cfg["conv_layers"]):
        h = _convnext_v2(P, pre + f"text_blocks.{i}.", h, p).masked_fill(text_mask, 0.0)
    return h


def input_embed(P, x, cond, text_emb, drop_audio_cond: bool, mask, p: Precision = F32):
    """modules.py InputEmbedding with ConvPositionEmbedding (k 31, 16 groups, Mish)."""
    pre = PRE + "input_embed."
    if drop_audio_cond:
        cond = torch.zeros_like(cond)
    h = linear(torch.cat([x, cond, text_emb], dim=-1), P[pre + "proj.weight"], P[pre + "proj.bias"], p)
    c = h if mask is None else h.masked_fill(~mask[..., None], 0.0)
    for i in (0, 2):
        w = P[pre + f"conv_pos_embed.conv1d.{i}.weight"]
        c = p.q(_mish(conv_same(c, w, P[pre + f"conv_pos_embed.conv1d.{i}.bias"], p,
                                groups=w.shape[0] // w.shape[1])))
    if mask is not None:
        c = c.masked_fill(~mask[..., None], 0.0)
    return p.q(c + h)


def rotary(t_len: int, dim_head: int, device) -> torch.Tensor:
    """x-transformers RotaryEmbedding.forward_from_seq_len: [T, D], each
    frequency twice in a row (interleaved pairs)."""
    inv = 1.0 / (10000.0 ** (torch.arange(0, dim_head, 2, device=device).float() / dim_head))
    f = torch.outer(torch.arange(t_len, device=device).float(), inv)
    return torch.stack([f, f], dim=-1).flatten(-2)


def rotate_half(x):
    """x-transformers: pairs (x1, x2) -> (-x2, x1)."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([-x2, x1], dim=-1).flatten(-2)


def apply_rotary(x, freqs):
    """x [B, T, H, D]; freqs [T, D]: the whole head rotates."""
    f = freqs[None, :, None, :]
    return x * f.cos() + rotate_half(x) * f.sin()


def dit_block(P, pre, x, t_emb, mask, freqs, heads: int, p: Precision):
    """dit.py DiTBlock: AdaLayerNorm, attention with RoPE, gated residual,
    LayerNorm modulated, GELU-tanh FFN, gated residual."""
    b, t, c = x.shape
    mods = linear(F.silu(t_emb), P[pre + "attn_norm.linear.weight"], P[pre + "attn_norm.linear.bias"], p)
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = (m[:, None, :] for m in mods.chunk(6, dim=1))
    norm = p.q(F.layer_norm(x, (c,), eps=1e-6) * (1 + scale_msa) + shift_msa)
    proj = lambda z, n: linear(z, P[pre + f"attn.{n}.weight"], P[pre + f"attn.{n}.bias"], p)
    heads_of = lambda z: z.view(b, t, heads, c // heads)
    q = p.q(apply_rotary(heads_of(proj(norm, "to_q")), freqs))
    k = p.q(apply_rotary(heads_of(proj(norm, "to_k")), freqs))
    v = heads_of(proj(norm, "to_v"))
    att = attention(q, k, v, None if mask is None else mask.float(), p).reshape(b, t, c)
    o = proj(att, "to_out.0")
    if mask is not None:
        o = o.masked_fill(~mask[..., None], 0.0)
    x = p.q(x + gate_msa * o)
    norm = p.q(F.layer_norm(x, (c,), eps=1e-6) * (1 + scale_mlp) + shift_mlp)
    h = p.q(F.gelu(linear(norm, P[pre + "ff.ff.0.0.weight"], P[pre + "ff.ff.0.0.bias"], p), approximate="tanh"))
    h = linear(h, P[pre + "ff.ff.2.weight"], P[pre + "ff.ff.2.bias"], p)
    return p.q(x + gate_mlp * h)


def dit(P, x, cond, text_cond, text_null, time, mask, cfg_infer: bool, cfg: dict, p: Precision = F32):
    """dit.py DiT.forward (long_skip_connection off), with the text
    embeddings cached (cache=True): the cond branch, and under cfg_infer the
    null branch (no prompt, no text) packed after it."""
    te = _sinus(time, cfg["freq_embed_dim"])
    te = linear(te, P[PRE + "time_embed.time_mlp.0.weight"], P[PRE + "time_embed.time_mlp.0.bias"], p)
    te = linear(F.silu(te), P[PRE + "time_embed.time_mlp.2.weight"], P[PRE + "time_embed.time_mlp.2.bias"], p)
    h = input_embed(P, x, cond, text_cond, False, mask, p)
    if cfg_infer:
        h = torch.cat([h, input_embed(P, x, cond, text_null, True, mask, p)])
        te = torch.cat([te, te])
        mask = torch.cat([mask, mask]) if mask is not None else None
    freqs = rotary(x.shape[1], cfg["dim_head"], x.device)
    for i in range(cfg["depth"]):
        h = dit_block(P, PRE + f"transformer_blocks.{i}.", h, te, mask, freqs, cfg["heads"], p)
    scale, shift = linear(F.silu(te), P[PRE + "norm_out.linear.weight"], P[PRE + "norm_out.linear.bias"],
                          p).chunk(2, dim=1)
    h = p.q(F.layer_norm(h, (h.shape[-1],), eps=1e-6) * (1 + scale)[:, None, :] + shift[:, None, :])
    return linear(h, P[PRE + "proj_out.weight"], P[PRE + "proj_out.bias"], p)


def sample(P, cond, text, duration, noise, cfg: dict, p: Precision = F32, lens=None):
    """cfm.py CFM.sample with Euler (odeint, method "euler"): cond [B, Tref,
    n_mels] the prompts' mels, text [B, nt] ids (-1 padding), duration [B]
    the total frames, noise [B, >= max duration, n_mels] (each item's first
    frames are its y0; F5-TTS pads y0 with zeros). Returns [B, max duration,
    n_mels] with the prompt frames kept from cond and the durations used."""
    b, cond_len = cond.shape[:2]
    dev = cond.device
    lens = torch.full((b,), cond_len, device=dev, dtype=torch.long) if lens is None else lens
    duration = torch.maximum(torch.maximum((text != -1).sum(dim=-1), lens) + 1, duration).clamp(max=4096)
    t_len = int(duration.amax())
    frames = torch.arange(t_len, device=dev)[None, :]
    cond_mask = (frames < lens[:, None])[..., None]
    step_cond = torch.where(cond_mask, F.pad(cond.float(), (0, 0, 0, t_len - cond_len)), 0.0)
    mask = frames < duration[:, None] if b > 1 else None
    text_cond = text_embed(P, text, t_len, False, cfg, p)
    text_null = text_embed(P, text, t_len, True, cfg, p)
    x = p.q(noise[:, :t_len].float() * (frames < duration[:, None])[..., None])
    steps, s = cfg["nfe_step"], cfg["sway_sampling_coef"]
    t = torch.linspace(0, 1, steps + 1, device=dev)
    t = p.q(t + s * (torch.cos(torch.pi / 2 * t) - 1 + t))
    strength = cfg["cfg_strength"]
    for i in range(steps):
        out = dit(P, x, step_cond, text_cond, text_null, t[i].expand(b), mask, strength >= 1e-5, cfg, p)
        if strength >= 1e-5:
            pred, null = out.chunk(2)
            out = p.q(pred + (pred - null) * strength)
        x = p.q(x + p.q(t[i + 1] - t[i]) * out)
    return torch.where(cond_mask, step_cond, x), duration


def parameter_shapes(cfg: dict) -> dict:
    """{name: shape} of the published parameters (the DiT under `transformer.`,
    then the vocoder under `vocoder.`), from the configuration's widths."""
    C, D, H = cfg["dim"], cfg["dim_head"], cfg["heads"]
    I, Td, M = cfg["dim"] * cfg["ff_mult"], cfg["text_dim"], cfg["n_mels"]
    fe, k, g = cfg["freq_embed_dim"], cfg["conv_pos_kernel"], cfg["conv_pos_groups"]
    s = {}
    s[PRE + "time_embed.time_mlp.0.weight"], s[PRE + "time_embed.time_mlp.0.bias"] = (C, fe), (C,)
    s[PRE + "time_embed.time_mlp.2.weight"], s[PRE + "time_embed.time_mlp.2.bias"] = (C, C), (C,)
    t = PRE + "text_embed."
    s[t + "text_embed.weight"] = (cfg["text_num_embeds"] + 1, Td)
    for i in range(cfg["conv_layers"]):
        pre = t + f"text_blocks.{i}."
        s[pre + "dwconv.weight"], s[pre + "dwconv.bias"] = (Td, 1, 7), (Td,)
        s[pre + "norm.weight"], s[pre + "norm.bias"] = (Td,), (Td,)
        s[pre + "pwconv1.weight"], s[pre + "pwconv1.bias"] = (2 * Td, Td), (2 * Td,)
        s[pre + "grn.gamma"], s[pre + "grn.beta"] = (1, 1, 2 * Td), (1, 1, 2 * Td)
        s[pre + "pwconv2.weight"], s[pre + "pwconv2.bias"] = (Td, 2 * Td), (Td,)
    e = PRE + "input_embed."
    s[e + "proj.weight"], s[e + "proj.bias"] = (C, 2 * M + Td), (C,)
    for i in (0, 2):
        s[e + f"conv_pos_embed.conv1d.{i}.weight"] = (C, C // g, k)
        s[e + f"conv_pos_embed.conv1d.{i}.bias"] = (C,)
    for i in range(cfg["depth"]):
        pre = PRE + f"transformer_blocks.{i}."
        s[pre + "attn_norm.linear.weight"], s[pre + "attn_norm.linear.bias"] = (6 * C, C), (6 * C,)
        for n in ("to_q", "to_k", "to_v"):
            s[pre + f"attn.{n}.weight"], s[pre + f"attn.{n}.bias"] = (H * D, C), (H * D,)
        s[pre + "attn.to_out.0.weight"], s[pre + "attn.to_out.0.bias"] = (C, H * D), (C,)
        s[pre + "ff.ff.0.0.weight"], s[pre + "ff.ff.0.0.bias"] = (I, C), (I,)
        s[pre + "ff.ff.2.weight"], s[pre + "ff.ff.2.bias"] = (C, I), (C,)
    s[PRE + "norm_out.linear.weight"], s[PRE + "norm_out.linear.bias"] = (2 * C, C), (2 * C,)
    s[PRE + "proj_out.weight"], s[PRE + "proj_out.bias"] = (M, C), (M,)

    v = cfg["vocoder"]
    Dv, Iv = v["dim"], v["intermediate_dim"]
    s["vocoder.backbone.embed.weight"], s["vocoder.backbone.embed.bias"] = (Dv, M, 7), (Dv,)
    s["vocoder.backbone.norm.weight"], s["vocoder.backbone.norm.bias"] = (Dv,), (Dv,)
    for i in range(v["num_layers"]):
        pre = f"vocoder.backbone.convnext.{i}."
        s[pre + "gamma"] = (Dv,)
        s[pre + "dwconv.weight"], s[pre + "dwconv.bias"] = (Dv, 1, 7), (Dv,)
        s[pre + "norm.weight"], s[pre + "norm.bias"] = (Dv,), (Dv,)
        s[pre + "pwconv1.weight"], s[pre + "pwconv1.bias"] = (Iv, Dv), (Iv,)
        s[pre + "pwconv2.weight"], s[pre + "pwconv2.bias"] = (Dv, Iv), (Dv,)
    s["vocoder.backbone.final_layer_norm.weight"] = (Dv,)
    s["vocoder.backbone.final_layer_norm.bias"] = (Dv,)
    s["vocoder.head.out.weight"], s["vocoder.head.out.bias"] = (cfg["n_fft"] + 2, Dv), (cfg["n_fft"] + 2,)
    return s


def buffers(cfg: dict, device=None) -> dict:
    """The published state dict's buffers: x-transformers' `inv_freq`."""
    d = cfg["dim_head"]
    return {PRE + "rotary_embed.inv_freq": 1.0 / (10000.0 ** (torch.arange(0, d, 2, device=device).float() / d))}
