"""Seeded weights for both sides: one uniform draw on the device from a
`torch.Generator`, cut into the published state dict and scaled by a fixed
rule per kind of parameter.

The rule keeps every layer active (the adaLN-Zero modulation is not zero, as
it is at initialisation, so every DiT block computes), the estimator's
output projection has the configuration's `velocity_gain`, so that the flow
moves the noise about as far as a trained model's does, and
`calibrate_durations` sets the duration predictor's output bias so that
every seed speaks at the same rate and the work per run does not depend on
the seed.
"""

from __future__ import annotations

import math

import torch


def _scale(name: str, shape: tuple, shapes: dict, cfg: dict) -> tuple:
    """(scale, offset): the parameter is offset + scale * u, u ~ U(-1, 1)."""
    leaf = name.rsplit(".", 1)[-1]
    if name.endswith("emb.weight"):
        return math.sqrt(3.0) / math.sqrt(shape[1]), 0.0
    if name in ("fake_speaker", "fake_content"):
        return 0.5, 0.0
    if name == "dp.proj.bias":
        return 0.0, 0.0  # set by calibrate_durations
    if leaf == "gamma":
        return 0.1 / cfg["vocoder"]["num_layers"], 1.0 / cfg["vocoder"]["num_layers"]
    if len(shape) == 1 and "norm" in name:
        return (0.1, 1.0) if leaf == "weight" else (0.1, 0.0)
    gain = cfg["weights"]["velocity_gain"] if name.startswith("decoder.estimator.final_proj.") else 1.0
    if len(shape) >= 2:
        return gain / math.sqrt(math.prod(shape[1:])), 0.0
    weight = name[: -len("bias")] + "weight" if leaf == "bias" else name[: -len("_bias")] + "_weight"
    w = shapes.get(weight)
    fan_in = math.prod(w[1:]) if w is not None else shape[0]
    return gain / math.sqrt(fan_in), 0.0


def smooth_time_embedding(weights: dict, cfg: dict) -> None:
    """Scales, in place, the columns of the estimator's first time-MLP layer
    by exp(-1000 f / cutoff), f each sinusoid's frequency (the embedding is
    sin and cos of 1000 t f): a trained flow's velocity is smooth in t, and
    random weights that read every frequency alike make it change by O(1)
    when t moves by a rounding error."""
    name = "decoder.estimator.time_mlp.layer.0.weight"
    w = weights[name]
    half = w.shape[1] // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=w.device) * -(math.log(10000.0) / (half - 1)))
    g = torch.exp(-1000.0 * freqs / cfg["weights"]["time_cutoff"])
    w.mul_(torch.cat([g, g]).to(w.dtype)[None, :])


def make_weights(shapes: dict, cfg: dict, seed: int, device, dtype=torch.float32) -> dict:
    """{name: tensor} for every entry of `shapes`, drawn from `seed` on
    `device` in one call and stored in `dtype` (the type they are served in)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(s) for s in shapes.values())
    u = torch.rand(total, generator=gen, device=device, dtype=torch.float32).mul_(2.0).sub_(1.0)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        scale, offset = _scale(name, shape, shapes, cfg)
        out[name] = (u[at:at + n].view(shape) * scale + offset).to(dtype)
        at += n
    if "time_cutoff" in cfg["weights"]:
        smooth_time_embedding(out, cfg)
    return out


def split(weights: dict, prefix: str = "vocoder.") -> tuple:
    """(acoustic model's state dict, vocoder's state dict without the prefix)."""
    tts = {k: v for k, v in weights.items() if not k.startswith(prefix)}
    voc = {k[len(prefix):]: v for k, v in weights.items() if k.startswith(prefix)}
    return tts, voc


def calibrate_durations(weights: dict, cfg: dict, seed: int, device, ids=None, y_ref=None) -> None:
    """Shifts the duration predictor's output bias, in place, so that the
    mean log-duration over a calibration batch is the configuration's
    `weights.mean_log_duration`: the speaking rate of random weights
    otherwise moves by a factor of two from seed to seed. The batch is the
    cell's own id sequences `ids` (a list) and reference mel `y_ref`
    [T, n_mels] where given, else 8 x 64 random phonemes and a random mel
    drawn from the seed. The calibration runs the plain reference in float32."""
    from perfbench.reference import stabletts_ref as R

    gen = torch.Generator(device=device).manual_seed(seed + 1)
    if ids is None:
        b, n = 8, 64
        x = torch.zeros(b, 2 * n + 1, dtype=torch.long, device=device)
        x[:, 1::2] = torch.randint(1, cfg["n_vocab"], (b, n), generator=gen, device=device)
        lengths = torch.full((b,), 2 * n + 1, device=device)
    else:
        b = len(ids)
        x = torch.zeros(b, max(len(i) for i in ids), dtype=torch.long, device=device)
        for row, seq in enumerate(ids):
            x[row, :len(seq)] = torch.tensor(seq, device=device)
        lengths = torch.tensor([len(i) for i in ids], device=device)
    if y_ref is None:
        y_ref = torch.randn(b, 256, cfg["n_mels"], generator=gen, device=device) * 2.0 - 5.0
    else:
        y_ref = y_ref.float()[None].expand(b, -1, -1)
    tts = {k: v.float() for k, v in weights.items() if not k.startswith("vocoder.")}
    with torch.no_grad():
        _, _, mask, w = R.encode(tts, x, lengths, y_ref, None, cfg)
        mean = torch.log(w[mask > 0]).mean()
        bias = weights["dp.proj.bias"]
        bias.copy_((bias.float() + cfg["weights"]["mean_log_duration"] - mean).to(bias.dtype))
