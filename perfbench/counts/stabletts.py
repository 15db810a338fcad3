"""Operations and bytes that StableTTS inference needs for given inputs,
counted from the configuration's widths and each item's valid lengths (text
ids, mel frames), whatever implements the layers: padding past an item's
length is not counted. A multiply-add is two operations. Bytes count each
input (weights, activations entering a call) read once and each output
written once, in the cell's compute type.

A "call" is one launch of the layer over a batch: its least time on the
roofline is max(operations / peak, bytes / bandwidth), and a layer's least
time is the sum over its calls.
"""

from __future__ import annotations

from perfbench.counts.peaks import DTYPE_BYTES, least_seconds


def _w(cfg):
    return cfg["hidden_channels"], cfg["filter_channels"], cfg["gin_channels"], cfg["n_mels"], cfg["kernel_size"]


def dit_block_call(cfg: dict, lengths, dtype: str) -> tuple:
    """(operations, bytes) of one DiT block (adaLN modulation, attention
    half, conv FFN half) over items of valid lengths `lengths`."""
    H, F, G, _, k = _w(cfg)
    b = DTYPE_BYTES[dtype]
    flops, act = 0.0, 0.0
    for n in lengths:
        n = float(n)
        flops += n * (8 * H * H + 4 * k * H * F) + 4 * n * n * H + 2 * G * 6 * H
        act += 2 * n * H * b + 6 * H * b
    weights = (4 * H * H + 2 * k * H * F + 6 * H * G) * b
    return flops, weights + act


def vocoder_call(cfg: dict, lengths, dtype: str) -> tuple:
    """(operations, bytes) of one Vocos forward (embedding conv, ConvNeXt
    blocks, head, inverse DFT of every frame) over mels of `lengths` frames;
    bytes: weights, the inverse-DFT matrix, the mels in and the waveforms out."""
    v = cfg["vocoder"]
    D, I, nl = v["dim"], v["intermediate_dim"], v["num_layers"]
    M, n_fft, hop = cfg["n_mels"], cfg["n_fft"], cfg["hop_length"]
    b = DTYPE_BYTES[dtype]
    per_frame = 2 * M * 7 * D + nl * (2 * 7 * D + 4 * D * I) + 2 * D * (n_fft + 2) + 2 * (n_fft + 2) * n_fft
    frames = float(sum(lengths))
    weights = (M * 7 * D + nl * (7 * D + 2 * D * I) + D * (n_fft + 2) + (n_fft + 2) * n_fft) * b
    return frames * per_frame, weights + frames * (M + hop) * b


def style_flops(cfg: dict, ref_frames: int) -> float:
    G, M = cfg["gin_channels"], cfg["n_mels"]
    r = float(ref_frames)
    return 2 * r * (M * 128 + 128 * 128 + 2 * 5 * 128 * 256 + 128 * 384 + 128 * 128 + 128 * G) + 4 * r * r * 128


def synthesis_flops(cfg: dict, x_lengths, y_lengths, ref_frames, n_steps: int, cfg_on: bool) -> float:
    """All operations of one synthesis batch at the items' valid lengths:
    style encoder, text encoder, duration predictor, prenet, every estimator
    evaluation (both CFG branches) and no vocoder."""
    H, F, G, M, k = _w(cfg)
    rows = 2 if cfg_on else 1
    total = 0.0
    for lx, ly, r in zip(x_lengths, y_lengths, ref_frames):
        lx, ly = float(lx), float(ly)
        total += style_flops(cfg, r)
        total += cfg["n_enc_layers"] * dit_block_call(cfg, [lx], "float32")[0] + 2 * lx * H * M
        total += 2 * lx * k * H * F + 2 * lx * k * F * F + 2 * lx * F
        total += rows * 2 * ly * k * (M * F + F * F + F * H)
        per_eval = (2 * ly * (M + H) * H + cfg["n_dec_layers"] * dit_block_call(cfg, [ly], "float32")[0]
                    + (cfg["n_dec_layers"] // 2) * 2 * ly * k * 2 * H * H + 2 * ly * H * M)
        total += n_steps * rows * per_eval
    return total


def dit_blocks_least_s(cfg: dict, x_lengths, y_lengths, n_steps: int, cfg_on: bool, dtype: str) -> float:
    """Least seconds of every DiT block call of one synthesis batch: the text
    encoder's blocks over the items, and the estimator's over both CFG
    branches at every step."""
    enc = least_seconds(*dit_block_call(cfg, x_lengths, dtype), dtype)
    est_rows = list(y_lengths) * (2 if cfg_on else 1)
    est = least_seconds(*dit_block_call(cfg, est_rows, dtype), dtype)
    return cfg["n_enc_layers"] * enc + n_steps * cfg["n_dec_layers"] * est


def vocoder_least_s(cfg: dict, y_lengths, dtype: str) -> float:
    return least_seconds(*vocoder_call(cfg, y_lengths, dtype), dtype)
