"""Operations and bytes that F5-TTS v1 Base inference needs for given inputs,
counted from the configuration's widths and each item's valid frames (the
prompt's and the generation's together: the estimator computes both),
whatever implements the layers; padding past an item's frames is not
counted. A multiply-add is two operations. Bytes count each input (weights,
activations entering a call) read once and each output written once, in the
cell's compute type. A call's least time on the roofline is
max(operations / peak, bytes / bandwidth); a layer's is the sum over its calls.
"""

from __future__ import annotations

from perfbench.counts import stabletts
from perfbench.counts.peaks import DTYPE_BYTES, least_seconds


def block_call(cfg: dict, lengths, dtype: str) -> tuple:
    """(operations, bytes) of one DiT block (the adaLN modulation from the
    time embedding, q/k/v/out projections, attention with RoPE, the
    GELU-tanh FFN) over rows of valid frames `lengths`."""
    C, F = cfg["dim"], cfg["dim"] * cfg["ff_mult"]
    b = DTYPE_BYTES[dtype]
    flops, act = 0.0, 0.0
    for n in lengths:
        n = float(n)
        flops += n * (8 * C * C + 4 * C * F) + 4 * n * n * C + 2 * C * 6 * C
        act += 2 * n * C * b + 6 * C * b
    weights = (4 * C * C + 2 * C * F + 6 * C * C) * b
    return flops, weights + act


def text_flops(cfg: dict, lengths) -> float:
    """The text embedding's ConvNeXt-V2 blocks over one branch's rows (the
    text is padded with the filler to each item's frames and the blocks run
    over all of them): depthwise k=7, Td -> 2 Td -> Td."""
    Td = cfg["text_dim"]
    per_frame = cfg["conv_layers"] * (2 * 7 * Td + 2 * Td * 2 * Td * 2)
    return float(sum(lengths)) * per_frame


def input_embed_flops(cfg: dict, lengths) -> float:
    """Linear(2 mels + Td -> C) and the two grouped k-tap convs, a row."""
    C, M, Td = cfg["dim"], cfg["n_mels"], cfg["text_dim"]
    per_frame = 2 * (2 * M + Td) * C + 2 * 2 * C * (C // cfg["conv_pos_groups"]) * cfg["conv_pos_kernel"]
    return float(sum(lengths)) * per_frame


def output_flops(cfg: dict, lengths) -> float:
    """The time MLP and the final adaLN a row, the projection to the mels a frame."""
    C, M, fe = cfg["dim"], cfg["n_mels"], cfg["freq_embed_dim"]
    return len(lengths) * (2 * fe * C + 2 * C * C + 2 * C * 2 * C) + float(sum(lengths)) * 2 * C * M


def estimator_flops(cfg: dict, lengths) -> float:
    """One estimator evaluation over rows of `lengths` frames."""
    return (input_embed_flops(cfg, lengths) + cfg["depth"] * block_call(cfg, lengths, "float32")[0]
            + output_flops(cfg, lengths))


def synthesis_flops(cfg: dict, totals, n_steps: int, cfg_on: bool) -> float:
    """All operations of one batch's synthesis at its items' total frames:
    the text embedding of both branches once, and every step's estimator
    over both CFG branches (no vocoder)."""
    rows = list(totals) * (2 if cfg_on else 1)
    return 2 * text_flops(cfg, totals) + n_steps * estimator_flops(cfg, rows)


def blocks_least_s(cfg: dict, totals, n_steps: int, cfg_on: bool, dtype: str) -> float:
    """Least seconds of every DiT block call of one batch's synthesis."""
    rows = list(totals) * (2 if cfg_on else 1)
    return n_steps * cfg["depth"] * least_seconds(*block_call(cfg, rows, dtype), dtype)


def vocoder_call(cfg: dict, lengths, dtype: str) -> tuple:
    """(operations, bytes) of one Vocos forward over the generated frames."""
    return stabletts.vocoder_call(cfg, lengths, dtype)
