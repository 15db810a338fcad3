"""The operation and byte counts against a hand count of one DiT block and
one ConvNeXt block."""

import pytest

import pb_helpers  # noqa: F401
from perfbench.counts import stabletts as counts
from perfbench.counts.peaks import least_seconds

CFG = {"hidden_channels": 256, "filter_channels": 1024, "gin_channels": 256, "n_mels": 128, "kernel_size": 3,
       "n_enc_layers": 3, "n_dec_layers": 6, "n_fft": 2048, "hop_length": 512,
       "vocoder": {"dim": 512, "intermediate_dim": 1536, "num_layers": 1}}


def test_dit_block_hand_count():
    L, C, F = 100, 256, 1024
    qkv = 2 * L * C * 3 * C
    out = 2 * L * C * C
    scores, pv = 2 * L * L * C, 2 * L * L * C
    ffn = 2 * (2 * L * 3 * C * F)
    adaln = 2 * 256 * 6 * C
    flops, nbytes = counts.dit_block_call(CFG, [L], "bfloat16")
    assert flops == qkv + out + scores + pv + ffn + adaln
    weights = 2 * (3 * C * C + C * C + 3 * C * F + 3 * F * C + 6 * C * 256)
    assert nbytes == weights + 2 * (2 * L * C) + 2 * 6 * C


def test_dit_block_counts_valid_rows_only():
    f1, _ = counts.dit_block_call(CFG, [100, 50], "float32")
    f2, _ = counts.dit_block_call(CFG, [100], "float32")
    f3, _ = counts.dit_block_call(CFG, [50], "float32")
    assert f1 == f2 + f3


def test_convnext_block_hand_count():
    """One ConvNeXt block is the Vocos count with 1 layer less the embedding and the head."""
    L, D, I, M, n_fft = 10, 512, 1536, 128, 2048
    block = 2 * L * 7 * D + 2 * L * D * I + 2 * L * I * D
    embed = 2 * L * M * 7 * D
    head = 2 * L * D * (n_fft + 2) + 2 * L * (n_fft + 2) * n_fft
    flops, nbytes = counts.vocoder_call(CFG, [L], "float32")
    assert flops == block + embed + head
    weights = 4 * (M * 7 * D + 7 * D + 2 * D * I + D * (n_fft + 2) + (n_fft + 2) * n_fft)
    assert nbytes == weights + 4 * L * (M + 512)


def test_least_seconds_is_the_larger_bound():
    assert least_seconds(989e12, 0.0, "bfloat16") == pytest.approx(1.0)
    assert least_seconds(0.0, 3.35e12, "bfloat16") == pytest.approx(1.0)
    assert least_seconds(67e12, 3.35e12 / 2, "float32") == pytest.approx(1.0)
