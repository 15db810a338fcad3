"""stabletts_torch's Vocos path against the JAX package on the CPU: the
ConvNeXt block's and the ISTFT head's plain versions against the Pallas
kernels in interpret mode and the XLA compositions, and the whole Vocos
(including the fixed-shape `lengths` mode) against Vocos.apply and
vocos_apply_fused."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stabletts_torch.ops.convnext_cuda import ConvNeXtWeights, convnext_block, dwconv_ln_plain
from stabletts_torch.ops.istft import idft_matrix_windowed, istft_same_real
from stabletts_torch.ops.istft_cuda import istft_head
from stabletts_torch.ops.tap_gemm_cuda import tap_gemm_plain
from stabletts_tpu.models.vocos import ConvNeXtBlock as JConvNeXt
from stabletts_tpu.models.vocos import vocos_apply_fused
from stabletts_tpu.ops import istft as jistft
from stabletts_tpu.ops.convnext_pallas import fused_convnext_block
from stabletts_tpu.ops.istft_pallas import istft_same_fused
from torch_port_utils import MEL_CFG, TOL, jax_vocos, n, port_vocos, randomise_tree, t

torch.set_num_threads(2)
N_FFT, HOP = MEL_CFG.n_fft, MEL_CFG.hop_length


def _convnext(t_len, c=64, f=128, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, t_len, c)).astype(np.float32)
    blk = JConvNeXt(c, f, 0.3)
    pv = randomise_tree(blk.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"])
    pv["norm"]["scale"] = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    w = ConvNeXtWeights(t(pv["dwconv"]["kernel"][:, 0, :]), t(pv["dwconv"]["bias"]), t(pv["norm"]["scale"]),
                        t(pv["norm"]["bias"]), t(pv["pwconv1"]["kernel"]), t(pv["pwconv1"]["bias"]),
                        t(pv["pwconv2"]["kernel"]), t(pv["pwconv2"]["bias"]), t(pv["gamma"]))
    return blk, pv, x, w


@pytest.mark.parametrize("t_len", [24, 37])
def test_convnext_plain_matches_flax(t_len):
    blk, pv, x, w = _convnext(t_len)
    want = blk.apply({"params": pv}, jnp.asarray(x))
    np.testing.assert_allclose(n(convnext_block(t(x), w)), np.asarray(want), **TOL)
    assert convnext_block.launches == 0


def test_convnext_plain_matches_pallas_interpret():
    blk, pv, x, w = _convnext(32, seed=1)
    want = fused_convnext_block(jnp.asarray(x), *(jnp.asarray(n(a)) for a in w), interpret=True)
    np.testing.assert_allclose(n(convnext_block(t(x), w)), np.asarray(want), **TOL)


@pytest.mark.parametrize("t_len", [32, 45])
@pytest.mark.parametrize("c", [256, 512, 768])
def test_convnext_f32_route_stages_match_pallas_interpret(c, t_len):
    """The kernel route in f32 as its three plain stages: the depthwise conv + LayerNorm, the tap GEMM with the
    erf GELU (GeluEpi), then the tap GEMM with the residual x + (acc + b2) * gamma (ResidualEpi), at each width
    the kernel takes (F = 3C, Vocos's 512 -> 1536), against the Pallas kernel in interpret mode."""
    _, _, x, w = _convnext(t_len, c=c, f=3 * c, seed=c + t_len)
    b = x.shape[0]
    h = dwconv_ln_plain(t(x), w).reshape(b * t_len, c)
    y = torch.nn.functional.gelu(tap_gemm_plain(h, w.w1[None], t_in=t_len, t_out=t_len) + w.b1, approximate="none")
    z = tap_gemm_plain(y, w.w2[None], t_in=t_len, t_out=t_len) + w.b2
    got = t(x) + (z * w.gamma).reshape(b, t_len, c)
    want = fused_convnext_block(jnp.asarray(x), *(jnp.asarray(n(a)) for a in w), interpret=True)
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_convnext_plain_bf16_uses_tanh_gelu():
    _, _, x, w = _convnext(16, seed=2)
    w16 = ConvNeXtWeights(*(a.to(torch.bfloat16) for a in w))
    got = convnext_block(t(x).to(torch.bfloat16), w16)
    want = fused_convnext_block(jnp.asarray(x, jnp.bfloat16), *(jnp.asarray(n(a), jnp.bfloat16) for a in w),
                                interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=2e-2, atol=2e-2)


def _spec(b, t_len, seed=3):
    rng = np.random.default_rng(seed)
    nf = N_FFT // 2 + 1
    mag = np.exp(np.clip(rng.standard_normal((b, t_len, nf)), None, 2.0))
    ph = rng.uniform(-np.pi, np.pi, (b, t_len, nf))
    return (mag * np.cos(ph)).astype(np.float32), (mag * np.sin(ph)).astype(np.float32)


def test_idft_matrix_matches_jax():
    ours = n(idft_matrix_windowed(N_FFT, N_FFT))
    np.testing.assert_allclose(ours, np.asarray(jistft.idft_matrix_windowed(N_FFT, N_FFT)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("t_len", [7, 16, 21])
def test_istft_plain_matches_xla_and_pallas(t_len):
    re, im = _spec(2, t_len)
    got = n(istft_head(t(re), t(im), N_FFT, HOP))
    xla = np.asarray(jistft.istft_same_real(jnp.asarray(re), jnp.asarray(im), N_FFT, HOP, N_FFT))
    fused = np.asarray(istft_same_fused(jnp.asarray(re), jnp.asarray(im), N_FFT, HOP, N_FFT, interpret=True))
    scale = np.abs(xla).max()
    assert got.shape == (2, t_len * HOP)
    assert np.abs(got - xla).max() / scale < 1e-5
    assert np.abs(got - fused).max() / scale < 1e-4
    assert istft_head.launches == 0


def test_istft_frame_mask_mode_matches_jax():
    re, im = _spec(2, 19, seed=4)
    fm = (np.arange(19)[None, :] < np.asarray([19, 11])[:, None]).astype(np.float32)
    want = np.asarray(jistft.istft_same_real(jnp.asarray(re), jnp.asarray(im), N_FFT, HOP, N_FFT,
                                             frame_mask=jnp.asarray(fm)))
    got = n(istft_same_real(t(re), t(im), N_FFT, HOP, N_FFT, frame_mask=t(fm)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    # the wrapper's lengths mode is the frame_mask mode for prefix masks
    via_lengths = n(istft_head(t(re), t(im), N_FFT, HOP, lengths=torch.tensor([19, 11])))
    np.testing.assert_array_equal(via_lengths, got)


def test_istft_bf16_matmul_inputs_match_jax():
    re, im = _spec(1, 12, seed=5)
    want = np.asarray(jistft.istft_same_real(jnp.asarray(re), jnp.asarray(im), N_FFT, HOP, N_FFT,
                                             matmul_dtype=jnp.bfloat16))
    got = n(istft_head(t(re), t(im), N_FFT, HOP, matmul_dtype=torch.bfloat16))
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-3


@pytest.fixture(scope="module")
def vocos_pair():
    model, params = jax_vocos()
    return model, params, port_vocos(params)


@pytest.mark.parametrize("t_len", [24, 29])
def test_vocos_matches_jax(vocos_pair, t_len):
    jmodel, params, ours = vocos_pair
    mel = np.random.default_rng(t_len).standard_normal((2, t_len, MEL_CFG.n_mels)).astype(np.float32)
    got = n(ours(t(mel)))
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(mel)))
    fused = np.asarray(vocos_apply_fused(jmodel, {"params": params}, jnp.asarray(mel), interpret=True))
    scale = np.abs(ref).max()
    assert got.shape == ref.shape == (2, t_len * HOP)
    assert np.abs(got - ref).max() / scale < 1e-4
    assert np.abs(got - fused).max() / scale < 1e-4


def test_vocos_lengths_mode_matches_jax_and_trimmed(vocos_pair):
    jmodel, params, ours = vocos_pair
    mel = np.random.default_rng(9).standard_normal((2, 27, MEL_CFG.n_mels)).astype(np.float32)
    lengths = np.asarray([27, 15])
    got = n(ours(t(mel), torch.from_numpy(lengths)))
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(mel), jnp.asarray(lengths)))
    fused = np.asarray(vocos_apply_fused(jmodel, {"params": params}, jnp.asarray(mel), interpret=True,
                                         lengths=jnp.asarray(lengths)))
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() / scale < 1e-4
    assert np.abs(got - fused).max() / scale < 1e-4
    trimmed = n(ours(t(mel[1:, :15])))
    assert np.abs(got[1, : 15 * HOP] - trimmed[0]).max() / np.abs(trimmed).max() < 1e-4
