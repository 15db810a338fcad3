"""`ops/tap_gemm_cuda.py::tap_gemm_plain`, the plain version of the port's
tap GEMM (csrc/common.cuh), against the JAX package's
`ops/conv.py::conv1d_same_dots` (SAME convs as shifted products) and against
dense products and an overlap-add written in numpy, on seeded inputs, f32;
likewise `wgrad_plain`, the weight-gradient GEMM's plain version, against the
gradient of `conv1d_same_dots` with respect to its kernel (jax.vjp) and a
dense product, and `colsum_plain` against numpy's sums. The bar, rtol = atol
= 2e-4, covers f32 sums taken in another order. On the CPU `tap_gemm`,
`wgrad` and `colsum` are the plain versions; the kernels are held to them on
the card (tests/test_torch_cuda.py::test_tap_gemm_kernel,
test_wgrad_kernel, test_colsum_kernel)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stabletts_torch.ops.tap_gemm_cuda import colsum, colsum_plain, tap_gemm, tap_gemm_plain, wgrad, wgrad_plain
from stabletts_tpu.ops.conv import conv1d_same_dots

TOL = dict(rtol=2e-4, atol=2e-4)


def _jax_conv(x: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """conv1d_same_dots with a zero bias: x [B, T, C], kernel [k, C, N]."""
    bias = np.zeros(kernel.shape[2], np.float32)
    return np.asarray(conv1d_same_dots(jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias)))


@pytest.mark.parametrize("t_len", [7, 33])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_shifted_taps_match_jax_conv(k, t_len):
    rng = np.random.default_rng(k * 100 + t_len)
    b, c, n = 3, 12, 10
    x = rng.standard_normal((b, t_len, c)).astype(np.float32)
    w = rng.standard_normal((k, c, n)).astype(np.float32)
    got = tap_gemm(torch.from_numpy(x).reshape(b * t_len, c), torch.from_numpy(w), t_in=t_len, t_out=t_len,
                   taps=k, shift0=-((k - 1) // 2), shift_step=1)
    np.testing.assert_allclose(got.numpy().reshape(b, t_len, n), _jax_conv(x, w), **TOL)


@pytest.mark.parametrize("t_len", [10, 31, 32])
@pytest.mark.parametrize("stride", [1, 3])
def test_row_stride_is_a_strided_conv(stride, t_len):
    """row_stride: output row i reads rows stride * i - 2 .. + 2, the MPD
    stack's (5, 1) convs with padding 2, against lax.conv_general_dilated."""
    rng = np.random.default_rng(stride * 100 + t_len)
    b, c, n, k = 3, 8, 6, 5
    x = rng.standard_normal((b, t_len, c)).astype(np.float32)
    w = rng.standard_normal((k, c, n)).astype(np.float32)
    t_out = (t_len - 1) // stride + 1
    got = tap_gemm(torch.from_numpy(x).reshape(b * t_len, c), torch.from_numpy(w), t_in=t_len, t_out=t_out, taps=k,
                   shift0=-2, shift_step=1, row_stride=stride)
    want = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (stride,), [(2, 2)],
                                        dimension_numbers=("NWC", "WIO", "NWC"),
                                        precision=jax.lax.Precision.HIGHEST)
    assert want.shape == (b, t_out, n)
    np.testing.assert_allclose(got.numpy().reshape(b, t_out, n), np.asarray(want), **TOL)


@pytest.mark.parametrize("k", [1, 3])
def test_w_trans_is_the_input_gradient_conv(k):
    """w_trans with shift0 = (k-1)/2 and shift_step = -1 (the input gradient
    of a conv whose w is [k, n_out, k_in]) is the SAME conv with the taps
    flipped and each tap transposed."""
    rng = np.random.default_rng(7 + k)
    b, t_len, c, n = 2, 19, 16, 6
    dy = rng.standard_normal((b, t_len, c)).astype(np.float32)
    w = rng.standard_normal((k, n, c)).astype(np.float32)  # read as W_tap = w[tap]^T, [c, n]
    got = tap_gemm_plain(torch.from_numpy(dy).reshape(b * t_len, c), torch.from_numpy(w), t_in=t_len,
                         t_out=t_len, taps=k, shift0=(k - 1) // 2, shift_step=-1, w_trans=True)
    want = _jax_conv(dy, np.ascontiguousarray(np.flip(w, 0).transpose(0, 2, 1)))
    np.testing.assert_allclose(got.numpy().reshape(b, t_len, n), want, **TOL)


def test_row_len_zeroes_rows_past_each_items_length():
    rng = np.random.default_rng(3)
    b, t_len, c, n = 3, 21, 8, 5
    lens = np.array([21, 9, 1])
    x = rng.standard_normal((b, t_len, c)).astype(np.float32)
    w = rng.standard_normal((3, c, n)).astype(np.float32)
    got = tap_gemm_plain(torch.from_numpy(x).reshape(b * t_len, c), torch.from_numpy(w), t_in=t_len, t_out=t_len,
                         taps=3, shift0=-1, shift_step=1, row_len=torch.from_numpy(lens))
    masked = x * (np.arange(t_len)[None, :, None] < lens[:, None, None])
    np.testing.assert_allclose(got.numpy().reshape(b, t_len, n), _jax_conv(masked, w), **TOL)


@pytest.mark.parametrize("w_trans", [False, True])
def test_one_tap_is_a_dense_product(w_trans):
    rng = np.random.default_rng(11)
    a = rng.standard_normal((24, 40)).astype(np.float32)
    w = rng.standard_normal((1, 30, 40) if w_trans else (1, 40, 30)).astype(np.float32)
    got = tap_gemm_plain(torch.from_numpy(a), torch.from_numpy(w), t_in=8, t_out=8, w_trans=w_trans)
    dense = a.astype(np.float64) @ (w[0].T if w_trans else w[0]).astype(np.float64)
    np.testing.assert_allclose(got.numpy(), dense, **TOL)


def test_k_split_reads_two_row_blocks_as_one():
    """k < k_split from a0, the rest from a1 at column k - k_split: the
    product of the two side by side, with k_split odd (as the ISTFT's 1025)."""
    rng = np.random.default_rng(5)
    lda, n = 9, 7
    a0 = rng.standard_normal((10, lda)).astype(np.float32)
    a1 = rng.standard_normal((10, lda)).astype(np.float32)
    w = rng.standard_normal((1, 2 * lda, n)).astype(np.float32)
    got = tap_gemm_plain(torch.from_numpy(a0), torch.from_numpy(w), t_in=5, t_out=5, a1=torch.from_numpy(a1),
                         k_split=lda, k_in=2 * lda)
    dense = np.concatenate([a0, a1], axis=1).astype(np.float64) @ w[0].astype(np.float64)
    np.testing.assert_allclose(got.numpy(), dense, **TOL)


@pytest.mark.parametrize("use_lengths", [False, True])
def test_istft_form_is_an_overlap_add(use_lengths):
    """The ISTFT head's product (csrc/istft.cu): spectrum rows [re | im]
    (k_split = n_fft/2 + 1), r = n_fft / hop taps reading row i - j against
    weight columns j*hop .. (j+1)*hop of one [2 nf, n_fft] matrix, t_out =
    T + r - 1: the overlap-add of the frames spec @ W, written in numpy."""
    rng = np.random.default_rng(13)
    b, t_len, n_fft, hop = 2, 6, 16, 4
    nf, r = n_fft // 2 + 1, n_fft // hop
    re = rng.standard_normal((b, t_len, nf)).astype(np.float32)
    im = rng.standard_normal((b, t_len, nf)).astype(np.float32)
    w = rng.standard_normal((2 * nf, n_fft)).astype(np.float32)
    lens = np.array([6, 4])
    got = tap_gemm_plain(torch.from_numpy(re).reshape(b * t_len, nf), torch.from_numpy(w), t_in=t_len,
                         t_out=t_len + r - 1, taps=r, shift0=0, shift_step=-1, a1=torch.from_numpy(im).reshape(
                             b * t_len, nf), k_split=nf, k_in=2 * nf, n_out=hop, ldw=n_fft, w_tap_stride=hop,
                         row_len=torch.from_numpy(lens) if use_lengths else None)
    spec = np.concatenate([re, im], axis=-1).astype(np.float64)
    if use_lengths:
        spec = spec * (np.arange(t_len)[None, :, None] < lens[:, None, None])
    frames = spec @ w.astype(np.float64)  # [b, T, n_fft]
    want = np.zeros((b, (t_len + r - 1) * hop))
    for f in range(t_len):
        want[:, f * hop: f * hop + n_fft] += frames[:, f]
    np.testing.assert_allclose(got.numpy().reshape(b, -1), want, **TOL)


def test_kernel_wrapper_takes_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(17)
    a = torch.from_numpy(rng.standard_normal((12, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 8, 4)).astype(np.float32))
    before = tap_gemm.launches
    got = tap_gemm(a, w, t_in=6, t_out=6, taps=3, shift0=-1, shift_step=1)
    assert tap_gemm.launches == before
    torch.testing.assert_close(got, tap_gemm_plain(a, w, t_in=6, t_out=6, taps=3, shift0=-1, shift_step=1))
    with pytest.raises(ValueError):
        tap_gemm(a, w, t_in=5, t_out=5, taps=3)


@pytest.mark.parametrize("t_len", [7, 33])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_wgrad_is_the_jax_conv_kernel_gradient(k, t_len):
    """dK[j] = sum_t x[t + j - (k-1)/2]^T dy[t]: wgrad with shift0 = -(k-1)/2,
    shift_step = 1, against jax.vjp of conv1d_same_dots with respect to its
    kernel, over several items (no tap reads across items)."""
    rng = np.random.default_rng(k * 31 + t_len)
    b, c, n = 3, 12, 10
    x = rng.standard_normal((b, t_len, c)).astype(np.float32)
    w = rng.standard_normal((k, c, n)).astype(np.float32)
    dy = rng.standard_normal((b, t_len, n)).astype(np.float32)
    bias = jnp.zeros(n, jnp.float32)
    _, vjp = jax.vjp(lambda kern: conv1d_same_dots(jnp.asarray(x), kern, bias), jnp.asarray(w))
    (want,) = vjp(jnp.asarray(dy))
    got = wgrad_plain(torch.from_numpy(x).reshape(b * t_len, c), torch.from_numpy(dy).reshape(b * t_len, n),
                      t_len=t_len, taps=k, shift0=-((k - 1) // 2), shift_step=1)
    assert got.shape == (k, c, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("ka,n_out", [(None, None), (19, 7)])
def test_wgrad_one_tap_is_a_dense_product(ka, n_out):
    """One unshifted tap is a.T @ g; ka and n_out read the leading columns of
    wider rows (as dWqkv reads a G of row stride 3C)."""
    rng = np.random.default_rng(23)
    a = rng.standard_normal((24, 40)).astype(np.float32)
    g = rng.standard_normal((24, 30)).astype(np.float32)
    got = wgrad_plain(torch.from_numpy(a), torch.from_numpy(g), t_len=8, ka=ka, n_out=n_out)
    dense = a[:, :ka].astype(np.float64).T @ g[:, :n_out].astype(np.float64)
    np.testing.assert_allclose(got[0].numpy(), dense, **TOL)


@pytest.mark.parametrize("groups", [1, 3])
def test_colsum_is_each_groups_column_sum(groups):
    rng = np.random.default_rng(29 + groups)
    x = rng.standard_normal((groups * 17, 9)).astype(np.float32)
    got = colsum_plain(torch.from_numpy(x), groups)
    want = x.astype(np.float64).reshape(groups, 17, 9).sum(1)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_wgrad_and_colsum_wrappers_take_the_plain_versions_on_the_cpu():
    rng = np.random.default_rng(31)
    a = torch.from_numpy(rng.standard_normal((12, 8)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((12, 5)).astype(np.float32))
    before = wgrad.launches, colsum.launches
    kw = dict(t_len=6, taps=3, shift0=-1, shift_step=1)
    torch.testing.assert_close(wgrad(a, g, **kw), wgrad_plain(a, g, **kw))
    torch.testing.assert_close(colsum(g, 2), colsum_plain(g, 2))
    assert (wgrad.launches, colsum.launches) == before
    with pytest.raises(ValueError):
        wgrad(a, g, t_len=5)
    with pytest.raises(ValueError):
        colsum(g, 5)
