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


# The bf16 kernel's path and tile width (csrc/common.cuh tap_gemm_path and
# tap_gemm_bn, stated in ops/tap_gemm_cuda.py; the card test
# test_tap_gemm_route_is_the_rule holds the built library to them). Each
# case: TapGemm fields, M, N and the expected (path, BN).
_DENSE = dict(taps=1, shift0=0)
PATH_CASES = {
    # StableTTS's DiT block at the serving batch, 192 x 1024 rows
    "stabletts_qkv": (dict(lda=256, k_in=256, k_split=256, ldw=768, w_tap_stride=0, **_DENSE), 196608, 768,
                      ("tma", 256)),
    "stabletts_out_proj": (dict(lda=256, k_in=256, k_split=256, ldw=256, w_tap_stride=0, **_DENSE), 196608, 256,
                           ("tma", 256)),
    "stabletts_conv1": (dict(lda=256, k_in=256, k_split=256, ldw=1024, w_tap_stride=256 * 1024, taps=3, shift0=-1),
                        196608, 1024, ("producer_copy", 256)),
    "stabletts_conv2": (dict(lda=1024, k_in=1024, k_split=1024, ldw=256, w_tap_stride=1024 * 256, taps=3,
                             shift0=-1), 196608, 256, ("producer_copy", 256)),
    # F5-TTS's block at its batch, 16 x 2068 rows
    "f5_qkv": (dict(lda=1024, k_in=1024, k_split=1024, ldw=3072, w_tap_stride=0, **_DENSE), 33088, 3072,
               ("tma", 256)),
    "f5_out_proj": (dict(lda=1024, k_in=1024, k_split=1024, ldw=1024, w_tap_stride=0, **_DENSE), 33088, 1024,
                    ("tma", 256)),
    "f5_ffn1": (dict(lda=1024, k_in=1024, k_split=1024, ldw=2048, w_tap_stride=1024 * 2048, **_DENSE), 33088, 2048,
                ("tma", 256)),
    "f5_ffn2": (dict(lda=2048, k_in=2048, k_split=2048, ldw=1024, w_tap_stride=2048 * 1024, **_DENSE), 33088, 1024,
                ("tma", 256)),
    # Vocos's ConvNeXt products at 192 x 1000 rows
    "convnext_w1": (dict(lda=512, k_in=512, k_split=512, ldw=1536, w_tap_stride=512 * 1536, **_DENSE), 192000, 1536,
                    ("tma", 256)),
    # a request's conv1: 64 tiles of 128 x 256 would leave half the SMs idle
    "request_conv1": (dict(lda=256, k_in=256, k_split=256, ldw=1024, w_tap_stride=256 * 1024, taps=3, shift0=-1),
                      2048, 1024, ("producer_copy", 128)),
    # the ISTFT's form: k_split = 1025 reads two blocks of rows, 4 taps
    "istft_k_split_1025": (dict(lda=1025, k_in=2050, k_split=1025, ldw=2048, w_tap_stride=512, taps=4, shift0=0,
                                t_out=1003), 8024, 512, ("fallback", 256)),
    "unaligned_lda_257": (dict(lda=257, k_in=257, k_split=257, ldw=256, w_tap_stride=257 * 256, taps=3, shift0=-1),
                          194, 256, ("fallback", 128)),
    "unaligned_ldw_77": (dict(lda=256, k_in=256, k_split=256, ldw=77, w_tap_stride=256 * 77, **_DENSE), 194, 77,
                         ("fallback", 128)),
    "misaligned_a0": (dict(lda=256, k_in=256, k_split=256, ldw=256, w_tap_stride=0, ptrs=(8, 8, 0), **_DENSE), 194,
                      256, ("fallback", 128)),
    "row_len": (dict(lda=256, k_in=256, k_split=256, ldw=256, w_tap_stride=0, row_len=True, **_DENSE), 194, 256,
                ("producer_copy", 128)),
    "row_stride_3": (dict(lda=256, k_in=256, k_split=256, ldw=256, w_tap_stride=0, row_stride=3, t_out=333, **_DENSE),
                     666, 256, ("producer_copy", 128)),
    "k_split_two_blocks": (dict(lda=256, k_in=512, k_split=256, ldw=256, w_tap_stride=0, **_DENSE), 194, 256,
                           ("producer_copy", 128)),
    "w_trans_input_gradient": (dict(lda=1024, k_in=1024, k_split=1024, ldw=1024, w_tap_stride=256 * 1024, taps=3,
                                    shift0=1), 32000, 256, ("producer_copy", 256)),
}


@pytest.mark.parametrize("case", sorted(PATH_CASES))
def test_tap_gemm_path_and_tile_follow_the_rule(case):
    from stabletts_torch.ops.tap_gemm_cuda import tap_gemm_bn, tap_gemm_path

    fields, m, n, want = PATH_CASES[case]
    kw = {"t_in": 1000, "t_out": 1000, **fields}
    assert (tap_gemm_path(**kw), tap_gemm_bn(m, n)) == want


@pytest.mark.parametrize("m,n,bn", [(33088, 3072, 256), (31104, 3072, 256), (2048, 1024, 128), (1000, 1024, 128),
                                    (8000, 1024, 256), (14997, 200, 256), (196608, 128, 128), (154, 768, 128)])
def test_tap_gemm_tile_width_by_waves(m, n, bn):
    """128 x 256 where N > 128 and its waves of 132 tiles are at most 2/3 of
    the 128 x 128 tiles' (31104 rows: 23 waves against 45)."""
    from stabletts_torch.ops.tap_gemm_cuda import tap_gemm_bn

    assert tap_gemm_bn(m, n) == bn


def test_conv_paths_are_counted_only_while_a_profiler_records():
    """count_conv_paths adds one to tap_gemm.<path> per launch under a
    profiler (the program's tracing) and nothing otherwise."""
    from torch.profiler import ProfilerActivity, profile

    from stabletts_torch.ops.tap_gemm_cuda import conv_path, count_conv_paths
    from stabletts_torch.utils import metrics

    h, w1, w2 = torch.zeros(64, 256), torch.zeros(3, 256, 1024), torch.zeros(3, 1024, 256)
    convs = ((h, w1[0], 256, 1024, 32), (h, w1, 256, 1024, 32, 3), (torch.zeros(64, 1024), w2, 1024, 256, 32, 3))
    assert [conv_path(*c) for c in convs] == ["tma", "producer_copy", "producer_copy"]
    metrics.reset()
    count_conv_paths(*convs)
    assert metrics.snapshot()["counters"] == {}
    with profile(activities=[ProfilerActivity.CPU]):
        metrics.reset()
        count_conv_paths(*convs)
        got = metrics.snapshot()["counters"]
    assert got == {"tap_gemm.tma": 1, "tap_gemm.producer_copy": 2}
