"""The port's CUDA kernels against their plain versions on a GPU, at small
shapes (flagship widths, short T, odd T). Marked `cuda`: they need a CUDA
device and nvcc, and skip elsewhere. Run on a GPU machine with

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(--noconftest: tests/conftest.py configures JAX, which such a machine may lack.)
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

BF16 = torch.bfloat16


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, dev, dtype, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev, dtype)


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.mark.parametrize("dtype,bar", [(torch.float32, 5e-3), (BF16, 2e-2)])
@pytest.mark.parametrize("t_len", [64, 77])
def test_dit_block_kernel(dev, dtype, bar, t_len):
    from stabletts_torch.ops.dit_block_cuda import DiTWeights, dit_block, dit_block_plain

    rng = np.random.default_rng(0)
    b, c, f, heads = 2, 256, 1024, 4
    w = DiTWeights(*(_rand(rng, dev, dtype, *s, scale=0.05) for s in
                     [(c, 3 * c), (3 * c,), (c, c), (c,), (3, c, f), (f,), (3, f, c), (c,)]))
    mask = (torch.arange(t_len, device=dev)[None, :] < torch.tensor([[t_len], [t_len - 9]], device=dev)).float()
    x = _rand(rng, dev, dtype, b, t_len, c) * mask[..., None].to(dtype)
    mods = _rand(rng, dev, dtype, b, 6, c, scale=0.1)
    before = dit_block.launches
    got = dit_block(x, mods, mask, w, heads)
    assert dit_block.launches == before + 1
    assert _rel(got, dit_block_plain(x, mods, mask, w, heads)) <= bar


def _masked_inputs(rng, dev, dtype, b, t_len, c):
    lengths = torch.tensor([t_len - (i * 9) % max(1, t_len // 2) for i in range(b)], device=dev)
    mask = (torch.arange(t_len, device=dev)[None, :] < lengths[:, None]).float()
    return _rand(rng, dev, dtype, b, t_len, c) * mask[..., None].to(dtype), mask


@pytest.mark.parametrize("dtype,bar", [(torch.float32, 5e-3), (BF16, 2e-2)])
@pytest.mark.parametrize("t_len", [64, 77])
def test_dit_attention_kernel(dev, dtype, bar, t_len):
    from stabletts_torch.ops.dit_attention_cuda import dit_attention, dit_attention_plain

    rng = np.random.default_rng(5)
    b, c, heads = 2, 256, 4
    w = [_rand(rng, dev, dtype, *s, scale=0.05) for s in [(c, 3 * c), (3 * c,), (c, c), (c,)]]
    x, mask = _masked_inputs(rng, dev, dtype, b, t_len, c)
    mods = _rand(rng, dev, dtype, b, 3, c, scale=0.1)
    before = dit_attention.launches
    got = dit_attention(x, mods, mask, *w, heads)
    assert dit_attention.launches == before + 1
    assert _rel(got, dit_attention_plain(x, mods, mask, *w, heads)) <= bar


@pytest.mark.parametrize("dtype,bar", [(torch.float32, 5e-3), (BF16, 2e-2)])
@pytest.mark.parametrize("t_len", [64, 77])
def test_adaln_ffn_kernel(dev, dtype, bar, t_len):
    from stabletts_torch.ops.adaln_ffn_cuda import adaln_ffn, adaln_ffn_plain

    rng = np.random.default_rng(6)
    b, c, f = 2, 256, 1024
    w = [_rand(rng, dev, dtype, *s, scale=0.05) for s in [(3, c, f), (f,), (3, f, c), (c,)]]
    x, mask = _masked_inputs(rng, dev, dtype, b, t_len, c)
    mods = _rand(rng, dev, dtype, b, 3, c, scale=0.1)
    before = adaln_ffn.launches
    got = adaln_ffn(x, mods, mask, *w)
    assert adaln_ffn.launches == before + 1
    assert _rel(got, adaln_ffn_plain(x, mods, mask, *w)) <= bar


@pytest.mark.parametrize("dtype,bar", [(torch.float32, 5e-3), (BF16, 2e-2)])
@pytest.mark.parametrize("t_len,masked", [(64, True), (77, True), (77, False)])
@pytest.mark.parametrize("tminor", [False, True])
def test_attention_packed_kernels(dev, dtype, bar, t_len, masked, tminor):
    """Both layouts against the plain version on the valid query rows; the
    padded rows must be finite."""
    from stabletts_torch.ops import attention_packed_cuda as ap

    rng = np.random.default_rng(7)
    b, c, heads = 2, 256, 4
    q, k, v = (_rand(rng, dev, dtype, b, t_len, c) for _ in range(3))
    _, mask = _masked_inputs(rng, dev, dtype, b, t_len, c)
    mask = mask if masked else None
    fn, plain = (ap.attention_packed_t, ap.attention_packed_t_plain) if tminor else \
        (ap.attention_packed, ap.attention_packed_plain)
    args = [a.transpose(1, 2).contiguous() for a in (q, k, v)] if tminor else [q, k, v]
    before = fn.launches
    got, ref = fn(*args, mask, n_heads=heads), plain(*args, mask, n_heads=heads)
    assert fn.launches == before + 1 and torch.isfinite(got).all()
    if tminor:
        got, ref = got.transpose(1, 2), ref.transpose(1, 2)
    rows = torch.ones(b, t_len, dtype=torch.bool, device=dev) if mask is None else mask > 0
    assert _rel(got[rows], ref[rows]) <= bar


def _key_mask(kind, b, t_len, dev):
    """A request's mask (every item a third of T long), an item with no valid key beside a full one, or a hole of
    one whole 64-key tile in the middle of item 0 (a third of T short in item 1)."""
    mask = torch.zeros(b, t_len, device=dev)
    third = max(1, t_len // 3)
    if kind == "request":
        mask[:, :third] = 1.0
    elif kind == "all_masked":
        mask[1:] = 1.0
    else:
        mask[0] = 1.0
        mask[0, 64:128] = 0.0
        mask[1:, : t_len - third] = 1.0
    return mask


@pytest.mark.parametrize("dtype,bar", [(torch.float32, 5e-3), (BF16, 2e-2)])
@pytest.mark.parametrize("t_len", [97, 1024])
@pytest.mark.parametrize("kind", ["request", "all_masked", "holed"])
@pytest.mark.parametrize("tminor", [False, True])
def test_attention_packed_key_masks(dev, dtype, bar, t_len, kind, tminor):
    """Both layouts at a request's mask, an item with no valid key (its rows are held to the plain version's
    uniform weights over every key) and a mask with a hole: the valid query rows, and every row of an item with
    no valid key, against the plain version; padded rows finite, and in f32 (whose kernel skips the wholly
    masked key tiles and zeroes wholly padded query tiles) zero in every wholly padded 64-row query tile of an
    item with a valid key."""
    from stabletts_torch.ops import attention_packed_cuda as ap

    rng = np.random.default_rng(11)
    b, c, heads = 2, 256, 4
    q, k, v = (_rand(rng, dev, dtype, b, t_len, c) for _ in range(3))
    mask = _key_mask(kind, b, t_len, dev)
    fn, plain = (ap.attention_packed_t, ap.attention_packed_t_plain) if tminor else \
        (ap.attention_packed, ap.attention_packed_plain)
    args = [a.transpose(1, 2).contiguous() for a in (q, k, v)] if tminor else [q, k, v]
    got, ref = fn(*args, mask, n_heads=heads), plain(*args, mask, n_heads=heads)
    assert torch.isfinite(got).all()
    if tminor:
        got, ref = got.transpose(1, 2), ref.transpose(1, 2)
    none_valid = (mask.amax(1) <= 0)[:, None]
    rows = (mask > 0) | none_valid
    assert _rel(got[rows], ref[rows]) <= bar
    if dtype == torch.float32 and t_len % 64 == 0:
        padded = ((mask.view(b, -1, 64).amax(2) <= 0) & ~none_valid).repeat_interleave(64, dim=1)
        assert (got[padded] == 0).all()


@pytest.mark.parametrize("t_len", [97, 1024])
@pytest.mark.parametrize("kind", ["request", "holed"])
def test_dit_block_key_masks_f32(dev, t_len, kind):
    """The whole f32 DiT block (whose attention core skips masked key tiles and zeroes padded query tiles) at a
    request's mask and a holed one, against its plain version on every row."""
    from stabletts_torch.ops.dit_block_cuda import DiTWeights, dit_block, dit_block_plain

    rng = np.random.default_rng(12)
    b, c, f, heads = 2, 256, 1024, 4
    w = DiTWeights(*(_rand(rng, dev, torch.float32, *s, scale=0.05) for s in
                     [(c, 3 * c), (3 * c,), (c, c), (c,), (3, c, f), (f,), (3, f, c), (c,)]))
    mask = _key_mask(kind, b, t_len, dev)
    x = _rand(rng, dev, torch.float32, b, t_len, c) * mask[..., None]
    mods = _rand(rng, dev, torch.float32, b, 6, c, scale=0.1)
    got = dit_block(x, mods, mask, w, heads)
    assert torch.isfinite(got).all()
    assert _rel(got, dit_block_plain(x, mods, mask, w, heads)) <= 5e-3


def test_kernels_raise_on_what_they_do_not_take(dev):
    from stabletts_torch.ops.attention_packed_cuda import attention_packed

    q = torch.zeros(1, 8, 96, device=dev)  # head width 48
    with pytest.raises(ValueError, match="head_dim 64"):
        attention_packed(q, q, q, None, n_heads=2)
    q = torch.zeros(1, 8, 128, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        attention_packed(q.transpose(1, 2).contiguous().transpose(1, 2), q, q, None, n_heads=2)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("t_len", [32, 45, 1000])
@pytest.mark.parametrize("c", [256, 512, 768])
def test_convnext_kernel(dev, dtype, t_len, c):
    """Each width of the kernel's dispatch (F = 3C, Vocos's 512 -> 1536)."""
    from stabletts_torch.ops.convnext_cuda import ConvNeXtWeights, convnext_block, convnext_block_plain

    rng = np.random.default_rng(1)
    f = 3 * c
    w = ConvNeXtWeights(*(_rand(rng, dev, dtype, *s, scale=0.05) for s in
                          [(7, c), (c,), (c,), (c,), (c, f), (f,), (f, c), (c,), (c,)]))
    x = _rand(rng, dev, dtype, 2, t_len, c)
    assert _rel(convnext_block(x, w), convnext_block_plain(x, w)) <= 2e-2


# The bare tap GEMM (csrc/tap_gemm.cu: bf16 on wgmma, f32 on FMA) against
# tap_gemm_plain at the edges of its contract. Each case: (b, t_in, lda, taps,
# shift0, shift_step, n_out, w_trans, row_len, extra) with extra the ISTFT's
# split-spectrum form (t_out = t_in + 3, a1, k_split = lda, weights read as
# overlapping windows of one [2 * lda, n_fft] matrix). The f32 kernel picks a
# 128 x 128 tile where the grid holds such tiles for at least three quarters of
# the 132 SMs, else 64 x 64:
# F32_TILES names the tile of the cases that reach each branch at a real size
# (a request's conv2, M = 2048 and N = 256; ragged M and N, w_trans and the
# ISTFT's element copies at the large tile).
TAP_CASES = {
    "ragged_m_77": (2, 77, 256, 1, 0, 0, 768, False, None, None),
    "ragged_m_97_conv": (2, 97, 256, 3, -1, 1, 1024, False, None, None),
    "taps_across_items": (3, 97, 1024, 3, -1, 1, 256, False, None, None),
    "row_len": (3, 97, 256, 3, -1, 1, 256, False, [97, 50, 3], None),
    "w_trans": (2, 97, 1024, 3, 1, -1, 256, True, None, None),
    "w_trans_qkv": (2, 77, 768, 1, 0, 0, 256, True, None, None),
    "k_split_1025": (2, 37, 1025, 4, 0, -1, 512, False, None, "istft"),
    "k_split_1025_lengths": (2, 37, 1025, 4, 0, -1, 512, False, [37, 20], "istft"),
    "n_200": (2, 97, 256, 3, -1, 1, 200, False, None, None),
    "n_77_unaligned_ldw": (2, 97, 256, 3, -1, 1, 77, False, None, None),
    "unaligned_lda_257": (2, 97, 257, 3, -1, 1, 256, False, None, None),
    "unaligned_lda_260_trans": (2, 97, 260, 3, 1, -1, 256, True, None, None),
    "request_conv2_2x1024": (2, 1024, 1024, 3, -1, 1, 256, False, None, None),
    "large_ragged_m_n": (3, 4999, 256, 3, -1, 1, 200, False, None, None),
    "large_w_trans": (4, 4000, 256, 3, 1, -1, 1024, True, None, None),
    "large_k_split_1025": (8, 1000, 1025, 4, 0, -1, 512, False, None, "istft"),
}
F32_TILES = {"request_conv2_2x1024": "64x64", "large_ragged_m_n": "128x128", "large_w_trans": "128x128",
             "large_k_split_1025": "128x128"}


def _tap_case(case, dev, dtype):
    """The inputs and keyword arguments of TAP_CASES[case]."""
    b, t_in, lda, taps, shift0, step, n_out, w_trans, row_len, extra = TAP_CASES[case]
    rng = np.random.default_rng(len(case))
    kw = dict(t_in=t_in, t_out=t_in, taps=taps, shift0=shift0, shift_step=step, w_trans=w_trans)
    a0 = _rand(rng, dev, dtype, b * t_in, lda)
    if extra == "istft":
        n_fft = 4 * n_out
        w = _rand(rng, dev, dtype, 2 * lda, n_fft, scale=(2 * lda) ** -0.5)
        kw.update(t_out=t_in + taps - 1, a1=_rand(rng, dev, dtype, b * t_in, lda), k_split=lda, k_in=2 * lda,
                  n_out=n_out, ldw=n_fft, w_tap_stride=n_out)
    else:
        w = _rand(rng, dev, dtype, taps, *((n_out, lda) if w_trans else (lda, n_out)), scale=(taps * lda) ** -0.5)
    if row_len is not None:
        kw["row_len"] = torch.tensor(row_len, device=dev)
    return a0, w, kw, b * kw["t_out"], n_out


@pytest.mark.parametrize("dtype,bar", [(torch.float32, 1e-4), (BF16, 2e-2)])
@pytest.mark.parametrize("case", sorted(TAP_CASES))
def test_tap_gemm_kernel(dev, dtype, bar, case):
    from stabletts_torch.ops.tap_gemm_cuda import tap_gemm, tap_gemm_plain, tap_gemm_tile

    a0, w, kw, m, n_out = _tap_case(case, dev, dtype)
    if dtype == torch.float32 and case in F32_TILES:
        assert tap_gemm_tile(m, n_out, dtype) == F32_TILES[case]
    before = tap_gemm.launches
    got = tap_gemm(a0, w, **kw)
    assert tap_gemm.launches == before + 1
    want = tap_gemm_plain(a0, w, **kw)
    assert got.shape == want.shape == (m, n_out)
    assert torch.isfinite(got.float()).all()
    assert _rel(got, want) <= bar


@pytest.mark.parametrize("case", ["request_conv2_2x1024", "large_w_trans", "large_k_split_1025", "w_trans_qkv",
                                  "unaligned_lda_257"])
def test_tap_gemm_f32_same_bits_twice(dev, case):
    """The f32 tap GEMM sums each output in one fixed order at either tile:
    two launches on the same inputs give equal bits."""
    from stabletts_torch.ops.tap_gemm_cuda import tap_gemm

    a0, w, kw, _, _ = _tap_case(case, dev, torch.float32)
    assert torch.equal(tap_gemm(a0, w, **kw), tap_gemm(a0, w, **kw))


# The bare weight-gradient GEMM (csrc/wgrad.cu: bf16 on wgmma, f32 on FMA)
# against wgrad_plain. Each case: (b, t_len, lda, ka, ldg, n_out, taps,
# shift0). At T = 77 and 97 items end inside a 64-row k step and shifted rows
# cross item boundaries (where they must read zeros); "one_split" has 192
# output tiles and so one row chunk, "many_splits" 15 chunks (bf16) or 32
# (f32); lda = 257 and ldg = 77 take the element copies. The last three are
# at B * T of 4000-32000 rows: dW1 of the training step (5 chunks), ragged ka
# and n over the 128 x 128 tiles, and the element copies over many chunks.
WGRAD_CASES = {
    "dense_77": (2, 77, 256, 256, 768, 768, 1, 0),
    "ldg_3c_n_256": (2, 77, 256, 256, 768, 256, 1, 0),
    "conv1_97": (2, 97, 256, 256, 1024, 1024, 3, -1),
    "conv2_97": (3, 97, 1024, 1024, 256, 256, 3, -1),
    "ka_n_ragged": (2, 77, 200, 200, 136, 136, 3, -1),
    "ka_below_lda": (2, 97, 256, 131, 256, 77, 3, -1),
    "unaligned_lda_257_ldg_77": (2, 97, 257, 257, 77, 77, 3, -1),
    "five_taps": (2, 97, 128, 128, 256, 256, 5, -2),
    "one_split": (2, 97, 1024, 1024, 1024, 1024, 3, -1),
    "many_splits": (4, 1000, 256, 256, 256, 256, 1, 0),
    "conv1_32x1000": (32, 1000, 256, 256, 1024, 1024, 3, -1),
    "ka_n_ragged_long": (8, 1000, 200, 200, 136, 136, 3, -1),
    "unaligned_long": (4, 1000, 257, 257, 77, 77, 1, 0),
}


@pytest.mark.parametrize("dtype,bar", [(torch.float32, 1e-4), (BF16, 1e-3)])
@pytest.mark.parametrize("case", sorted(WGRAD_CASES))
def test_wgrad_kernel(dev, dtype, bar, case):
    """bf16 operands are exact in f32 and so are their products: only the
    order of the f32 sums differs from the plain version (1e-3 covers that
    with room; f32: the tap GEMM's 1e-4). Two runs give equal bits."""
    from stabletts_torch.ops.tap_gemm_cuda import wgrad, wgrad_plain

    b, t_len, lda, ka, ldg, n_out, taps, shift0 = WGRAD_CASES[case]
    rng = np.random.default_rng(len(case) + 100)
    a, g = _rand(rng, dev, dtype, b * t_len, lda), _rand(rng, dev, dtype, b * t_len, ldg)
    kw = dict(t_len=t_len, taps=taps, shift0=shift0, shift_step=1 if taps > 1 else 0, ka=ka, n_out=n_out)
    before = wgrad.launches
    got = wgrad(a, g, **kw)
    assert wgrad.launches == before + 1
    want = wgrad_plain(a, g, **kw)
    assert got.shape == want.shape == (taps, ka, n_out) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= bar
    assert torch.equal(wgrad(a, g, **kw), got)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("n", [96, 1024, 77])
@pytest.mark.parametrize("groups,rows", [(1, 4000), (4, 1000), (3, 7)])
def test_colsum_kernel(dev, dtype, n, groups, rows):
    """Against torch.sum in f32 (1e-4: the same values summed in another
    order); N = 77 takes the scalar loads. Two runs give equal bits."""
    from stabletts_torch.ops.tap_gemm_cuda import colsum

    rng = np.random.default_rng(n + groups)
    x = _rand(rng, dev, dtype, groups * rows, n)
    before = colsum.launches
    got = colsum(x, groups)
    assert colsum.launches == before + 1
    want = x.float().view(groups, rows, n).sum(1)
    assert got.shape == (groups, n) and _rel(got, want) <= 1e-4
    assert torch.equal(colsum(x, groups), got)


def _train_case(kind, dev, dtype, b, t_len, rate):
    """Inputs of a training kernel at flagship widths; returns
    (kernel_fn, plain_fn, args) where args are leaf tensors needing grads."""
    from stabletts_torch.ops import philox
    from stabletts_torch.ops.dit_attention_train_cuda import dit_attention_train, dit_attention_train_plain
    from stabletts_torch.ops.ffn_train_cuda import ffn_train, ffn_train_plain

    rng = np.random.default_rng(3)
    c, f, heads = 256, 1024, 4
    lengths = torch.tensor([t_len - (i * 13) % max(1, t_len // 2) for i in range(b)], device=dev)
    mask = (torch.arange(t_len, device=dev)[None, :] < lengths[:, None]).float()
    x = _rand(rng, dev, dtype, b, t_len, c) * mask[..., None].to(dtype)
    mod = _rand(rng, dev, dtype, b, 3, c, scale=0.3)
    seed = philox.draw_seed(torch.Generator(device=dev).manual_seed(5), dev)
    if kind == "ffn":
        ws = [_rand(rng, dev, dtype, *s, scale=sc) for s, sc in
              [((3, c, f), (3 * c) ** -0.5), ((f,), 0.05), ((3, f, c), (3 * f) ** -0.5), ((c,), 0.05)]]
        kern = lambda *a: ffn_train(a[0], a[1], mask, *a[2:], rate, seed)
        plain = lambda *a: ffn_train_plain(a[0], a[1], mask, *a[2:], rate, seed)
    else:
        ws = [_rand(rng, dev, dtype, *s, scale=sc) for s, sc in [((c, c), c ** -0.5), ((c,), 0.05)] * 4]
        kern = lambda *a: dit_attention_train(a[0], a[1], mask, *a[2:], heads, rate, seed)
        plain = lambda *a: dit_attention_train_plain(a[0], a[1], mask, *a[2:], heads, rate, seed)
    args = [a.requires_grad_() for a in (x, mod, *ws)]
    return kern, plain, args


@pytest.mark.parametrize("kind", ["ffn", "attention"])
@pytest.mark.parametrize("dtype,bar", [(torch.float32, 5e-3), (BF16, 2e-2)])
@pytest.mark.parametrize("b,t_len,rate", [(2, 128, 0.0), (2, 97, 0.0), (2, 97, 0.1)])
def test_train_kernels(dev, kind, dtype, bar, b, t_len, rate):
    """Forward and every gradient of a training kernel pair against autograd
    through its plain version, with the same Philox bits at rate > 0."""
    _check_train_kernels(dev, kind, dtype, bar, b, t_len, rate)


def _check_train_kernels(dev, kind, dtype, bar, b, t_len, rate):
    from stabletts_torch.ops import dit_attention_train_cuda as att
    from stabletts_torch.ops import ffn_train_cuda as ffn

    kern, plain, args = _train_case(kind, dev, dtype, b, t_len, rate)
    fwd, bwd = (ffn.ffn_train_fwd, ffn.ffn_train_bwd) if kind == "ffn" else \
        (att.dit_attention_train_fwd, att.dit_attention_train_bwd)
    cot = torch.from_numpy(np.random.default_rng(9).standard_normal(tuple(args[0].shape)).astype(np.float32))
    cot = cot.to(dev, dtype)
    n_fwd, n_bwd = fwd.launches, bwd.launches
    got = kern(*args)
    g_got = torch.autograd.grad(got, args, cot)
    assert (fwd.launches, bwd.launches) == (n_fwd + 1, n_bwd + 1)
    ref = plain(*args)
    g_ref = torch.autograd.grad(ref, args, cot)
    assert _rel(got, ref) <= bar
    for a, r in zip(g_got, g_ref):
        assert _rel(a, r) <= bar


@pytest.mark.parametrize("lens", [[300, 250, 123, 77, 300, 12, 299, 150], None])
def test_mas_kernel(dev, lens):
    from stabletts_torch.ops.mas import maximum_path
    from stabletts_torch.ops.mas_cuda import mas

    rng = np.random.default_rng(4)
    b, ty, tx = 8, 300, 120
    t_ys = torch.tensor(lens if lens else [ty] * b, device=dev)
    t_xs = torch.tensor([120, 100, 120, 50, 1, 12, 64, 120], device=dev)
    mask = ((torch.arange(ty, device=dev)[None, :] < t_ys[:, None])[:, :, None]
            & (torch.arange(tx, device=dev)[None, :] < t_xs[:, None])[:, None, :]).float()
    neg = torch.from_numpy(rng.standard_normal((b, ty, tx)).astype(np.float32)).to(dev)
    before = mas.launches
    got = mas(neg, mask)
    assert mas.launches == before + 1
    assert torch.equal(got, maximum_path(neg, mask))


# Each form of the MAS kernel (b, Ty, Tx, t_ys, t_xs, where its bits go, its chain warps): four warps with the bits in
# shared memory and in the workspace, five warps of 32 cells a lane, one warp with 4-byte copies (Tx % 4 != 0); the
# shapes of tests/test_torch_mas.py::KERNEL_FORM_CASES, where the plain version is held to the JAX oracle
MAS_FORMS = {
    "warps_shared": (4, 1000, 1024, [1000, 1000, 950, 300], [1024, 900, 1, 1000], "shared", 4),
    "warps_workspace": (2, 2000, 1024, [2000, 2000], [1024, 1], "workspace", 4),
    "wide_workspace": (2, 300, 5000, [300, 300], [4200, 290], "workspace", 5),
    "unaligned_tx": (4, 301, 77, [301, 250, 77, 30], [77, 61, 77, 50], "shared", 1),
}


@pytest.mark.parametrize("case", sorted(MAS_FORMS))
def test_mas_kernel_forms(dev, case):
    from stabletts_torch.ops.mas import maximum_path
    from stabletts_torch.ops.mas_cuda import mas, mas_plan

    b, ty, tx, t_ys, t_xs, bits, warps = MAS_FORMS[case]
    plan = mas_plan(b, ty, tx)
    assert (plan["bits"], plan["warps"]) == (bits, warps)
    t_ys, t_xs = torch.tensor(t_ys, device=dev), torch.tensor(t_xs, device=dev)
    mask = ((torch.arange(ty, device=dev)[None, :] < t_ys[:, None])[:, :, None]
            & (torch.arange(tx, device=dev)[None, :] < t_xs[:, None])[:, None, :]).float()
    neg = torch.from_numpy(np.random.default_rng(len(case)).standard_normal((b, ty, tx)).astype(np.float32)).to(dev)
    before = mas.launches
    got = mas(neg, mask)
    assert mas.launches == before + 1
    assert torch.equal(got, maximum_path(neg, mask))
    assert torch.equal(mas(neg, mask), got)


@pytest.mark.parametrize("dtype,bar", [(torch.float32, 1e-4), (BF16, 1e-3)])
@pytest.mark.parametrize("lengths", [None, [13, 6]])
def test_istft_kernel(dev, dtype, bar, lengths):
    from stabletts_torch.ops.istft_cuda import istft_head

    rng = np.random.default_rng(2)
    re, im = (_rand(rng, dev, torch.float32, 2, 13, 1025) for _ in range(2))
    md = None if dtype == torch.float32 else dtype
    lens = None if lengths is None else torch.tensor(lengths)
    got = istft_head(re, im, 2048, 512, md, None if lens is None else lens.to(dev))
    ref = istft_head(re.cpu(), im.cpu(), 2048, 512, md, lens)
    assert _rel(got.cpu(), ref) <= bar


@pytest.mark.parametrize("dtype,bar", [(torch.float32, 5e-3), (BF16, 2e-2)])
@pytest.mark.parametrize("t_len,rate", [(64, 0.0), (97, 0.1)])
def test_attention_train_kernel(dev, dtype, bar, t_len, rate):
    """Forward and dq, dk, dv against autograd through the plain version, on
    the valid query rows, with the same Philox bits."""
    _check_attention_train(dev, dtype, bar, 2, t_len, rate)


def _check_attention_train(dev, dtype, bar, b, t_len, rate, offset=0.0):
    """With `offset`, keys and values share a mean of that size and q is
    small, as behind a projection with a bias: the true dq and dk then cancel
    over the keys."""
    from stabletts_torch.ops import attention_train_cuda as A
    from stabletts_torch.ops import philox

    rng = np.random.default_rng(11)
    c, heads = 256, 4
    _, mask = _masked_inputs(rng, dev, dtype, b, t_len, c)
    rows = (mask > 0)[..., None].to(dtype)
    q, k, v, cot = (_rand(rng, dev, dtype, b, t_len, c) for _ in range(4))
    if offset:
        q, k, v = q * 0.3, k + offset * _rand(rng, dev, dtype, 1, 1, c), v + offset * _rand(rng, dev, dtype, 1, 1, c)
    cot = cot * rows  # padded query rows are garbage by contract: give them no cotangent
    seed = philox.draw_seed(torch.Generator(device=dev).manual_seed(3), dev)
    outs = {}
    for name, fn in (("kernel", A.attention_train), ("plain", A.attention_train_plain)):
        leaves = [a.detach().clone().requires_grad_() for a in (q, k, v)]
        before = (A.attention_train_fwd.launches, A.attention_train_bwd.launches)
        out = fn(*leaves, mask, rate, seed, heads)
        grads = torch.autograd.grad(out, leaves, cot)
        launched = (A.attention_train_fwd.launches - before[0], A.attention_train_bwd.launches - before[1])
        assert launched == ((1, 1) if name == "kernel" else (0, 0))
        outs[name] = [out * rows, *grads]
    assert torch.isfinite(outs["kernel"][0]).all()
    for got, want in zip(outs["kernel"], outs["plain"]):
        assert _rel(got, want) <= bar


@pytest.mark.parametrize("dtype,bar", [(torch.float32, 5e-3), (BF16, 2e-2)])
@pytest.mark.parametrize("kind", ["attention_train", "dit_attention_train"])
@pytest.mark.parametrize("t_len", [64, 97, 1000])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_train_core(dev, dtype, bar, kind, t_len, rate):
    """The training attention core (attention_train.cuh: the f32 FMA kernels
    and the bf16 wgmma kernels) through both entry points: one full tile, a
    ragged one, many tiles with a ragged last one (the trainer's T = 1000),
    with and without dropout. The DiT attention half's backward writes dV into
    its [M, 3C] gradient (row stride 3C)."""
    if kind == "attention_train":
        _check_attention_train(dev, dtype, bar, 2, t_len, rate)
    else:
        _check_train_kernels(dev, "attention", dtype, bar, 2, t_len, rate)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_attention_train_kernel_kv_offset(dev, dtype):
    """Keys and values with a common mean: dq and dk cancel over the keys, and
    ds rounded to the dtype before its products (as the TPU kernel rounds
    it) shows there; an error in a row's D would show far more. Bar 5e-2."""
    _check_attention_train(dev, dtype, 5e-2, 4, 200, 0.1, offset=2.0)


@pytest.mark.parametrize("dtype,bar", [(torch.float32, 5e-3), (BF16, 2e-2)])
@pytest.mark.parametrize("t_len", [64, 97])
def test_prenet_train_kernel(dev, dtype, bar, t_len):
    """Forward, dmu and the six parameter gradients against autograd through
    the plain version."""
    from stabletts_torch.ops import prenet_train_cuda as P

    rng = np.random.default_rng(13)
    b, cin, f, cout = 2, 128, 1024, 256
    mu = _rand(rng, dev, dtype, b, t_len, cin)
    ws = [_rand(rng, dev, dtype, *s, scale=sc) for s, sc in
          [((3, cin, f), (3 * cin) ** -0.5), ((f,), 0.05), ((3, f, f), (3 * f) ** -0.5), ((f,), 0.05),
           ((3, f, cout), (3 * f) ** -0.5), ((cout,), 0.05)]]
    cot = _rand(rng, dev, dtype, b, t_len, cout)
    outs = {}
    for name, fn in (("kernel", P.prenet_train), ("plain", P.prenet_train_plain)):
        leaves = [a.detach().clone().requires_grad_() for a in (mu, *ws)]
        before = (P.prenet_train_fwd.launches, P.prenet_train_bwd.launches)
        out = fn(*leaves)
        grads = torch.autograd.grad(out, leaves, cot)
        launched = (P.prenet_train_fwd.launches - before[0], P.prenet_train_bwd.launches - before[1])
        assert launched == ((1, 1) if name == "kernel" else (0, 0))
        outs[name] = [out, *grads]
    for got, want in zip(outs["kernel"], outs["plain"]):
        assert got.dtype == want.dtype and _rel(got, want) <= bar


@pytest.mark.parametrize("period", [2, 3, 5, 7, 11])
@pytest.mark.parametrize("t_len", [8190, 4096, 20481])
def test_mpd_stack_kernel(dev, period, t_len):
    """Logits and the five feature maps against the plain version and the
    port's DiscriminatorP, 2e-4 max-abs."""
    from stabletts_torch.models.discriminators import DiscriminatorP
    from stabletts_torch.ops.mpd_cuda import mpd_stack, mpd_stack_plain

    torch.manual_seed(period)
    disc = DiscriminatorP(period).to(dev)
    x = torch.from_numpy(np.random.default_rng(17).standard_normal((2, t_len)).astype(np.float32) * 0.3).to(dev)
    with torch.no_grad():
        folded = disc.fold()
        want_logits, want_fmap = disc(x, folded)
    before = mpd_stack.launches
    logits, fmap = mpd_stack(x, folded, period)
    assert mpd_stack.launches == before + 1
    plain_logits, plain_fmap = mpd_stack_plain(x, folded, period)
    for got, plain, want in zip([logits, *fmap], [plain_logits, *plain_fmap], [want_logits, *want_fmap]):
        assert got.shape == want.shape == plain.shape
        assert (got - plain).abs().max().item() <= 2e-4
        assert (got - want).abs().max().item() <= 2e-4


# The MPD stack's convs 1-4 as strided tap GEMMs (S streams, L_in, C_in, C_out, stride): the [16, 20480] period-2
# batch's first layer cut to 4 streams, the other layers at 2 streams, and a short ragged length
STRIDED_CASES = {"conv1": (4, 10240, 32, 128, 3), "conv2": (2, 3414, 128, 512, 3), "conv3": (2, 1138, 512, 1024, 3),
                 "conv4": (2, 380, 1024, 1024, 1), "ragged": (3, 61, 32, 128, 3)}


@pytest.mark.parametrize("case", sorted(STRIDED_CASES))
def test_tap_gemm_strided_equals_conv1d(dev, case):
    """tap_gemm with row_stride (csrc/tap_gemm.cu, f32) against F.conv1d with
    the same stride and padding 2, rel err 1e-4."""
    import torch.nn.functional as F

    from stabletts_torch.ops.tap_gemm_cuda import tap_gemm

    s, l_in, c_in, c_out, stride = STRIDED_CASES[case]
    rng = np.random.default_rng(len(case) + l_in)
    x = _rand(rng, dev, torch.float32, s, l_in, c_in)
    w = _rand(rng, dev, torch.float32, 5, c_in, c_out, scale=(5 * c_in) ** -0.5)
    l_out = (l_in - 1) // stride + 1
    before = tap_gemm.launches
    got = tap_gemm(x.reshape(s * l_in, c_in), w, t_in=l_in, t_out=l_out, taps=5, shift0=-2, shift_step=1,
                   row_stride=stride)
    assert tap_gemm.launches == before + 1
    want = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), stride=stride, padding=2).transpose(1, 2)
    assert got.shape == (s * l_out, c_out)
    assert _rel(got.view(s, l_out, c_out), want) <= 1e-4


@pytest.mark.parametrize("t_len", [40, 77])
def test_istft_head_gradient(dev, t_len):
    """`istft_head_diff`: the kernel's waveform and the transposed plain ISTFT
    as its backward, against autograd through the plain ISTFT."""
    from stabletts_torch.ops.istft import istft_same_real
    from stabletts_torch.ops.istft_cuda import istft_head, istft_head_diff

    rng = np.random.default_rng(19)
    n_fft, hop = 2048, 512
    re, im = (_rand(rng, dev, torch.float32, 2, t_len, n_fft // 2 + 1) for _ in range(2))
    cot = _rand(rng, dev, torch.float32, 2, t_len * hop)
    outs = {}
    before = istft_head.launches
    for name, fn in (("kernel", lambda r, i: istft_head_diff(r, i, n_fft, hop)),
                     ("plain", lambda r, i: istft_same_real(r, i, n_fft, hop, n_fft))):
        leaves = [re.clone().requires_grad_(), im.clone().requires_grad_()]
        out = fn(*leaves)
        outs[name] = [out.detach(), *torch.autograd.grad(out, leaves, cot)]
    assert istft_head.launches == before + 1
    for got, want in zip(outs["kernel"], outs["plain"]):
        assert _rel(got, want) <= 1e-4


def _variant_case(av, kind, q, k, v, mask):
    """(kernel call, plain call, counter read) of one attention variant."""
    if kind == "kt":
        kt = k.transpose(1, 2).contiguous()
        return (lambda: av.attention_packed_kt(q, kt, v, mask), lambda: av.attention_packed_kt_plain(q, kt, v, mask),
                lambda: av.attention_packed_kt.launches)
    if kind.startswith("rope"):
        rot = int(kind[4:])
        return (lambda: av.attention_packed_rope(q, k, v, mask, rotary_dim=rot),
                lambda: av.attention_packed_rope_plain(q, k, v, mask, rotary_dim=rot),
                lambda: av.attention_packed_rope.launches)
    if kind == "v2":
        return (lambda: av.attention_packed_v2(q, k, v, mask), lambda: av.attention_packed_v2_plain(q, k, v, mask),
                lambda: av.attention_packed_v2.launches)
    return (lambda: av.attention_decompose(q, k, v, kind), lambda: av.attention_decompose_plain(q, k, v, kind),
            lambda: av.attention_decompose.launches[kind])


@pytest.mark.parametrize("dtype,bar", [(torch.float32, 5e-3), (BF16, 2e-2)])
@pytest.mark.parametrize("b,t_len", [(2, 97), (4, 200)])
@pytest.mark.parametrize("kind,masked", [("v2", True), ("v2", False), ("rope32", True), ("rope16", False),
                                         ("kt", True), ("kt", False), ("matmul", False), ("nomax", False),
                                         ("bf16", False)])
def test_attention_variant_kernels(dev, dtype, bar, b, t_len, kind, masked):
    """Each kernel of attention_variants.cu against its plain version on the
    valid query rows (padded rows finite), one launch counted per call; the
    matmul-only mode relative to its own output's largest value."""
    from stabletts_torch.ops import attention_variants_cuda as av

    rng = np.random.default_rng(11)
    q, k, v = (_rand(rng, dev, dtype, b, t_len, 256) for _ in range(3))
    _, mask = _masked_inputs(rng, dev, dtype, b, t_len, 256)
    mask = mask if masked else None
    run, plain, count = _variant_case(av, kind, q, k, v, mask)
    before = count()
    got = run()
    assert count() == before + 1 and torch.isfinite(got).all()
    rows = torch.ones(b, t_len, dtype=torch.bool, device=dev) if mask is None else mask > 0
    assert _rel(got[rows], plain()[rows]) <= bar


def test_attention_variant_adapters_launch_their_kernels(dev):
    from stabletts_torch.ops import attention_packed_cuda as ap
    from stabletts_torch.ops import attention_variants_cuda as av

    rng = np.random.default_rng(12)
    q, k, v = (_rand(rng, dev, torch.float32, 2, 97, 256) for _ in range(3))
    _, mask = _masked_inputs(rng, dev, torch.float32, 2, 97, 256)
    kbias = torch.where(mask > 0, 0.0, -0.7 * torch.finfo(torch.float32).max)[:, None, :]
    rows = mask > 0
    for fn, want, counter in ((lambda: av.attention_head_pair(q, k, v), av.attention_packed_v2_plain(q, k, v),
                               av.attention_packed_v2),
                              (lambda: av.attention_flash_chunks(q, k, v, mask),
                               av.attention_packed_v2_plain(q, k, v, mask), av.attention_packed_v2),
                              (lambda: av.attention_batch_pair(q, k, v, kbias), ap.attention_packed_plain(q, k, v, mask),
                               ap.attention_packed)):
        before = counter.launches
        got = fn()
        assert counter.launches == before + 1
        assert _rel(got[rows], want[rows]) <= 5e-3


def _variant_mask(kind, b, t_len, dev):
    """The ragged mask of `_masked_inputs`, no mask, or one of `_key_mask`'s (a hole of one key tile in item 0 and
    whole padded query tiles in item 1; an item with no valid key)."""
    if kind == "none":
        return None
    if kind == "ragged":
        lengths = torch.tensor([t_len - (i * 9) % max(1, t_len // 2) for i in range(b)], device=dev)
        return (torch.arange(t_len, device=dev)[None, :] < lengths[:, None]).float()
    return _key_mask(kind, b, t_len, dev)


@pytest.mark.parametrize("t_len", [97, 1024])
@pytest.mark.parametrize("kind,mask_kind", [(kind, m) for kind in ("v2", "kt")
                                            for m in ("ragged", "none", "holed", "all_masked")]
                         + [("matmul", "none"), ("nomax", "none"), ("bf16", "none")])
def test_attention_variant_kernels_f32_every_row(dev, t_len, kind, mask_kind):
    """The f32 variants (attention.cuh's f32 core under QPRE, KTMINOR and every MODE, which computes every query
    row) against their plain versions on every row, padded query rows included, at the f32 bar: a ragged mask, no
    mask, a hole of one whole key tile beside whole padded query tiles, and an item with no valid key."""
    from stabletts_torch.ops import attention_variants_cuda as av

    rng = np.random.default_rng(14)
    b = 2
    q, k, v = (_rand(rng, dev, torch.float32, b, t_len, 256) for _ in range(3))
    run, plain, count = _variant_case(av, kind, q, k, v, _variant_mask(mask_kind, b, t_len, dev))
    before = count()
    got = run()
    assert count() == before + 1 and torch.isfinite(got).all()
    assert _rel(got, plain()) <= 5e-3


@pytest.mark.parametrize("dtype,bar", [(torch.float32, 5e-3), (BF16, 2e-2)])
@pytest.mark.parametrize("t_len", [97, 1024])
@pytest.mark.parametrize("rot,mask_kind", [(32, "holed"), (16, "none"), (64, "ragged"), (6, "request")])
def test_attention_packed_rope_is_rotation_then_core(dev, dtype, bar, t_len, rot, mask_kind):
    """#7 on the card is two launches, the rotation and the v2 core on the rotated q and k: the rotation equals its
    plain version bit for bit (each product and the sum rounded to the dtype, never fused), #7's output equals the
    rotation kernel followed by the core bit for bit, and it holds its bar against its plain version on the valid
    rows (every row of an item without a valid key; padded rows finite)."""
    from stabletts_torch.ops import attention_variants_cuda as av

    rng = np.random.default_rng(15)
    b = 2
    q, k, v = (_rand(rng, dev, dtype, b, t_len, 256) for _ in range(3))
    mask = _variant_mask(mask_kind, b, t_len, dev)
    rotations, calls = av.rope_rotate_packed.launches, av.attention_packed_rope.launches
    qr, kr = av.rope_rotate_packed(q, k, 4, rot)
    assert av.rope_rotate_packed.launches == rotations + 1
    want_q, want_k = av.rope_rotate_packed_plain(q, k, 4, rot)
    assert torch.equal(qr, want_q) and torch.equal(kr, want_k)
    got = av.attention_packed_rope(q, k, v, mask, rotary_dim=rot)
    assert av.attention_packed_rope.launches == calls + 1 and av.rope_rotate_packed.launches == rotations + 2
    mask_ptr = 0 if mask is None else mask.data_ptr()
    assert torch.equal(got, av._rope_core(qr, kr, v, mask_ptr, 4)) and torch.isfinite(got).all()
    rows = torch.ones(b, t_len, dtype=torch.bool, device=dev) if mask is None else \
        (mask > 0) | (mask.amax(1) <= 0)[:, None]
    assert _rel(got[rows], av.attention_packed_rope_plain(q, k, v, mask, rotary_dim=rot)[rows]) <= bar


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_rope_rotation_unaligned(dev, dtype):
    """The rotation kernel on q and k that start 4 or 8 bytes past a 16-byte boundary (element copies in place of
    16-byte accesses) against its plain version, bit for bit."""
    from stabletts_torch.ops import attention_variants_cuda as av

    rng = np.random.default_rng(16)
    b, t_len, c = 2, 97, 256
    q, k = (_rand(rng, dev, dtype, b * t_len * c + 8)[2:2 + b * t_len * c].view(b, t_len, c) for _ in range(2))
    assert q.data_ptr() % 16 and k.data_ptr() % 16
    qr, kr = av.rope_rotate_packed(q, k, 4, 32)
    want_q, want_k = av.rope_rotate_packed_plain(q, k, 4, 32)
    assert torch.equal(qr, want_q) and torch.equal(kr, want_k)


@pytest.mark.parametrize("t_len", [64, 1000])
@pytest.mark.parametrize("kind,masked", [("packed", True), ("packed", False), ("packed_t", True), ("packed_t", False),
                                         ("v2", True), ("kt", True), ("rope16", True), ("rope32", False),
                                         ("matmul", False), ("nomax", False), ("bf16", False)])
def test_attention_core_bf16_tiles(dev, t_len, kind, masked):
    """The bf16 attention core (attention.cuh's wgmma kernel) through every
    entry point that reaches it, on one full tile (T=64) and on many tiles
    with a ragged last one (T=1000): both layouts, channel-major K, RoPE at
    rot 16 and 32, every softmax mode, against the plain version at the bf16
    bar on the valid query rows (padded rows finite)."""
    from stabletts_torch.ops import attention_packed_cuda as ap
    from stabletts_torch.ops import attention_variants_cuda as av

    rng = np.random.default_rng(13)
    b = 2
    q, k, v = (_rand(rng, dev, BF16, b, t_len, 256) for _ in range(3))
    _, mask = _masked_inputs(rng, dev, BF16, b, t_len, 256)
    mask = mask if masked else None
    if kind.startswith("packed"):
        fn, plain = (ap.attention_packed_t, ap.attention_packed_t_plain) if kind == "packed_t" else \
            (ap.attention_packed, ap.attention_packed_plain)
        args = [a.transpose(1, 2).contiguous() for a in (q, k, v)] if kind == "packed_t" else [q, k, v]
        run, want, count = (lambda: fn(*args, mask, n_heads=4)), (lambda: plain(*args, mask, n_heads=4)), \
            (lambda: fn.launches)
    else:
        run, want, count = _variant_case(av, kind, q, k, v, mask)
    before = count()
    got, ref = run(), want()
    assert count() == before + 1 and torch.isfinite(got).all()
    if kind == "packed_t":
        got, ref = got.transpose(1, 2), ref.transpose(1, 2)
    rows = torch.ones(b, t_len, dtype=torch.bool, device=dev) if mask is None else mask > 0
    assert _rel(got[rows], ref[rows]) <= 2e-2


def test_serving_bench_gate_passes(dev):
    """The serving bench's gate (stabletts_torch/tools/selftest.py): #1, #2
    and #3 within their bars of their plain versions on the card."""
    from stabletts_torch.tools import selftest

    before = {name: fn.launches for name, fn in _serving_kernels().items()}
    rows = selftest.run(dev)
    assert len(rows) == 8 and all(r["ok"] for r in rows), rows
    # the gate ran the kernels, not their plain versions
    assert {name: fn.launches - before[name] for name, fn in _serving_kernels().items()} == {
        "dit_block": 2, "convnext": 2, "istft": 4}


def _serving_kernels():
    from stabletts_torch.ops.convnext_cuda import convnext_block
    from stabletts_torch.ops.dit_block_cuda import dit_block
    from stabletts_torch.ops.istft_cuda import istft_head

    return {"dit_block": dit_block, "convnext": convnext_block, "istft": istft_head}


@pytest.mark.parametrize("name", ["dit_block", "convnext_block", "istft_head"])
def test_serving_bench_gate_fails_on_a_perturbed_kernel(dev, monkeypatch, capsys, name):
    """A kernel wrapper whose output is 10% off makes the bench exit non-zero
    before it measures, and print no metric line."""
    from stabletts_torch.ops import convnext_cuda, dit_block_cuda, istft_cuda
    from stabletts_torch.tools import bench

    module = {"dit_block": dit_block_cuda, "convnext_block": convnext_cuda, "istft_head": istft_cuda}[name]
    real = getattr(module, name)

    def perturbed(*a, **k):
        return real(*a, **k) * 1.1

    perturbed.launches = 0  # the wrapper counts its launch on the module's attribute
    monkeypatch.setattr(module, name, perturbed)
    with pytest.raises(SystemExit) as e:
        bench.main(["--batch", "2", "--frames", "64", "--steps", "1", "--iters", "1", "--skip-cfg3", "--skip-b1"])
    assert e.value.code == 1
    captured = capsys.readouterr()
    assert "metric" not in captured.out and "kernel selftest failed" in captured.err
