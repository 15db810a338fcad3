"""The ISTFT head's two-kernel route (stabletts_torch/ops/istft_cuda.py,
csrc/istft.cu) on the CPU, against the JAX package: the head from its Dense
output against the JAX `ISTFTHead`; the packed spectrum operand and its
packed iDFT matrix through the plain product against `istft_same_fused` in
interpret mode and `istft_same_real` (with and without a frame mask, f32 and
bf16 matmul inputs); the logits entry on the CPU bit for bit the chain it
replaced; and the CUDA product's tiling (BM rows of the operand a tile, the
BM - r + 1 rows it owns, the tiles it skips) mirrored in PyTorch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stabletts_torch.models.vocos import ISTFTHead
from stabletts_torch.ops import istft_cuda as ic
from stabletts_torch.ops.istft import idft_matrix_windowed, istft_same_real, spectrum_from_logits
from stabletts_tpu.models.vocos import ISTFTHead as JISTFTHead
from stabletts_tpu.ops import istft as jistft
from stabletts_tpu.ops.istft_pallas import istft_same_fused
from torch_port_utils import n, t

torch.set_num_threads(2)
SIZES = [(256, 64), (2048, 512)]  # (n_fft, hop): the tests' mel config and the shipped Vocos head
BAR = {torch.float32: 1e-4, torch.bfloat16: 1e-3}  # stabletts_torch/ops/bars.py "istft"


def _spec(b, t_len, n_fft, seed):
    rng = np.random.default_rng(seed)
    nf = n_fft // 2 + 1
    mag = np.exp(np.clip(rng.standard_normal((b, t_len, nf)), None, np.log(100.0)))
    ph = rng.uniform(-np.pi, np.pi, (b, t_len, nf))
    return (mag * np.cos(ph)).astype(np.float32), (mag * np.sin(ph)).astype(np.float32)


def _logits(b, t_len, n_fft, seed):
    """A Dense output: log-magnitudes around 0 (some past log 100), phases over several turns."""
    rng = np.random.default_rng(seed)
    nf = n_fft // 2 + 1
    logmag = rng.standard_normal((b, t_len, nf)) * 2.0
    phase = rng.standard_normal((b, t_len, nf)) * 6.0
    return np.concatenate([logmag, phase], -1).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _jax_head(dim, n_fft, hop, b, t_len, seed):
    """The JAX head at width `dim`, its params (a Dense whose outputs look like
    a trained head's logits) and an input."""
    rng = np.random.default_rng(seed)
    head = JISTFTHead(dim, n_fft, hop)
    x = rng.standard_normal((b, t_len, dim)).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, head.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"])
    params["out"]["kernel"] = (rng.standard_normal((dim, n_fft + 2)) * 2.0 / np.sqrt(dim)).astype(np.float32)
    params["out"]["bias"] = (rng.standard_normal(n_fft + 2) * 0.1).astype(np.float32)
    return head, params, x


def _port_head(params, dim, n_fft, hop):
    head = ISTFTHead(dim, n_fft, hop).eval()
    with torch.no_grad():
        head.out.weight.copy_(t(params["out"]["kernel"].T))
        head.out.bias.copy_(t(params["out"]["bias"]))
    return head


@pytest.mark.parametrize("n_fft,hop", SIZES)
@pytest.mark.parametrize("lengths", [None, [9, 4]])
def test_head_from_its_dense_matches_the_jax_head(n_fft, hop, lengths):
    """The port's eval head (Dense, then `istft_head_from_logits`: the plain
    chain and `istft_same_real` here) against the JAX `ISTFTHead` (Dense, its
    exp / clip / cos / sin lines, `istft_same_real`) at width 24, with and
    without the frame mask."""
    dim, b, t_len = 24, 2, 9
    head, params, x = _jax_head(dim, n_fft, hop, b, t_len, seed=n_fft + t_len)
    fm = None if lengths is None else (np.arange(t_len)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)
    want = np.asarray(head.apply({"params": params}, jnp.asarray(x), None if fm is None else jnp.asarray(fm)))
    port = _port_head(params, dim, n_fft, hop)
    with torch.no_grad():
        got = n(port(t(x), None if lengths is None else torch.tensor(lengths)))
    assert got.shape == (b, t_len * hop)
    assert _rel(got, want) <= BAR[torch.float32]
    assert ic.istft_head.launches == 0 and ic.istft_spectrum.launches == 0


@pytest.mark.parametrize("n_fft,hop", SIZES)
def test_spectrum_chain_on_the_jax_heads_dense_output(n_fft, hop):
    """The plain spectrum chain on the JAX head's own Dense output (captured
    from `ISTFTHead.apply`), packed and through the plain product, against
    the JAX head's waveform."""
    dim, b, t_len = 16, 2, 7
    head, params, x = _jax_head(dim, n_fft, hop, b, t_len, seed=3)
    want, inter = head.apply({"params": params}, jnp.asarray(x), capture_intermediates=True)
    logits = np.asarray(inter["intermediates"]["out"]["__call__"][0])
    re, im = spectrum_from_logits(t(logits))
    got = ic.product_plain(ic.spectrum_plain(re, im, n_fft), b, t_len, n_fft, hop)
    assert _rel(n(got), np.asarray(want)) <= BAR[torch.float32]


@pytest.mark.parametrize("n_fft,hop", SIZES)
@pytest.mark.parametrize("t_len", [5, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_packed_product_matches_pallas_and_xla(n_fft, hop, t_len, dtype):
    """The packed operand (re[0 ..] | im[1 ..] | zeros, r - 1 zero rows an
    item) and the packed iDFT matrix through the plain product against the
    Pallas kernel in interpret mode and the XLA `istft_same_real`, with the
    matmul inputs in `dtype`."""
    b = 2
    re, im = _spec(b, t_len, n_fft, seed=t_len + n_fft)
    md = None if dtype == torch.float32 else dtype
    jmd = None if dtype == torch.float32 else jnp.bfloat16
    got = n(ic.product_plain(ic.spectrum_plain(t(re), t(im), n_fft, md), b, t_len, n_fft, hop))
    fused = istft_same_fused(jnp.asarray(re), jnp.asarray(im), n_fft, hop, n_fft, matmul_dtype=jmd, interpret=True)
    xla = jistft.istft_same_real(jnp.asarray(re), jnp.asarray(im), n_fft, hop, n_fft, matmul_dtype=jmd)
    assert got.shape == (b, t_len * hop)
    assert _rel(got, np.asarray(fused)) <= BAR[dtype]
    assert _rel(got, np.asarray(xla)) <= BAR[dtype]
    assert _rel(got, n(istft_same_real(t(re), t(im), n_fft, hop, n_fft, md))) <= BAR[dtype]


@pytest.mark.parametrize("n_fft,hop", SIZES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_packed_product_frame_mask_matches_xla(n_fft, hop, dtype):
    """The lengths mode: masked frames zero in the operand, each item's
    envelope over its valid frames, against the JAX `istft_same_real` with
    the frame mask (item 2 has no valid frame: zeros)."""
    b, t_len, lengths = 3, 11, [11, 6, 0]
    re, im = _spec(b, t_len, n_fft, seed=21)
    md = None if dtype == torch.float32 else dtype
    jmd = None if dtype == torch.float32 else jnp.bfloat16
    lens = torch.tensor(lengths)
    fm = (np.arange(t_len)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)
    got = n(ic.product_plain(ic.spectrum_plain(t(re), t(im), n_fft, md, lens), b, t_len, n_fft, hop, lens))
    want = np.asarray(jistft.istft_same_real(jnp.asarray(re), jnp.asarray(im), n_fft, hop, n_fft,
                                             matmul_dtype=jmd, frame_mask=jnp.asarray(fm)))
    assert _rel(got, want) <= BAR[dtype]
    assert not got[2].any()
    ours = n(istft_same_real(t(re), t(im), n_fft, hop, n_fft, md, t(fm)))
    assert _rel(got, ours) <= BAR[dtype]


@pytest.mark.parametrize("n_fft", [256, 2048])
def test_packed_layout(n_fft):
    """KP is a multiple of 8 (16-byte rows in bf16) holding the 2 nf - 1
    columns; the dropped im[0] meets an all-zero row of W; the packed W's rows
    are W's own; each item's first r - 1 rows and masked frames are zero."""
    nf, kp = n_fft // 2 + 1, ic.packed_width(n_fft)
    assert kp % 8 == 0 and 2 * nf - 1 <= kp < 2 * nf - 1 + 8
    w = idft_matrix_windowed(n_fft, n_fft)
    assert not w[nf].any()
    wp = ic.packed_weight(n_fft, "cpu", torch.float32)
    assert torch.equal(wp[:nf], w[:nf]) and torch.equal(wp[nf:2 * nf - 1], w[nf + 1:]) and not wp[2 * nf - 1:].any()
    assert torch.equal(ic.packed_weight(n_fft, "cpu", torch.bfloat16), wp.to(torch.bfloat16))
    re, im = (t(a) for a in _spec(2, 5, n_fft, seed=1))
    a = ic.spectrum_plain(re, im, n_fft, None, torch.tensor([5, 2])).reshape(2, 5 + ic.R - 1, kp)
    assert not a[:, :ic.R - 1].any() and not a[1, ic.R - 1 + 2:].any()
    assert torch.equal(a[0, ic.R - 1:, :nf], re[0]) and torch.equal(a[0, ic.R - 1:, nf:2 * nf - 1], im[0, :, 1:])
    assert torch.equal(a[1, ic.R - 1:ic.R + 1, :nf], re[1, :2]) and not a[..., 2 * nf - 1:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("lengths", [None, [13, 5]])
def test_logits_entry_on_the_cpu_is_the_old_chain_bit_for_bit(dtype, lengths):
    """`istft_head_from_logits` and the eval `ISTFTHead` on the CPU give the
    bits of the chain the head ran before (exp, clamp, cos, sin in f32, then
    `istft_head`), for f32 and bf16 Dense outputs; `istft_spectrum` on the
    CPU is the plain chain packed. No kernel is launched."""
    n_fft, hop, b, t_len = 256, 64, 2, 13
    x = t(_logits(b, t_len, n_fft, seed=5)).to(dtype)
    md = None if dtype == torch.float32 else dtype
    lens = None if lengths is None else torch.tensor(lengths)
    mag, p = x.float().chunk(2, dim=-1)
    mag = torch.clamp(torch.exp(mag), max=1e2)
    old = ic.istft_head(mag * torch.cos(p), mag * torch.sin(p), n_fft, hop, md, lens)
    assert torch.equal(ic.istft_head_from_logits(x, n_fft, hop, md, lens), old)
    assert torch.equal(ic.istft_spectrum(x, n_fft, md, lens),
                       ic.spectrum_plain(mag * torch.cos(p), mag * torch.sin(p), n_fft, md, lens))
    assert ic.istft_head.launches == 0 and ic.istft_spectrum.launches == 0


def test_eval_head_is_the_old_chain_bit_for_bit():
    """The eval `ISTFTHead` gives the old head's bits (its Dense, then the chain and `istft_head`)."""
    n_fft, hop, dim = 256, 64, 12
    head = ISTFTHead(dim, n_fft, hop).eval()
    x = t(np.random.default_rng(8).standard_normal((2, 10, dim)).astype(np.float32))
    with torch.no_grad():
        mag, p = head.out(x).float().chunk(2, dim=-1)
        mag = torch.clamp(torch.exp(mag), max=1e2)
        old = ic.istft_head(mag * torch.cos(p), mag * torch.sin(p), n_fft, hop, None, torch.tensor([10, 3]))
        assert torch.equal(head(x, torch.tensor([10, 3])), old)


def _tiled_product(a, b, t_len, n_fft, hop, lengths, bm, bn):
    """The CUDA product's tiling in PyTorch: tile k reads the operand's rows
    [k (bm - r + 1), + bm) against bn / r columns of each tap's W block, owns
    its first bm - r + 1 output rows, sums out[u] = P_0[u + r - 1] + ... +
    P_{r-1}[u] in tap order, and writes zeros where its rows hold no frame."""
    r, kp = ic.R, a.shape[1]
    own, bnt, tr = bm - r + 1, bn // r, t_len + r - 1
    rows = b * tr
    w = ic.packed_weight(n_fft, "cpu", a.dtype).float()
    a = torch.cat([a.float(), torch.zeros(bm, kp)])  # rows past the end read zeros
    lim = [t_len if lengths is None else min(max(int(v), 0), t_len) for v in (lengths or [t_len] * b)]
    flat = torch.zeros(rows, hop)
    for row0 in range(0, rows, own):
        live = any(0 <= rr % tr - (r - 1) < lim[rr // tr] for rr in range(row0, min(row0 + bm, rows)))
        for n0 in range(0, hop, bnt):
            if not live:
                continue
            cols = torch.cat([w[:, j * hop + n0:j * hop + n0 + bnt] for j in range(r)], dim=1)
            p = a[row0:row0 + bm] @ cols
            for u in range(min(own, rows - row0)):
                y = p[u + r - 1, :bnt].clone()
                for j in range(1, r):
                    y = y + p[u + r - 1 - j, j * bnt:(j + 1) * bnt]
                flat[row0 + u, n0:n0 + bnt] = y
    y = flat.reshape(b, tr * hop)
    pad = (n_fft - hop) // 2
    y = y[:, pad:pad + t_len * hop]
    if lengths is None:
        env = ic.window_envelope(ic.hann_window(n_fft), t_len, hop)
        return y / torch.from_numpy(env[pad:pad + t_len * hop])
    fm = ic.frame_mask_of(torch.tensor(lengths), t_len, "cpu")
    env = ic.overlap_add(fm[..., None] * ic._window_squared(n_fft, "cpu")[None, None, :], hop)
    return y / torch.clamp(env[:, pad:pad + t_len * hop], min=1e-11)


@pytest.mark.parametrize("bm,bn", [(128, 256), (128, 128), (64, 64)], ids=["bf16", "f32_128", "f32_64"])
@pytest.mark.parametrize("b,t_len,lengths", [(1, 313, None), (2, 100, [100, 37]), (2, 200, [0, 130])])
def test_cuda_tiling_mirrored(bm, bn, b, t_len, lengths):
    """The kernels' tile arithmetic (owned rows, overlapping reads, skipped
    tiles, tap order) mirrored in PyTorch at the shipped head's n_fft 2048,
    hop 512, against the plain product: a request's 316 rows, a length that
    ends inside a tile, an item with no frame."""
    n_fft, hop = 2048, 512
    re, im = (t(v) for v in _spec(b, t_len, n_fft, seed=t_len))
    lens = None if lengths is None else torch.tensor(lengths)
    a = ic.spectrum_plain(re, im, n_fft, None, lens)
    got = _tiled_product(a, b, t_len, n_fft, hop, lengths, bm, bn)
    want = ic.product_plain(a, b, t_len, n_fft, hop, lens)
    assert _rel(n(got), n(want)) <= 1e-5
    if lengths is not None:
        for i, ln in enumerate(lengths):  # the last valid frame's window ends n_fft - hop - pad past ln * hop
            assert not n(got)[i, ln * hop + (n_fft - hop) // 2:].any()


def test_kernel_entries_refuse_other_devices():
    """The product only launches (a CPU operand is refused, never computed),
    and the entries take cpu or cuda tensors only."""
    n_fft, hop = 256, 64
    a = ic.spectrum_plain(*(t(v) for v in _spec(1, 4, n_fft, seed=0)), n_fft)
    with pytest.raises(ValueError, match="launches the kernel"):
        ic.istft_product(a, 1, 4, n_fft, hop)
    x = torch.zeros(1, 4, n_fft + 2, device="meta")
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        ic.istft_head_from_logits(x, n_fft, hop)
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        ic.istft_spectrum(x, n_fft)
