"""The port's packed-head attention (stabletts_torch/ops/attention_packed_cuda.py,
both layouts), its dispatch (ops/attention.py) and AttnMelStyleEncoder against
the JAX package on the CPU: the Pallas kernels run with interpret=True, the
dispatch against the JAX einsum path. Same numpy inputs into both. Bars: f32
rtol = atol = 2e-4; bf16 2e-2 of the largest value."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stabletts_torch.models.reference_encoder import AttnMelStyleEncoder
from stabletts_torch.ops import attention as tattn
from stabletts_torch.ops.attention_packed_cuda import (attention, attention_packed, attention_packed_plain,
                                                       attention_packed_t)
from stabletts_torch.utils.convert import _export_mel_style_encoder
from stabletts_tpu.models.reference_encoder import AttnMelStyleEncoder as JAttnMelStyleEncoder
from stabletts_tpu.ops import attention as jattn
from stabletts_tpu.ops.attention_pallas import fused_attention, fused_attention_packed
from stabletts_tpu.ops.attention_pallas_t import fused_attention_packed_t
from torch_port_utils import TOL, n, randomise_tree, t

torch.set_num_threads(2)

BF16 = torch.bfloat16


def _qkv(b, t_len, heads, seed, lengths=None):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, t_len, heads * 64)).astype(np.float32) for _ in range(3))
    mask = None
    if lengths is not None:
        mask = (np.arange(t_len)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)
    return q, k, v, mask


def _j(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a, dtype)


def _close(got, want, dtype, lengths=None):
    """Items with no valid key are only held to be finite: there the softmax
    is uniform over the keys, and the TPU kernel counts its own zero padding
    to 128 among them."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    if lengths is not None:
        keep = np.asarray(lengths) > 0
        got, want = got[keep], want[keep]
    if dtype == "bf16":
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    else:
        np.testing.assert_allclose(got, want, **TOL)


CASES = [(2, 64, 2, [64, 40]), (2, 77, 4, [77, 13]), (1, 200, 2, None), (2, 37, 2, None), (2, 48, 2, [48, 0])]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,t_len,heads,lengths", CASES)
def test_attention_packed_matches_pallas_interpret(b, t_len, heads, lengths, dtype):
    """All rows, padded query rows included: both mask keys only. The last
    case has an item whose keys are all padded (finite by the -0.7*max bias)."""
    q, k, v, mask = _qkv(b, t_len, heads, seed=t_len, lengths=lengths)
    jd, td = (jnp.bfloat16, BF16) if dtype == "bf16" else (jnp.float32, torch.float32)
    want = fused_attention_packed(_j(q, jd), _j(k, jd), _j(v, jd), _j(mask), n_heads=heads, interpret=True)
    got = attention_packed(t(q).to(td), t(k).to(td), t(v).to(td), None if mask is None else t(mask), n_heads=heads)
    assert got.dtype == td and attention_packed.launches == 0  # a CPU tensor takes the plain version
    _close(got.float(), np.asarray(want.astype(jnp.float32)), dtype, lengths)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,t_len,heads,lengths", CASES)
def test_attention_packed_t_matches_pallas_interpret(b, t_len, heads, lengths, dtype):
    q, k, v, mask = _qkv(b, t_len, heads, seed=100 + t_len, lengths=lengths)
    jd, td = (jnp.bfloat16, BF16) if dtype == "bf16" else (jnp.float32, torch.float32)
    tr = lambda a: np.ascontiguousarray(a.transpose(0, 2, 1))
    want = fused_attention_packed_t(_j(tr(q), jd), _j(tr(k), jd), _j(tr(v), jd), _j(mask), n_heads=heads,
                                    interpret=True)
    got = attention_packed_t(t(tr(q)).to(td), t(tr(k)).to(td), t(tr(v)).to(td), None if mask is None else t(mask),
                             n_heads=heads)
    assert got.shape == (b, heads * 64, t_len) and got.is_contiguous() and attention_packed_t.launches == 0
    _close(got.float(), np.asarray(want.astype(jnp.float32)), dtype, lengths)


@pytest.mark.parametrize("lengths", [None, [50, 21]])
def test_attention_bthd_matches_pallas_interpret(lengths):
    b, t_len, heads = 2, 50, 2
    q, k, v, mask = _qkv(b, t_len, heads, seed=9, lengths=lengths)
    sh = lambda a: a.reshape(b, t_len, heads, 64)
    want = fused_attention(_j(sh(q)), _j(sh(k)), _j(sh(v)), _j(mask), interpret=True)
    got = attention(t(sh(q)), t(sh(k)), t(sh(v)), None if mask is None else t(mask))
    assert got.shape == (b, t_len, heads, 64)
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)


# (batch, T, lengths, hole): masks with wholly padded 64-key tiles (whose skip the f32 kernel relies on),
# one of them a hole in the middle of a full item
KEY_SKIP_CASES = [(2, 256, [79, 256], None), (2, 200, [64, 130], None), (1, 256, [256], (64, 128))]


@pytest.mark.parametrize("tminor", [False, True])
@pytest.mark.parametrize("b,t_len,lengths,hole", KEY_SKIP_CASES)
def test_padded_keys_contribute_nothing(b, t_len, lengths, hole, tminor):
    """A padded key's weight is exactly 0 wherever its row has a valid key, so the f32 kernel may skip a tile
    of padded keys: the plain attention over each item's valid keys alone equals the fully masked plain
    attention on its valid rows (rtol 1e-6), and both match the Pallas kernel in interpret mode on those rows."""
    heads = 2
    q, k, v, mask = _qkv(b, t_len, heads, seed=31 + t_len, lengths=lengths)
    if hole is not None:
        mask[0, hole[0]:hole[1]] = 0.0
    tr = lambda a: np.ascontiguousarray(a.transpose(0, 2, 1))
    if tminor:
        want = fused_attention_packed_t(_j(tr(q)), _j(tr(k)), _j(tr(v)), _j(mask), n_heads=heads, interpret=True)
        want = np.asarray(want).transpose(0, 2, 1)
        full = n(attention_packed_t(t(tr(q)), t(tr(k)), t(tr(v)), t(mask), n_heads=heads)).transpose(0, 2, 1)
    else:
        want = np.asarray(fused_attention_packed(_j(q), _j(k), _j(v), _j(mask), n_heads=heads, interpret=True))
        full = n(attention_packed(t(q), t(k), t(v), t(mask), n_heads=heads))
    for i in range(b):
        keep = np.flatnonzero(mask[i] > 0)
        sub = lambda a: t(np.ascontiguousarray(a[i:i + 1, keep]))
        if tminor:
            alone = n(attention_packed_t(t(tr(q[i:i + 1, keep])), t(tr(k[i:i + 1, keep])), t(tr(v[i:i + 1, keep])),
                                         None, n_heads=heads))[0].T
        else:
            alone = n(attention_packed(sub(q), sub(k), sub(v), None, n_heads=heads))[0]
        np.testing.assert_allclose(full[i, keep], alone, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(full[i, keep], want[i, keep], **TOL)


@pytest.mark.parametrize("tminor", [False, True])
def test_all_masked_item_is_uniform_over_every_key(tminor):
    """An item with no valid key gets uniform weights over every key (the mean of v on every row), which the f32
    kernel keeps by running every key tile for it: pinned against the Pallas kernel in interpret mode at a T that
    is a multiple of 128, where the TPU kernel adds no padding of its own to the keys."""
    b, t_len, heads = 2, 128, 2
    q, k, v, mask = _qkv(b, t_len, heads, seed=41, lengths=[0, 77])
    tr = lambda a: np.ascontiguousarray(a.transpose(0, 2, 1))
    if tminor:
        want = fused_attention_packed_t(_j(tr(q)), _j(tr(k)), _j(tr(v)), _j(mask), n_heads=heads, interpret=True)
        want = np.asarray(want).transpose(0, 2, 1)
        got = n(attention_packed_t(t(tr(q)), t(tr(k)), t(tr(v)), t(mask), n_heads=heads)).transpose(0, 2, 1)
    else:
        want = np.asarray(fused_attention_packed(_j(q), _j(k), _j(v), _j(mask), n_heads=heads, interpret=True))
        got = n(attention_packed(t(q), t(k), t(v), t(mask), n_heads=heads))
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[0], np.broadcast_to(v[0].mean(0), got[0].shape), **TOL)


def test_attention_packed_plain_rounds_weights_to_v_dtype():
    """bf16: the weights are rounded before the PV product and the normaliser
    is the unrounded sum, so the result differs from f32 math on the same
    bf16 inputs, by no more than bf16 resolution."""
    q, k, v, mask = _qkv(1, 40, 2, seed=3, lengths=[33])
    q16, k16, v16 = (t(a).to(BF16) for a in (q, k, v))
    got = attention_packed_plain(q16, k16, v16, t(mask), 2).float()
    ref = attention_packed_plain(q16.float(), k16.float(), v16.float(), t(mask), 2)
    err = (got - ref).abs().max() / ref.abs().max()
    assert 0 < err < 2e-2


# the two paths of `masked_attention` called directly, and the dispatch itself
IMPLS = {
    "plain": lambda q, k, v, mask: tattn.xla_attention(
        q, k, v, None if mask is None else tattn.attn_bias_from_mask(mask)),
    "packed": attention,
    "masked_attention": lambda q, k, v, mask: tattn.masked_attention(q, k, v, mask=mask),
}


@pytest.mark.parametrize("impl", list(IMPLS))
@pytest.mark.parametrize("lengths", [None, [45, 17], [45, 1], [1, 45]])
def test_masked_attention_matches_jax_for_each_impl(impl, lengths):
    """Each path against the JAX einsum path, also where an item has one
    valid key. With a mask only the valid query rows are compared: padded rows
    are garbage on every path."""
    b, t_len, heads = 2, 45, 2
    q, k, v, mask = _qkv(b, t_len, heads, seed=21, lengths=lengths)
    sh = lambda a: a.reshape(b, t_len, heads, 64)
    want = np.asarray(jattn.masked_attention(_j(sh(q)), _j(sh(k)), _j(sh(v)), mask=_j(mask), impl="xla"))
    before = attention_packed.launches
    got = n(IMPLS[impl](t(sh(q)), t(sh(k)), t(sh(v)), None if mask is None else t(mask)))
    assert attention_packed.launches == before  # a CPU tensor takes the plain version
    rows = np.ones((b, t_len), bool) if mask is None else mask > 0
    np.testing.assert_allclose(got[rows], want[rows], **TOL)
    assert np.isfinite(got).all()


def test_masked_attention_full_bias_and_cross_lengths_take_the_plain_path():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
    kv = rng.standard_normal((2, 13, 2, 16)).astype(np.float32)
    bias = rng.standard_normal((2, 1, 9, 13)).astype(np.float32)
    want = np.asarray(jattn.masked_attention(_j(q), _j(kv), _j(kv), bias=_j(bias), impl="xla"))
    got = n(tattn.masked_attention(t(q), t(kv), t(kv), bias=t(bias)))  # head width 16: not the kernel's
    np.testing.assert_allclose(got, want, **TOL)
    want = np.asarray(jattn.masked_attention(_j(q), _j(kv), _j(kv), impl="xla"))
    np.testing.assert_allclose(n(tattn.masked_attention(t(q), t(kv), t(kv))), want, **TOL)
    cuda = torch.device("cuda")
    assert tattn.route(cuda, True, 9, 13) == tattn.route(cuda, False, 9, 13) == "plain"


def test_attn_bias_from_mask_matches_jax():
    from stabletts_tpu.ops.mask import attn_bias_from_mask

    mask = np.asarray([[1, 1, 1, 0], [1, 0, 0, 0]], np.float32)
    np.testing.assert_array_equal(n(tattn.attn_bias_from_mask(t(mask))), np.asarray(attn_bias_from_mask(_j(mask))))


@pytest.mark.parametrize("device,call,path", [("cpu", "mask", "plain"), ("cpu", "none", "plain"),
                                               ("cuda", "mask", "packed"), ("cuda", "none", "packed"),
                                               ("cuda", "bias", "plain"), ("cuda", "cross", "plain")])
def test_masked_attention_routes_by_device_bias_and_lengths(device, call, path):
    """`masked_attention` picks its path from the call alone: the packed-head
    kernel for a CUDA tensor with no full bias and q and k of one length,
    else the plain path. Where the device is here, the call runs: one
    `attention_packed` launch on the packed path, none on the plain one, and
    the output within the bar of the plain path on the valid rows; a CUDA
    case on a machine without one checks `route` alone."""
    b, tq, heads = 2, 40, 2
    tk = 24 if call == "cross" else tq
    rng = np.random.default_rng(13)
    q = rng.standard_normal((b, tq, heads, 64)).astype(np.float32)
    k, v = (rng.standard_normal((b, tk, heads, 64)).astype(np.float32) for _ in range(2))
    mask = (np.arange(tq)[None, :] < np.asarray([tq, 29])[:, None]).astype(np.float32) if call == "mask" else None
    bias = rng.standard_normal((b, 1, tq, tk)).astype(np.float32) if call == "bias" else None
    assert tattn.route(torch.device(device), bias is not None, tq, tk) == path
    if device == "cuda" and not torch.cuda.is_available():
        return
    dev = lambda a: None if a is None else t(a).to(device)
    before = attention_packed.launches
    got = tattn.masked_attention(dev(q), dev(k), dev(v), mask=dev(mask), bias=dev(bias))
    assert attention_packed.launches - before == (path == "packed")
    plain_bias = t(bias) if bias is not None else None if mask is None else tattn.attn_bias_from_mask(t(mask))
    want = n(tattn.xla_attention(t(q), t(k), t(v), plain_bias))
    rows = np.ones((b, tq), bool) if mask is None else mask > 0
    tol = 2e-3 if path == "packed" else 0.0  # the kernel's f32 sums run in another order
    np.testing.assert_allclose(n(got.cpu())[rows], want[rows], rtol=tol, atol=tol)


@pytest.mark.parametrize("lengths", [None, [30, 19]])
def test_attn_mel_style_encoder_matches_flax(lengths):
    rng = np.random.default_rng(8)
    b, t_len, n_mels = 2, 30, 32
    x = rng.standard_normal((b, t_len, n_mels)).astype(np.float32)
    mask = None if lengths is None else (np.arange(t_len)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)
    jenc = JAttnMelStyleEncoder(n_mels, 128, 64, 5, 2, 0.1)
    pv = randomise_tree(jenc.init(jax.random.PRNGKey(2), jnp.asarray(x), _j(mask))["params"])
    want = np.asarray(jenc.apply({"params": pv}, jnp.asarray(x), _j(mask)))
    sd = {}
    _export_mel_style_encoder(sd, "e", pv)
    ours = AttnMelStyleEncoder(n_mels, 128, 64, 5, 2, 0.1)
    ours.load_state_dict({key[2:]: torch.from_numpy(np.asarray(val, np.float32)) for key, val in sd.items()})
    got = n(ours.eval()(t(x), None if mask is None else t(mask)))
    assert got.shape == (b, 64)
    np.testing.assert_allclose(got, want, **TOL)
