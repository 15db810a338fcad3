"""The DiT block's two halves (stabletts_torch/ops/dit_attention_cuda.py and
adaln_ffn_cuda.py) against the JAX package's Pallas kernels run with
interpret=True, and `DiTConVBlock` and the compositions of its halves that the
JAX package's inference configurations name (each half a kernel's op or the
composed reference, `CONFIGS`) against the JAX composed block on the CPU. Same
numpy inputs and weights into both. Bars: f32 rtol = atol = 2e-4; bf16 2e-2 of
the largest value."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from stabletts_torch.nn import blocks as tb
from stabletts_torch.ops.adaln_ffn_cuda import adaln_ffn
from stabletts_torch.ops.attention_packed_cuda import attention, attention_packed, attention_packed_t
from stabletts_torch.ops.dit_attention_cuda import dit_attention
from stabletts_torch.ops.dit_block_cuda import DiTWeights, dit_block, dit_block_plain
from stabletts_torch.utils.convert import _export_dit_block
from stabletts_tpu.nn import blocks as jb
from stabletts_tpu.ops.dit_attention_pallas import fused_dit_attention
from stabletts_tpu.ops.ffn_pallas import fused_adaln_ffn
from torch_port_utils import TOL, n, randomise_tree, t

torch.set_num_threads(2)

BF16 = torch.bfloat16
# configuration -> (attention half, FFN half); "default" is the block itself. Attention: "kernel" the op
# `dit_attention`, else the composed half around MultiHeadAttention's projections with the core "plain" (its
# own forward), "packed" (`attention`) or "tminor" (`attention_packed_t` on [B, C, T]); FFN: "kernel" the op
# `adaln_ffn`, "composed" the block's composed half (every FFN at a kernel size other than 3)
CONFIGS = {
    "default": None,
    "two_kernels": ("kernel", "kernel"),
    "composed_attention": ("plain", "kernel"),
    "composed_attention_fused_core": ("packed", "kernel"),
    "composed_attention_tminor": ("tminor", "kernel"),
    "all_library": ("plain", "composed"),
    "attention_kernel_composed_ffn": ("kernel", "composed"),
}


def _attend(attn, h, mask, core):
    """MultiHeadAttention's inference output with the attention core `core`."""
    if core == "plain":
        return attn(h, mask)
    b, t, c = h.shape
    q, k, v = attn.qkv(h)
    if core == "packed":
        out = attention(q, k, v, mask).reshape(b, t, c)
    else:
        to_t = lambda z: z.reshape(b, t, c).transpose(1, 2).contiguous()
        out = attention_packed_t(to_t(q), to_t(k), to_t(v), mask, n_heads=attn.n_heads).transpose(1, 2)
    return tb.conv1d_same(out, attn.conv_o)


def _run(block, config, x, cond, mask):
    """The eval-mode block under `config` (see CONFIGS)."""
    if CONFIGS[config] is None:
        return block(x, cond, mask)
    attn_half, ffn_half = CONFIGS[config]
    b, _, ch = x.shape
    m = mask.to(x.dtype)[..., None]
    x = (x * m).contiguous()
    mods = block.adaLN_modulation(cond).view(b, 6, ch).contiguous()
    w = block.kernel_weights()
    if attn_half == "kernel":
        x = dit_attention(x, mods[:, :3].contiguous(), mask, w.wqkv, w.bqkv, w.wo, w.bo, block.num_heads)
    else:
        shift, scale, gate = mods[:, :3, None, :].unbind(1)
        h = tb._modulate(F.layer_norm(x, (ch,), eps=1e-5), shift, scale)
        x = x + gate * _attend(block.attn, h, mask, attn_half) * m
    if ffn_half == "kernel" and block.kernel_size == 3:
        return adaln_ffn(x, mods[:, 3:].contiguous(), mask, w.w1, w.b1, w.w2, w.b2)
    return block._composed_ffn(x, mods, mask)


def _inputs(b, t_len, c, lengths, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t_len, c)).astype(np.float32)
    mask = (np.arange(t_len)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)
    return x * mask[..., None], mask


def _weights(rng, c, f):
    g = lambda *s: (rng.standard_normal(s) / np.sqrt(s[-2] if len(s) > 1 else 400.0)).astype(np.float32)
    return [g(c, c), g(c), g(c, c), g(c), g(c, c), g(c), g(c, c), g(c)], [g(3, c, f), g(f), g(3, f, c), g(c)]


def _close(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    if dtype == "bf16":
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    else:
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("t_len,heads,lengths", [(64, 2, [64, 45]), (48, 4, [48, 29]), (104, 2, [104, 3])])
def test_dit_attention_matches_pallas_interpret(t_len, heads, lengths, dtype):
    """All rows: x + gate * out * mask leaves the padded rows at x."""
    b, c = 2, heads * 64
    x, mask = _inputs(b, t_len, c, lengths, seed=t_len)
    rng = np.random.default_rng(t_len + 1)
    mods = (rng.standard_normal((b, 3, c)) * 0.2).astype(np.float32)
    aw, _ = _weights(rng, c, 64)
    jd, td = (jnp.bfloat16, BF16) if dtype == "bf16" else (jnp.float32, torch.float32)
    j = lambda a: jnp.asarray(a, jd)
    want = fused_dit_attention(j(x), j(mods[:, 0]), j(mods[:, 1]), j(mods[:, 2]), jnp.asarray(mask),
                               *map(j, aw), n_heads=heads, interpret=True)
    p = lambda a: t(a).to(td)
    got = dit_attention(p(x), p(mods), t(mask), p(np.concatenate(aw[0:6:2], 1)), p(np.concatenate(aw[1:6:2])),
                        p(aw[6]), p(aw[7]), heads)
    assert got.dtype == td and dit_attention.launches == 0  # a CPU tensor takes the plain version
    _close(got.float(), np.asarray(want.astype(jnp.float32)), dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("t_len,c,f,lengths", [(64, 128, 96, [64, 45]), (40, 64, 128, [40, 1]), (24, 128, 256, [9, 24])])
def test_adaln_ffn_matches_pallas_interpret(t_len, c, f, lengths, dtype):
    b = 2
    x, mask = _inputs(b, t_len, c, lengths, seed=t_len + 7)
    rng = np.random.default_rng(t_len + 8)
    mods = (rng.standard_normal((b, 3, c)) * 0.2).astype(np.float32)
    _, fw = _weights(rng, c, f)
    jd, td = (jnp.bfloat16, BF16) if dtype == "bf16" else (jnp.float32, torch.float32)
    j = lambda a: jnp.asarray(a, jd)
    want = fused_adaln_ffn(j(x), j(mods[:, 0]), j(mods[:, 1]), j(mods[:, 2]), jnp.asarray(mask), *map(j, fw),
                           interpret=True)
    p = lambda a: t(a).to(td)
    got = adaln_ffn(p(x), p(mods), t(mask), *map(p, fw))
    assert got.dtype == td and adaln_ffn.launches == 0
    _close(got.float(), np.asarray(want.astype(jnp.float32)), dtype)


def test_two_halves_equal_the_whole_block_in_f32_and_differ_by_one_rounding_in_bf16():
    b, t_len, c, f, heads = 2, 33, 128, 64, 2
    x, mask = _inputs(b, t_len, c, [33, 20], seed=2)
    rng = np.random.default_rng(3)
    mods = t((rng.standard_normal((b, 6, c)) * 0.2).astype(np.float32))
    aw, fw = _weights(rng, c, f)
    w = DiTWeights(t(np.concatenate(aw[0:6:2], 1)), t(np.concatenate(aw[1:6:2])), t(aw[6]), t(aw[7]), *map(t, fw))
    halves = lambda xx, mm, ww: adaln_ffn(
        dit_attention(xx, mm[:, :3].contiguous(), t(mask), *ww[:4], heads), mm[:, 3:].contiguous(), t(mask), *ww[4:])
    torch.testing.assert_close(halves(t(x), mods, w), dit_block_plain(t(x), mods, t(mask), w, heads), rtol=0, atol=0)
    w16 = DiTWeights(*(a.to(BF16) for a in w))
    whole = dit_block_plain(t(x).to(BF16), mods.to(BF16), t(mask), w16, heads).float()
    two = halves(t(x).to(BF16), mods.to(BF16), w16).float()
    assert (two - whole).abs().max() <= 2e-2 * whole.abs().max()


def _flax_block(x, cond, mask, c, f, heads, kernel_size, gin, seed):
    blk = jb.DiTConVBlock(c, f, heads, kernel_size, 0.0, gin)
    pv = randomise_tree(blk.init(jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(cond), jnp.asarray(mask))["params"])
    want = np.asarray(blk.apply({"params": pv}, jnp.asarray(x), jnp.asarray(cond), jnp.asarray(mask),
                                deterministic=True))
    return pv, want


def _port_block(pv, c, f, heads, kernel_size, gin):
    sd = {}
    _export_dit_block(sd, "b", pv)
    block = tb.DiTConVBlock(c, f, heads, kernel_size, gin)
    block.load_state_dict({k[2:]: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()})
    return block.eval()


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("t_len,heads,gin", [(64, 2, 128), (37, 2, 48)])
def test_dit_block_configurations_match_flax_composed(config, t_len, heads, gin):
    """Every composition of the port's block computes the JAX composed
    block (which the JAX package runs on the CPU whatever its variables say)."""
    c, f = heads * 64, 96
    x, mask = _inputs(2, t_len, c, [t_len, t_len - 11], seed=4)
    cond = np.random.default_rng(5).standard_normal((2, gin)).astype(np.float32)
    pv, want = _flax_block(x, cond, mask, c, f, heads, 3, gin, seed=4)
    got = n(_run(_port_block(pv, c, f, heads, 3, gin), config, t(x), t(cond), t(mask)))
    valid = mask > 0
    np.testing.assert_allclose(got[valid], want[valid], **TOL)
    assert np.isfinite(got).all()
    # on the CPU every wrapper took its plain version
    assert [fn.launches for fn in (dit_block, dit_attention, adaln_ffn, attention_packed, attention_packed_t)] == [0] * 5


@pytest.mark.parametrize("config", ["default", "two_kernels", "all_library"])
def test_dit_block_kernel_size_5_takes_the_composed_ffn(config):
    c, f, heads, gin, t_len = 128, 64, 2, 128, 41
    x, mask = _inputs(2, t_len, c, [41, 30], seed=6)
    cond = np.random.default_rng(7).standard_normal((2, gin)).astype(np.float32)
    pv, want = _flax_block(x, cond, mask, c, f, heads, 5, gin, seed=6)
    got = n(_run(_port_block(pv, c, f, heads, 5, gin), config, t(x), t(cond), t(mask)))
    valid = mask > 0
    np.testing.assert_allclose(got[valid], want[valid], **TOL)


@pytest.mark.parametrize("config", ["two_kernels", "composed_attention", "composed_attention_tminor", "all_library"])
def test_dit_block_configurations_bf16_within_bf16_of_f32_and_of_flax(config):
    """bf16: the composed path rotates q and k in f32 and rounds once where
    the JAX package multiplies in bf16, and the kernels' plain versions round
    at the TPU kernels' points, so the bar is 2e-2 of the largest value, both
    against the port's own f32 result and against the JAX composed block in
    bf16 (found: 0.6-1.1e-2 and 0.9-1.3e-2)."""
    c, f, heads, gin, t_len = 128, 96, 2, 128, 40
    x, mask = _inputs(2, t_len, c, [40, 26], seed=8)
    cond = np.random.default_rng(9).standard_normal((2, gin)).astype(np.float32)
    pv, _ = _flax_block(x, cond, mask, c, f, heads, 3, gin, seed=8)
    j16 = lambda a: jnp.asarray(a, jnp.bfloat16)
    want16 = jb.DiTConVBlock(c, f, heads, 3, 0.0, gin).apply(
        {"params": jax.tree_util.tree_map(j16, pv)}, j16(x), j16(cond), jnp.asarray(mask), deterministic=True)
    want16 = t(np.asarray(want16.astype(jnp.float32)))
    block = _port_block(pv, c, f, heads, 3, gin)
    ref = _run(block, config, t(x), t(cond), t(mask))
    got = _run(block.to(BF16), config, t(x).to(BF16), t(cond).to(BF16), t(mask))
    assert got.dtype == BF16
    valid = t(mask) > 0
    assert (got.float() - ref)[valid].abs().max() <= 2e-2 * ref[valid].abs().max()
    assert (got.float() - want16)[valid].abs().max() <= 2e-2 * want16[valid].abs().max()
