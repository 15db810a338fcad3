"""stabletts_torch.nn.blocks and the DiT block's plain version
(stabletts_torch/ops/dit_block_cuda.py) against the JAX package: the flax
modules (XLA path on the CPU) and the Pallas kernel fused_dit_block run with
interpret=True. Same numpy inputs and weights into both; fp32 bar 2e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stabletts_torch.nn import blocks as tb
from stabletts_torch.ops.dit_block_cuda import DiTWeights, dit_block, dit_block_plain
from stabletts_torch.utils.convert import _export_dit_block
from stabletts_tpu.nn import blocks as jb
from stabletts_tpu.ops.dit_block_pallas import fused_dit_block
from torch_port_utils import TOL, n, randomise_tree, t

torch.set_num_threads(2)


def _inputs(b, t_len, c, lengths, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t_len, c)).astype(np.float32)
    mask = (np.arange(t_len)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)
    return x * mask[..., None], mask


def _port_block(params, c, f, heads, gin):
    """Port DiTConVBlock holding the flax block's params."""
    sd = {}
    _export_dit_block(sd, "b", params)
    block = tb.DiTConVBlock(c, f, heads, 3, gin)
    block.load_state_dict({k[2:]: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()})
    return block


def test_sinusoidal_pos_emb_matches_jax():
    tt = np.asarray([0.0, 0.1, 0.55, 1.0], np.float32)
    ours = tb.sinusoidal_pos_emb(t(tt), 128)
    np.testing.assert_allclose(n(ours), np.asarray(jb.sinusoidal_pos_emb(jnp.asarray(tt), 128)), **TOL)


def test_timestep_embedding_and_film_match_flax():
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((3, 64)).astype(np.float32)
    te = jb.TimestepEmbedding(32, 96)
    pv = randomise_tree(te.init(jax.random.PRNGKey(0), jnp.asarray(emb))["params"])
    ours = tb.TimestepEmbedding(64, 32, 96)
    with torch.no_grad():
        ours.layer[0].weight.copy_(t(pv["layer_0"]["kernel"].T))
        ours.layer[0].bias.copy_(t(pv["layer_0"]["bias"]))
        ours.layer[2].weight.copy_(t(pv["layer_2"]["kernel"].T))
        ours.layer[2].bias.copy_(t(pv["layer_2"]["bias"]))
    want = te.apply({"params": pv}, jnp.asarray(emb))
    np.testing.assert_allclose(n(ours(t(emb))), np.asarray(want), **TOL)

    x = rng.standard_normal((3, 11, 16)).astype(np.float32)
    film = jb.FiLMLayer(16)
    fv = randomise_tree(film.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(emb))["params"])
    ours_film = tb.FiLMLayer(16, 64)
    with torch.no_grad():
        ours_film.film.weight.copy_(t(fv["film"]["kernel"].T[..., None]))
        ours_film.film.bias.copy_(t(fv["film"]["bias"]))
    want = film.apply({"params": fv}, jnp.asarray(x), jnp.asarray(emb))
    np.testing.assert_allclose(n(ours_film(t(x), t(emb))), np.asarray(want), **TOL)


@pytest.mark.parametrize("t_len,heads,c,gin", [(64, 2, 128, 128), (37, 2, 64, 48), (24, 4, 128, 128)])
def test_dit_block_matches_flax(t_len, heads, c, gin):
    """Port DiTConVBlock (plain version on the CPU) vs the flax block."""
    f = 96
    x, mask = _inputs(2, t_len, c, [t_len, t_len - 11], seed=4)
    cond = np.random.default_rng(5).standard_normal((2, gin)).astype(np.float32)
    blk = jb.DiTConVBlock(c, f, heads, 3, 0.0, gin)
    pv = randomise_tree(blk.init(jax.random.PRNGKey(4), jnp.asarray(x), jnp.asarray(cond), jnp.asarray(mask))["params"])
    want = np.asarray(blk.apply({"params": pv}, jnp.asarray(x), jnp.asarray(cond), jnp.asarray(mask)))
    got = n(_port_block(pv, c, f, heads, gin)(t(x), t(cond), t(mask)))
    valid = mask > 0
    np.testing.assert_allclose(got[valid], want[valid], **TOL)


@pytest.mark.parametrize("t_len,heads", [(64, 2), (48, 4)])
def test_dit_block_plain_matches_pallas_interpret(t_len, heads):
    """The plain version vs fused_dit_block in interpret mode, all rows."""
    b, c, f = 2, 128, 128
    x, mask = _inputs(b, t_len, c, [t_len, t_len - 19], seed=6)
    rng = np.random.default_rng(7)
    mods = (rng.standard_normal((b, 6, c)) * 0.1).astype(np.float32)
    g = lambda *s: (rng.standard_normal(s) / np.sqrt(s[-2] if len(s) > 1 else 1)).astype(np.float32)
    w = [g(c, c), g(c) * 0.05, g(c, c), g(c) * 0.05, g(c, c), g(c) * 0.05, g(c, c), g(c) * 0.05,
         g(3, c, f), g(f) * 0.05, g(3, f, c), g(c) * 0.05]
    want = np.asarray(fused_dit_block(
        jnp.asarray(x), tuple(jnp.asarray(mods[:, i]) for i in range(6)), jnp.asarray(mask),
        *map(jnp.asarray, w), n_heads=heads, interpret=True))
    weights = DiTWeights(t(np.concatenate([w[0], w[2], w[4]], 1)), t(np.concatenate([w[1], w[3], w[5]])),
                         *map(t, w[6:]))
    got = n(dit_block(t(x), t(mods), t(mask), weights, heads))
    np.testing.assert_allclose(got, want, **TOL)
    assert dit_block.launches == 0  # the CPU tensor took the plain version


def test_dit_block_plain_bf16_rounds_like_f32_within_bf16():
    b, t_len, c, f, heads = 1, 20, 128, 64, 2
    x, mask = _inputs(b, t_len, c, [t_len], seed=8)
    rng = np.random.default_rng(9)
    mods = t((rng.standard_normal((b, 6, c)) * 0.1).astype(np.float32))
    w = DiTWeights(*(t((rng.standard_normal(s) * 0.1).astype(np.float32)) for s in
                     [(c, 3 * c), (3 * c,), (c, c), (c,), (3, c, f), (f,), (3, f, c), (c,)]))
    ref = dit_block_plain(t(x), mods, t(mask), w, heads)
    w16 = DiTWeights(*(a.to(torch.bfloat16) for a in w))
    got = dit_block_plain(t(x).to(torch.bfloat16), mods.to(torch.bfloat16), t(mask), w16, heads)
    assert got.dtype == torch.bfloat16
    err = (got.float() - ref).abs().max() / ref.abs().max()
    assert err < 2e-2


def _cache_block(kind):
    from stabletts_torch.models.f5tts import DiTBlock

    torch.manual_seed(0)
    return tb.DiTConVBlock(128, 96, 2, 3, 64) if kind == "stabletts" else DiTBlock(128, 2, 64, 2)


def _out_bias(block):
    return block.attn.conv_o.bias if isinstance(block, tb.DiTConVBlock) else block.attn.to_out[0].bias


@pytest.mark.parametrize("kind", ["stabletts", "f5tts"])
def test_kernel_weights_are_cached_and_rebuilt_when_a_weight_changes(kind):
    """Both blocks' kernel-layout weights (`ops.dit_block_cuda.packed_weights`)
    survive a second call, and are rebuilt, equal to a fresh block's packing
    of the same state, after `load_state_dict`, after `.to(bfloat16)` and
    after an in-place write to one parameter."""
    block = _cache_block(kind)

    def fresh():
        other = _cache_block(kind).to(_out_bias(block).dtype)
        other.load_state_dict(block.state_dict())
        return other.kernel_weights()

    def rebuilt(old):
        new = block.kernel_weights()
        assert new is not old and all(torch.equal(a, b) for a, b in zip(new, fresh()))
        assert all(a.is_contiguous() and a.dtype == _out_bias(block).dtype for a in new)
        return new

    w = block.kernel_weights()
    assert block.kernel_weights() is w
    block.load_state_dict({k: v + 0.5 for k, v in block.state_dict().items()})
    w = rebuilt(w)
    assert block.kernel_weights() is w
    block.to(torch.bfloat16)
    w = rebuilt(w)
    with torch.no_grad():
        _out_bias(block).add_(1.0)
    w = rebuilt(w)
    assert torch.equal(w.bo, _out_bias(block).detach())
