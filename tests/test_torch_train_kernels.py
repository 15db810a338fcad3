"""The plain versions of the port's two training kernels against the JAX
package's TPU kernels, run as the JAX package's own tests run them on the
CPU (under the Pallas interpreter, at dropout 0):

  ops/ffn_train_cuda.py::ffn_train_plain                 vs fused_adaln_ffn_train
  ops/dit_attention_train_cuda.py::dit_attention_train_plain vs fused_dit_attention_train

Same numpy inputs on both sides. Forward rtol = atol = 2e-4 (the fp32 module
bar); every gradient (jax.vjp against torch autograd, same cotangent) within
max-abs-err / max-abs-ref <= 1e-3 (f32 both sides; the difference is
summation order). Then the Philox dropout bits of ops/philox.py: the
Random123 known answers, determinism, the keep rate, and the plain
versions' use of exactly those bits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stabletts_torch.ops import philox
from stabletts_torch.ops.dit_attention_train_cuda import dit_attention_train, dit_attention_train_fwd, \
    dit_attention_train_plain
from stabletts_torch.ops.ffn_train_cuda import ffn_train, ffn_train_fwd, ffn_train_plain
from stabletts_tpu.ops.dit_attention_pallas_train import fused_dit_attention_train
from stabletts_tpu.ops.ffn_pallas_train import fused_adaln_ffn_train

torch.set_num_threads(2)
FWD_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_BAR = 1e-3


def _inputs(kind, b=2, t=64, seed=0):
    """numpy inputs: x [B, T, C] (masked), shift/scale/gate [B, C], mask, weights."""
    rng = np.random.default_rng(seed)
    c, f = (32, 96) if kind == "ffn" else (128, None)
    g = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    mask = (np.arange(t)[None] < np.asarray([t, t - 24])[:, None]).astype(np.float32)
    x = g(b, t, c) * mask[..., None]
    mods = [g(b, c, scale=0.1), g(b, c, scale=0.1), g(b, c, scale=0.5)]
    if kind == "ffn":
        ws = [g(3, c, f, scale=0.1), g(f, scale=0.1), g(3, f, c, scale=0.1), g(c, scale=0.1)]
    else:
        ws = [w for _ in range(4) for w in (g(c, c, scale=c ** -0.5), g(c, scale=0.05))]
    return x, mods, mask, ws


def _jax_fn(kind):
    if kind == "ffn":
        return lambda x, sh, sc, ga, mask, *ws: fused_adaln_ffn_train(x, sh, sc, ga, mask, *ws, interpret=True)
    return lambda x, sh, sc, ga, mask, *ws: fused_dit_attention_train(x, sh, sc, ga, mask, *ws, n_heads=4,
                                                                      interpret=True)


def _port_fn(kind):
    if kind == "ffn":
        return lambda x, mod, mask, *ws: ffn_train_plain(x, mod, mask, *ws)
    return lambda x, mod, mask, *ws: dit_attention_train_plain(x, mod, mask, *ws, n_heads=4)


@pytest.mark.parametrize("kind", ["ffn", "attention"])
def test_forward_matches_jax_kernel(kind):
    x, mods, mask, ws = _inputs(kind)
    want = _jax_fn(kind)(jnp.asarray(x), *map(jnp.asarray, mods), jnp.asarray(mask), *map(jnp.asarray, ws))
    mod = torch.from_numpy(np.stack(mods, axis=1))
    got = _port_fn(kind)(torch.from_numpy(x), mod, torch.from_numpy(mask), *map(torch.from_numpy, ws))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


@pytest.mark.parametrize("kind", ["ffn", "attention"])
def test_every_gradient_matches_jax_kernel(kind):
    x, mods, mask, ws = _inputs(kind, seed=1)
    cot = np.random.default_rng(42).standard_normal(x.shape).astype(np.float32)
    jfn = _jax_fn(kind)
    _, vjp = jax.vjp(lambda x_, sh, sc, ga, *w: jfn(x_, sh, sc, ga, jnp.asarray(mask), *w),
                     jnp.asarray(x), *map(jnp.asarray, mods), *map(jnp.asarray, ws))
    g_jax = vjp(jnp.asarray(cot))
    want = [np.asarray(g_jax[0]), np.stack([np.asarray(a) for a in g_jax[1:4]], axis=1),
            *[np.asarray(a) for a in g_jax[4:]]]

    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, np.stack(mods, axis=1), *ws)]
    out = _port_fn(kind)(leaves[0], leaves[1], torch.from_numpy(mask), *leaves[2:])
    got = torch.autograd.grad(out, leaves, torch.from_numpy(cot))
    assert len(got) == len(want) == (6 if kind == "ffn" else 10)
    for i, (a, b) in enumerate(zip(got, want)):
        err = np.abs(a.numpy() - b).max() / np.abs(b).max()
        assert err <= GRAD_BAR, (i, err)


@pytest.mark.parametrize("kind", ["ffn", "attention"])
def test_cpu_dispatch_is_the_plain_version(kind):
    x, mods, mask, ws = _inputs(kind)
    mod = torch.from_numpy(np.stack(mods, axis=1))
    args = (torch.from_numpy(x), mod, torch.from_numpy(mask), *map(torch.from_numpy, ws))
    seed = philox.draw_seed(torch.Generator().manual_seed(3), "cpu")
    if kind == "ffn":
        before = ffn_train_fwd.launches
        got, want = ffn_train(*args, 0.1, seed), ffn_train_plain(*args, 0.1, seed)
        assert ffn_train_fwd.launches == before
    else:
        before = dit_attention_train_fwd.launches
        got = dit_attention_train(*args, 4, 0.1, seed)
        want = dit_attention_train_plain(*args, 4, 0.1, seed)
        assert dit_attention_train_fwd.launches == before
    assert torch.equal(got, want)


# ---- Philox dropout bits ----------------------------------------------------

@pytest.mark.parametrize("ctr,key,want", [
    ([0, 0, 0, 0], [0, 0], [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]),
    ([0xFFFFFFFF] * 4, [0xFFFFFFFF] * 2, [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]),
    ([0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344], [0xA4093822, 0x299F31D0],
     [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's philox4x32_10 known-answer vectors."""
    words = philox.philox4x32(*(torch.tensor(c, dtype=torch.int64) for c in ctr), key)
    assert words.tolist() == want


def test_dropout_bits_are_deterministic_and_keyed():
    gen = torch.Generator().manual_seed(0)
    s1, s2 = philox.draw_seed(gen, "cpu"), philox.draw_seed(gen, "cpu")
    a = philox.attention_keep(s1, 2, 3, 50, 0.1)
    assert a.shape == (2, 3, 50, 50)
    assert torch.equal(a, philox.attention_keep(s1.clone(), 2, 3, 50, 0.1))
    assert not torch.equal(a, philox.attention_keep(s2, 2, 3, 50, 0.1))
    f = philox.ffn_keep(s1, 2, 50, 70, 0.1)
    assert f.shape == (2, 50, 70) and torch.equal(f, philox.ffn_keep(s1, 2, 50, 70, 0.1))
    # a smaller shape is a corner of the larger one: counters are coordinates
    assert torch.equal(philox.attention_keep(s1, 1, 3, 50, 0.1), a[:1])
    assert torch.equal(torch.unique(f), torch.tensor([0.0, 1.0 / 0.9]))


@pytest.mark.parametrize("which", ["attention", "ffn"])
def test_keep_rate_within_three_sigma(which):
    seed = philox.draw_seed(torch.Generator().manual_seed(11), "cpu")
    keep = philox.attention_keep(seed, 2, 4, 128, 0.1) if which == "attention" else \
        philox.ffn_keep(seed, 2, 128, 512, 0.1)
    n = keep.numel()
    share = (keep > 0).float().mean().item()
    assert abs(share - 0.9) <= 3 * (0.9 * 0.1 / n) ** 0.5


@pytest.mark.parametrize("kind", ["ffn", "attention"])
def test_dropout_uses_the_seeded_mask_in_forward_and_backward(kind):
    """At rate 0.1 the plain version equals the rate-0 math with the
    Philox mask applied by hand, in value and in every gradient: the
    backward drops exactly what the forward dropped."""
    x, mods, mask, ws = _inputs(kind, seed=2)
    seed = philox.draw_seed(torch.Generator().manual_seed(9), "cpu")
    b, t = mask.shape
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, np.stack(mods, axis=1), *ws)]
    m = torch.from_numpy(mask)
    cot = torch.from_numpy(np.random.default_rng(5).standard_normal(x.shape).astype(np.float32))
    plain = _port_fn(kind)
    if kind == "ffn":
        keep = philox.ffn_keep(seed, b, t, ws[0].shape[-1], 0.1)
        got = ffn_train_plain(leaves[0], leaves[1], m, *leaves[2:], 0.1, seed)
        orig = torch.nn.functional.silu
        torch.nn.functional.silu = lambda y: orig(y) * keep
        try:
            want = ffn_train_plain(leaves[0], leaves[1], m, *leaves[2:])
        finally:
            torch.nn.functional.silu = orig
    else:
        keep = philox.attention_keep(seed, b, 4, t, 0.1)
        got = dit_attention_train_plain(leaves[0], leaves[1], m, *leaves[2:], 4, 0.1, seed)
        orig = torch.softmax
        torch.softmax = lambda s, dim: orig(s, dim=dim) * keep
        try:
            want = dit_attention_train_plain(leaves[0], leaves[1], m, *leaves[2:], 4)
        finally:
            torch.softmax = orig
    assert not torch.allclose(got, plain(leaves[0], leaves[1], m, *leaves[2:]))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for a, b_ in zip(torch.autograd.grad(got, leaves, cot), torch.autograd.grad(want, leaves, cot)):
        torch.testing.assert_close(a, b_, rtol=0, atol=0)
