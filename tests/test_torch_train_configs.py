"""The port's TTS training kernels and paths against the JAX package on the CPU:

  * `attention_train`'s plain version against the Pallas kernel
    fused_attention_train (interpret mode) at dropout 0, values and dq, dk, dv
    on the valid rows, and its dropout contract at rate 0.1;
  * `prenet_train`'s plain version against fused_prenet_train (interpret
    mode), forward and all seven gradients;
  * the DiT block in train mode and the compositions of its training halves
    that the JAX package's training configurations name (each half a
    kernel's op or the composed reference, `BLOCK_CONFIGS`; kernel size 5)
    against the flax block's training forward, values and gradients;
  * a whole TTS step against the JAX package's composed training forward:
    losses and every parameter gradient at 1e-3, dropout off;
  * a bf16 step (`compute_dtype=torch.bfloat16`) against the JAX package's
    bf16 cast of the same forward.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from stabletts_torch.nn import blocks as tb
from stabletts_torch.ops import attention_train_cuda as A
from stabletts_torch.ops import philox
from stabletts_torch.ops import prenet_train_cuda as P
from stabletts_torch.ops.dit_attention_train_cuda import dit_attention_train
from stabletts_torch.ops.ffn_train_cuda import ffn_train
from stabletts_torch.train.train_tts import model_losses
from stabletts_torch.utils.convert import _export_dit_block, state_dict_from_jax_stabletts
from stabletts_tpu.nn import blocks as jb
from test_torch_train import (TINY, TINY_MEL, _jax_apply, _jax_loss_and_grads, _port, _rel,
                              _torch_batch, _torch_draws, setup)  # noqa: F401 (setup is a fixture)
from torch_port_utils import n, randomise_tree, t

torch.set_num_threads(2)

# ---- attention_train ----------------------------------------------------------

def _qkv(b, t_len, c, lengths, seed):
    rng = np.random.default_rng(seed)
    q, k, v, cot = (rng.standard_normal((b, t_len, c)).astype(np.float32) for _ in range(4))
    mask = (np.arange(t_len)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)
    return q, k, v, cot * mask[..., None], mask  # padded query rows are garbage: no cotangent there


@pytest.mark.parametrize("t_len,heads,c,masked", [(50, 2, 64, True), (128, 4, 128, True), (37, 2, 64, False)])
def test_attention_train_plain_matches_pallas_interpret(t_len, heads, c, masked):
    """Values and dq, dk, dv on the valid rows at dropout 0, 2e-4."""
    from stabletts_tpu.ops.attention_pallas_train import fused_attention_train

    q, k, v, cot, mask = _qkv(2, t_len, c, [t_len, t_len - 13], seed=t_len)
    jmask = jnp.asarray(mask) if masked else None
    if not masked:
        mask = np.ones_like(mask)
    f = lambda q_, k_, v_: fused_attention_train(q_, k_, v_, jmask, 0.0, None, n_heads=heads, interpret=True)
    want, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_grads = vjp(jnp.asarray(cot))

    leaves = [t(a).requires_grad_() for a in (q, k, v)]
    got = A.attention_train(*leaves, t(mask) if masked else None, 0.0, None, heads)
    grads = torch.autograd.grad(got, leaves, t(cot))
    valid = mask > 0
    np.testing.assert_allclose(n(got)[valid], np.asarray(want)[valid], rtol=2e-4, atol=2e-4)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(n(g), np.asarray(w), rtol=2e-4, atol=2e-4)
    assert A.attention_train_fwd.launches == 0 and A.attention_train_bwd.launches == 0  # CPU: the plain version


def test_attention_train_dropout_contract():
    """keep ~ Bernoulli(1 - rate) scaled by 1 / (1 - rate): the multiplier's
    mean is 1 within 4 sigma; the backward uses the forward's mask (dv equals
    (p * keep)^T do built from that mask); rate 0 ignores the seed."""
    b, t_len, heads, c, rate = 2, 96, 2, 64, 0.1
    q, k, v, cot, mask = _qkv(b, t_len, c, [t_len, t_len - 20], seed=3)
    seed = philox.draw_seed(torch.Generator().manual_seed(5), "cpu")
    keep = philox.attention_keep(seed, b, heads, t_len, rate)
    np.testing.assert_allclose(np.unique(n(keep)), [0.0, 1 / (1 - rate)], rtol=1e-6)
    sigma = math.sqrt(rate / (1 - rate) / keep.numel())
    assert abs(float(keep.mean()) - 1.0) <= 4 * sigma

    leaves = [t(a).requires_grad_() for a in (q, k, v)]
    out = A.attention_train(*leaves, t(mask), rate, seed, heads)
    dv = torch.autograd.grad(out, leaves[2], t(cot))[0]
    d = c // heads
    hd = lambda a: t(a).view(b, t_len, heads, d)
    s = torch.einsum("bqhd,bkhd->bhqk", hd(q), hd(k)) / math.sqrt(d)
    s = s + torch.where(t(mask) > 0, 0.0, -0.7 * torch.finfo(torch.float32).max)[:, None, None, :]
    pd = torch.softmax(s, dim=-1) * keep
    np.testing.assert_allclose(n(out), n(torch.einsum("bhqk,bkhd->bqhd", pd, hd(v)).reshape(b, t_len, c)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(dv), n(torch.einsum("bhqk,bqhd->bkhd", pd, hd(cot)).reshape(b, t_len, c)),
                               rtol=1e-5, atol=1e-5)
    # another seed gives another mask; rate 0 gives none whatever the seed
    other = philox.draw_seed(torch.Generator().manual_seed(6), "cpu")
    assert not torch.equal(A.attention_train(*leaves, t(mask), rate, other, heads), out)
    assert torch.equal(A.attention_train(*leaves, t(mask), 0.0, seed, heads),
                       A.attention_train(*leaves, t(mask), 0.0, None, heads))


# ---- prenet_train -----------------------------------------------------------------

@pytest.mark.parametrize("t_len,cin,f,cout", [(48, 16, 64, 32), (40, 32, 128, 32)])
def test_prenet_train_plain_matches_pallas_interpret(t_len, cin, f, cout):
    """Forward 2e-5, dmu and the six parameter gradients 3e-4 (the bars of
    tests/test_prenet_pallas_train.py)."""
    from stabletts_tpu.ops.prenet_pallas_train import fused_prenet_train

    rng = np.random.default_rng(t_len)
    g = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    mu = g(2, t_len, cin)
    ws = [g(3, cin, f, scale=(3 * cin) ** -0.5), g(f, scale=0.1), g(3, f, f, scale=(3 * f) ** -0.5),
          g(f, scale=0.1), g(3, f, cout, scale=(3 * f) ** -0.5), g(cout, scale=0.1)]
    cot = g(2, t_len, cout)
    want, vjp = jax.vjp(lambda *a: fused_prenet_train(*a, interpret=True), *map(jnp.asarray, (mu, *ws)))
    want_grads = vjp(jnp.asarray(cot))

    leaves = [t(a).requires_grad_() for a in (mu, *ws)]
    got = P.prenet_train(*leaves)
    grads = torch.autograd.grad(got, leaves, t(cot))
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=2e-5, atol=2e-5)
    for gg, w in zip(grads, want_grads):
        np.testing.assert_allclose(n(gg), np.asarray(w), rtol=3e-4, atol=3e-4)
    assert P.prenet_train_fwd.launches == 0 and P.prenet_train_bwd.launches == 0


# ---- the block's training configurations -----------------------------------------------

# configuration -> (attention half, FFN half) of the train-mode block, dropout off; "default" is the block itself.
# Attention: "kernel" the op `dit_attention_train`, else the composed half around MultiHeadAttention's projections
# with the core "plain" (its own training forward: einsum on the CPU) or "packed" (`attention_train`); FFN: "kernel"
# the op `ffn_train`, "composed" the block's composed half (every FFN at a kernel size other than 3)
BLOCK_CONFIGS = {
    "default": None,
    "attn_xla": ("plain", "kernel"),
    "attn_xla_fused_core": ("packed", "kernel"),
    "ffn_xla": ("kernel", "composed"),
    "both_xla": ("packed", "composed"),
}
BLOCK_CASES = [(name, 3) for name in BLOCK_CONFIGS] + [("default", 5), ("attn_xla", 5)]


def _run_train(block, config, x, cond, mask):
    """The train-mode block under `config` (see BLOCK_CONFIGS), dropout off."""
    if BLOCK_CONFIGS[config] is None:
        return block(x, cond, mask, None)
    attn_half, ffn_half = BLOCK_CONFIGS[config]
    b, t_len, ch = x.shape
    m = mask.to(x.dtype)[..., None]
    x = x * m
    mods = block.adaLN_modulation(cond).view(b, 6, ch)
    a, f = block.attn, block.mlp
    dense = lambda conv: conv.weight[..., 0].t()
    if attn_half == "kernel":
        x = dit_attention_train(x, mods[:, :3], mask, dense(a.conv_q), a.conv_q.bias, dense(a.conv_k), a.conv_k.bias,
                                dense(a.conv_v), a.conv_v.bias, dense(a.conv_o), a.conv_o.bias, block.num_heads)
    else:
        shift, scale, gate = mods[:, :3, None, :].unbind(1)
        h = tb._modulate(F.layer_norm(x, (ch,), eps=1e-5), shift, scale)
        if attn_half == "plain":
            out = a(h, mask, True, block.p_dropout, None)
        else:
            q, k, v = (z.reshape(b, t_len, ch) for z in a.qkv(h))
            out = tb.conv1d_same(A.attention_train(q, k, v, mask, 0.0, None, a.n_heads), a.conv_o)
        x = x + gate * out * m
    if ffn_half == "kernel" and block.kernel_size == 3:
        return ffn_train(x, mods[:, 3:], mask, f.conv_1.weight.permute(2, 1, 0), f.conv_1.bias,
                         f.conv_2.weight.permute(2, 1, 0), f.conv_2.bias)
    return block._composed_ffn(x, mods, mask, block.p_dropout, None)


@pytest.fixture(scope="module")
def flax_block_runs():
    """The flax block's training forward (deterministic=False, dropout rate 0:
    its composed path on the CPU) with gradients, once per kernel size."""
    b, t_len, c, f, heads = 2, 44, 64, 96, 2
    rng = np.random.default_rng(21)
    mask = (np.arange(t_len)[None, :] < np.asarray([t_len, t_len - 9])[:, None]).astype(np.float32)
    x = rng.standard_normal((b, t_len, c)).astype(np.float32) * mask[..., None]
    cond = rng.standard_normal((b, c)).astype(np.float32)
    cot = rng.standard_normal((b, t_len, c)).astype(np.float32)
    runs = {}
    for ksize in (3, 5):
        blk = jb.DiTConVBlock(c, f, heads, ksize, 0.0, c)
        args = (jnp.asarray(x), jnp.asarray(cond), jnp.asarray(mask))
        pv = randomise_tree(blk.init(jax.random.PRNGKey(ksize), *args)["params"], seed=ksize)
        loss = lambda p, x_: jnp.sum(blk.apply({"params": p}, x_, args[1], args[2], False) * jnp.asarray(cot))
        out = blk.apply({"params": pv}, *args, False)
        gp, gx = jax.grad(loss, argnums=(0, 1))(pv, args[0])
        runs[ksize] = (pv, np.asarray(out), jax.tree_util.tree_map(np.asarray, gp), np.asarray(gx))
    return (b, t_len, c, f, heads), (x, cond, mask, cot), runs


@pytest.mark.parametrize("config,ksize", BLOCK_CASES)
def test_block_training_configuration_matches_flax(flax_block_runs, config, ksize):
    """Output, dx and every parameter gradient of the port's block in train
    mode under `config` against the flax block, 2e-4 on values and 1e-3
    (max-abs-err / max-abs-ref) on gradients."""
    (b, t_len, c, f, heads), (x, cond, mask, cot), runs = flax_block_runs
    pv, want, want_gp, want_gx = runs[ksize]
    sd, gsd = {}, {}
    _export_dit_block(sd, "b", pv)
    _export_dit_block(gsd, "b", want_gp)
    block = tb.DiTConVBlock(c, f, heads, ksize, c)
    block.load_state_dict({k[2:]: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()})
    block.train()
    xt = t(x).requires_grad_()
    got = _run_train(block, config, xt, t(cond), t(mask))
    (got * t(cot)).sum().backward()
    valid = mask > 0
    np.testing.assert_allclose(n(got)[valid], want[valid], rtol=2e-4, atol=2e-4)
    assert _rel(n(xt.grad), want_gx) <= 1e-3
    for name, p in block.named_parameters():
        assert _rel(n(p.grad), np.asarray(gsd["b." + name], np.float32)) <= 1e-3, name


# ---- a whole TTS step ------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_step(setup):  # noqa: F811
    jmodel, params, batch, draws = setup
    (_, (jdur, jdiff, jprior, jattn)), jgrads = _jax_loss_and_grads(jmodel, params, batch, draws)
    want = state_dict_from_jax_stabletts(jax.tree_util.tree_map(np.asarray, jgrads), TINY.n_enc_layers,
                                         TINY.n_dec_layers)
    return (float(jdur), float(jdiff), float(jprior)), np.asarray(jattn), want


def test_tts_step_under_configuration_matches_jax(setup, jax_step):  # noqa: F811
    """The three losses (rel 1e-3), the MAS path (exact) and every parameter
    gradient (1e-3 of the tensor's largest entry) of one training step with
    dropout off, on the model's one training path."""
    _, params, batch, draws = setup
    jlosses, jattn, want = jax_step
    model = _port(params)
    dur, diff, prior, attn = model(*_torch_batch(batch), None, **_torch_draws(draws))
    np.testing.assert_array_equal(attn.numpy(), jattn)
    for got, ref in zip((dur, diff, prior), jlosses):
        assert abs(float(got.detach()) - ref) <= 1e-3 * abs(ref), (float(got.detach()), ref)
    (dur + diff + prior).backward()
    worst = {name: _rel(p.grad.numpy(), want[name].numpy()) for name, p in model.named_parameters()}
    assert max(worst.values()) <= 1e-3, sorted(worst.items(), key=lambda kv: -kv[1])[:5]


# ---- bf16 compute -----------------------------------------------------------------------

BF16_LOSS_BAR = 3e-2   # rel: bf16 has 8 bits of mantissa and the two packages round at different places
# max-abs-err / max-abs-ref of each parameter's gradient, none left out. Seen here: the duration predictor's
# (its loss is an MSE on log durations, small against bf16's step) 0.19 at worst (dp.conv1.weight), every other
# tensor 0.049 at worst (a q-projection bias in the decoder), the median 0.017.
BF16_GRAD_BAR_DP = 0.25
BF16_GRAD_BAR = 0.1


def _jax_losses_in_dtype(m, batch, draws):
    """test_torch_train._jax_losses with the masks in the mels' dtype and the
    f32 reductions of models/stabletts.py:207-253, so that it runs in bf16."""
    from stabletts_tpu.models.duration_predictor import duration_loss
    from stabletts_tpu.ops.mas import maximum_path
    from stabletts_tpu.ops.mask import sequence_mask

    x, xl, y, yl, z, zl = (jnp.asarray(a) for a in batch)
    cfg = jnp.asarray(draws["cfg_mask"])
    y_mask, z_mask = sequence_mask(yl, y.shape[1], dtype=y.dtype), sequence_mask(zl, z.shape[1], dtype=z.dtype)
    c = m.ref_encoder(z, z_mask, True)
    c = c * cfg + (1 - cfg) * m.fake_speaker
    hx, mu_x, x_mask = m.encoder(x, c, xl, True)
    logw = m.dp(hx, x_mask, c, True)
    neg_cent = (-0.5 * math.log(2 * math.pi) * y.shape[-1] - 0.5 * jnp.sum(y ** 2, axis=-1, keepdims=True)
                + jnp.einsum("byd,bxd->byx", y, mu_x) - 0.5 * jnp.sum(mu_x ** 2, axis=-1)[:, None, :])
    attn = jax.lax.stop_gradient(maximum_path(jax.lax.stop_gradient(neg_cent), y_mask[:, :, None] * x_mask[:, None]))
    attn = attn.astype(y.dtype)
    logw_ = jnp.log(1e-8 + jnp.sum(attn, axis=1))[..., None] * x_mask[..., None]
    dur = duration_loss(logw, logw_, xl)
    mu_y = jnp.einsum("byx,bxd->byd", attn, mu_x)
    mu_y_masked = mu_y * cfg[..., None] + (1 - cfg[..., None]) * m.fake_content[:, None, :]
    diff, _ = m.decoder.compute_loss(y, y_mask, mu_y_masked, c, draws["t_rand"], draws["noise"], True)
    resid = (y - mu_y).astype(jnp.float32)
    prior = jnp.sum(0.5 * (resid ** 2 + math.log(2 * math.pi)) * y_mask[..., None].astype(jnp.float32))
    prior = prior / (jnp.sum(y_mask.astype(jnp.float32)) * y.shape[-1])
    return dur, diff, prior, attn


def test_bf16_step_matches_jax_bf16(setup):  # noqa: F811
    """`compute_dtype=torch.bfloat16` against the JAX package's bf16 step on
    the same draws (its `cast_tree` of the parameters and bf16 mels through
    the same composed forward, dropout off): the f32 losses within 3e-2
    (seen: 2.5e-4), the gradients f32 on the f32 master parameters and every
    one of them within 0.1 of the JAX bf16 gradient (0.25 in the duration
    predictor); both bf16 runs stay within 5e-2 of the f32 losses."""
    from stabletts_tpu.models.sampler import cast_tree

    jmodel, params, batch, draws = setup
    x, xl, y, yl, z, zl = batch
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    jbatch = (x, xl, bf(y), yl, bf(z), zl)
    jdraws = {k: bf(v) for k, v in draws.items()}

    def loss_fn(p):
        dur, diff, prior, _ = _jax_apply(jmodel, cast_tree(p, jnp.bfloat16),
                                         lambda m: _jax_losses_in_dtype(m, jbatch, jdraws))
        return (dur + diff + prior).astype(jnp.float32), (dur, diff, prior)

    (_, jlosses), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    (_, (f32_losses)), _ = _jax_loss_and_grads(jmodel, params, batch, draws)
    want = state_dict_from_jax_stabletts(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jgrads),
                                         TINY.n_enc_layers, TINY.n_dec_layers)

    model = _port(params)
    dur, diff, prior, _ = model_losses(model, _torch_batch(batch), None, torch.bfloat16, **_torch_draws(draws))
    (dur + diff + prior).backward()
    for got, ref, ref32 in zip((dur, diff, prior), jlosses, f32_losses[:3]):
        assert got.dtype == torch.float32
        got, ref, ref32 = float(got.detach()), float(ref), float(ref32)
        assert abs(got - ref) <= BF16_LOSS_BAR * abs(ref), (got, ref)
        assert abs(got - ref32) <= 5e-2 * abs(ref32) and abs(ref - ref32) <= 5e-2 * abs(ref32)
    errs = {}
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad is not None and p.grad.dtype == torch.float32, name
        errs[name] = _rel(p.grad.numpy(), want[name].numpy())
    assert set(errs) == set(want)
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    print("bf16 step, worst gradient rel errs against the JAX bf16 step:", worst)
    assert all(e <= (BF16_GRAD_BAR_DP if name.startswith("dp.") else BF16_GRAD_BAR) for name, e in errs.items()), worst
