"""The port's training path against the JAX package on the CPU, at a tiny
config (hidden 32, 2 heads, 1 encoder and 2 decoder layers, 16 mels):

  * one step's three losses, the MAS path and every parameter gradient
    against the JAX package's composed training forward (as
    tests/test_parity_training.py composes it), with the same CFG mask, t and
    noise draws and dropout off;
  * three AdamW steps against optax adamw + cosine_with_warmup;
  * data batches bit-equal to the JAX package's collate and
    DistributedBucketSampler;
  * `train()` end to end on a synthetic filelist with checkpoint resume, and
    `StableTTSAPI` loading the checkpoint it wrote.
"""

import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stabletts_torch.config import MelConfig, ModelConfig, TrainConfig, VocosConfig
from stabletts_torch.train.scheduler import make_scheduler
from stabletts_torch.train.train_tts import make_optimizer, train, train_step
from stabletts_torch.utils.convert import state_dict_from_jax_stabletts
from torch_port_utils import jax_stabletts, port_stabletts

torch.set_num_threads(2)
TINY = ModelConfig(hidden_channels=32, filter_channels=64, n_heads=2, n_enc_layers=1, n_dec_layers=2,
                   p_dropout=0.1, gin_channels=32)
TINY_MEL = MelConfig(n_mels=16)
B, TX, TY, TZ = 4, 12, 40, 10
LOSS_BAR = 1e-3   # rel, f32 on both sides
GRAD_BAR = 1e-3   # max-abs-err / max-abs-ref per parameter tensor


@pytest.fixture(scope="module")
def setup():
    jmodel, params = jax_stabletts(TINY, TINY_MEL)
    rng = np.random.default_rng(0)
    x = rng.integers(1, 50, size=(B, TX)).astype(np.int32)
    xl = np.asarray([TX, TX - 4, TX, TX - 2], np.int32)
    z = rng.standard_normal((B, TZ, TINY_MEL.n_mels)).astype(np.float32)
    zl = np.asarray([TZ, TZ - 3, TZ, TZ], np.int32)
    draws = dict(cfg_mask=np.asarray([[1.0], [0.0], [1.0], [1.0]], np.float32),
                 t_rand=rng.uniform(size=(B,)).astype(np.float32),
                 noise=rng.standard_normal((B, TY, TINY_MEL.n_mels)).astype(np.float32))
    # y follows the model's own mu_x along known durations plus noise 0.1, so
    # MAS has one clear optimum and both packages find the same path
    mu_x = np.asarray(_jax_apply(jmodel, params, lambda m: _jax_mu_x(m, x, xl, z, zl, draws["cfg_mask"])))
    durs = rng.integers(1, 4, size=(B, TX)) * (np.arange(TX)[None] < xl[:, None])
    yl = durs.sum(1).astype(np.int32)
    assert yl.max() <= TY
    y = np.zeros((B, TY, TINY_MEL.n_mels), np.float32)
    for i in range(B):
        y[i, :yl[i]] = np.repeat(mu_x[i], durs[i], axis=0)
    y += 0.1 * rng.standard_normal(y.shape).astype(np.float32) * (np.arange(TY)[None, :, None] < yl[:, None, None])
    return jmodel, params, (x, xl, y, yl, z, zl), draws


def _jax_apply(jmodel, params, fn):
    return jmodel.apply({"params": params}, method=fn)


def _jax_mu_x(m, x, xl, z, zl, cfg_mask):
    from stabletts_tpu.ops.mask import sequence_mask

    c = m.ref_encoder(jnp.asarray(z), sequence_mask(jnp.asarray(zl), z.shape[1]), True)
    c = c * cfg_mask + (1 - cfg_mask) * m.fake_speaker
    return m.encoder(jnp.asarray(x), c, jnp.asarray(xl), True)[1]


def _jax_losses(m, batch, draws):
    """The JAX package's training forward composed from its modules, with
    explicit draws and dropout off (tests/test_parity_training.py:98-142,
    plus the shared CFG mask of models/stabletts.py:213-243)."""
    from stabletts_tpu.models.duration_predictor import duration_loss
    from stabletts_tpu.ops.mas import maximum_path
    from stabletts_tpu.ops.mask import sequence_mask

    x, xl, y, yl, z, zl = (jnp.asarray(a) for a in batch)
    cfg = jnp.asarray(draws["cfg_mask"])
    y_mask, z_mask = sequence_mask(yl, y.shape[1]), sequence_mask(zl, z.shape[1])
    c = m.ref_encoder(z, z_mask, True)
    c = c * cfg + (1 - cfg) * m.fake_speaker
    hx, mu_x, x_mask = m.encoder(x, c, xl, True)
    logw = m.dp(hx, x_mask, c, True)
    neg_cent = (-0.5 * math.log(2 * math.pi) * y.shape[-1] - 0.5 * jnp.sum(y ** 2, axis=-1, keepdims=True)
                + jnp.einsum("byd,bxd->byx", y, mu_x) - 0.5 * jnp.sum(mu_x ** 2, axis=-1)[:, None, :])
    attn = jax.lax.stop_gradient(maximum_path(jax.lax.stop_gradient(neg_cent), y_mask[:, :, None] * x_mask[:, None]))
    logw_ = jnp.log(1e-8 + jnp.sum(attn, axis=1))[..., None] * x_mask[..., None]
    dur = duration_loss(logw, logw_, xl)
    mu_y = jnp.einsum("byx,bxd->byd", attn, mu_x)
    mu_y_masked = mu_y * cfg[..., None] + (1 - cfg[..., None]) * m.fake_content[:, None, :]
    diff, _ = m.decoder.compute_loss(y, y_mask, mu_y_masked, c, jnp.asarray(draws["t_rand"]),
                                     jnp.asarray(draws["noise"]), True)
    prior = jnp.sum(0.5 * ((y - mu_y) ** 2 + math.log(2 * math.pi)) * y_mask[..., None])
    prior = prior / (jnp.sum(y_mask) * y.shape[-1])
    return dur, diff, prior, attn


def _jax_loss_and_grads(jmodel, params, batch, draws):
    def loss_fn(p):
        dur, diff, prior, attn = _jax_apply(jmodel, p, lambda m: _jax_losses(m, batch, draws))
        return dur + diff + prior, (dur, diff, prior, attn)

    return jax.value_and_grad(loss_fn, has_aux=True)(params)


def _port(params):
    model = port_stabletts(params, TINY, TINY_MEL)
    model.train()
    return model


def _torch_batch(batch):
    return tuple(torch.from_numpy(np.asarray(a)) for a in batch)


def _torch_draws(draws):
    return {k: torch.from_numpy(v) for k, v in draws.items()}


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_one_step_losses_path_and_gradients_match_jax(setup):
    jmodel, params, batch, draws = setup
    (_, (jdur, jdiff, jprior, jattn)), jgrads = _jax_loss_and_grads(jmodel, params, batch, draws)
    model = _port(params)
    dur, diff, prior, attn = model(*_torch_batch(batch), None, **_torch_draws(draws))
    np.testing.assert_array_equal(attn.numpy(), np.asarray(jattn))
    for got, want in ((dur, jdur), (diff, jdiff), (prior, jprior)):
        got, want = float(got.detach()), float(want)
        assert abs(got - want) <= LOSS_BAR * abs(want), (got, want)

    (dur + diff + prior).backward()
    want = state_dict_from_jax_stabletts(jax.tree_util.tree_map(np.asarray, jgrads), TINY.n_enc_layers,
                                         TINY.n_dec_layers)
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    worst = {name: _rel(p.grad.numpy(), want[name].numpy()) for name, p in named.items()}
    assert max(worst.values()) <= GRAD_BAR, sorted(worst.items(), key=lambda kv: -kv[1])[:5]
    # the zero entry of the CFG mask reaches the unconditional embeddings
    assert float(np.abs(want["fake_speaker"].numpy()).max()) > 0


def test_three_adamw_steps_match_optax(setup):
    """Losses of every step within 1e-3. Parameters: Adam's per-element
    step lr * m_hat / (sqrt(v_hat) + eps) is about lr whatever the
    gradient's size, so where a gradient is zero in exact arithmetic and
    f32 noise in both frameworks (the key-projection biases: softmax is
    invariant to them) the two updates may differ by up to 2 * lr per step.
    The bar: every element within 2 * sum(lr_k) of optax's, and all but
    1e-4 of all elements within 1e-2 of their tensor's largest move."""
    import optax

    from stabletts_tpu.config import TrainConfig as JTrainConfig
    from stabletts_tpu.train.train_tts import make_optimizer as jmake_optimizer

    jmodel, params, batch, draws = setup
    cfg = TrainConfig(learning_rate=1e-3, warmup_steps=2)
    tx = jmake_optimizer(JTrainConfig(learning_rate=1e-3, warmup_steps=2), total_steps=100)
    jp, opt_state, jlosses = params, tx.init(params), []
    for _ in range(3):
        (loss, _), grads = _jax_loss_and_grads(jmodel, jp, batch, draws)
        updates, opt_state = tx.update(grads, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        jlosses.append(float(loss))

    model = _port(params)
    opt = make_optimizer(model, cfg)
    sched = make_scheduler(opt, cfg.learning_rate, cfg.warmup_steps, 100)
    losses = [float(train_step(model, opt, sched, _torch_batch(batch), None, **_torch_draws(draws))["loss"])
              for _ in range(3)]
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_BAR)

    init = state_dict_from_jax_stabletts(params, TINY.n_enc_layers, TINY.n_dec_layers)
    want = state_dict_from_jax_stabletts(jax.tree_util.tree_map(np.asarray, jp), TINY.n_enc_layers,
                                         TINY.n_dec_layers)
    lr_sum = sum(cfg.learning_rate * f for f in (0.0, 0.5, 1.0))  # warmup 2: steps 0, 1, 2
    off = total = 0
    for name, p in model.state_dict().items():
        moved = np.abs(want[name].numpy() - init[name].numpy()).max()
        err = np.abs(p.numpy() - want[name].numpy())
        assert err.max() <= 2 * lr_sum, name
        off += int((err > 1e-2 * moved).sum())
        total += err.size
    assert off <= 1e-4 * total, (off, total)


def test_forward_without_generator_needs_every_draw(setup):
    """Random draws come only from the caller's generator, never from
    torch's global RNG."""
    _, params, batch, draws = setup
    model = _port(params)
    partial = {k: v for k, v in _torch_draws(draws).items() if k != "noise"}
    with pytest.raises(ValueError):
        model(*_torch_batch(batch), None, **partial)


def test_bf16_compute_dtype_is_not_available(tmp_path):
    """What is not available is any compute dtype but float32 and bfloat16:
    `compute_dtype="bfloat16"` trains (f32 master parameters, finite losses),
    "float16" is refused. (The test is older than bf16 training, when it held
    the refusal of bfloat16 itself, and keeps its name.)"""
    path = _filelist(tmp_path, 4, TINY_MEL.n_mels)
    cfg = TrainConfig(train_dataset_path=path, batch_size=4, num_epochs=1, model_save_path=str(tmp_path / "ck"),
                      warmup_steps=1, bucket_boundaries=(32, 64, 128), max_text_len=16, log_interval=1,
                      loader_workers=0, compute_dtype="bfloat16")
    logged = []
    state = train(cfg, TINY, TINY_MEL, log_fn=lambda step, m: logged.append(m), device="cpu")
    assert state.step == 1 and all(np.isfinite(list(m.values())).all() for m in logged)
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    with pytest.raises(ValueError):
        train(dataclasses.replace(cfg, compute_dtype="float16"), TINY, TINY_MEL, device="cpu")


# ---- two faults of the training block, each shown against the JAX package ----------

def _flax_block(ksize, p_dropout):
    from stabletts_tpu.nn import blocks as jb
    from torch_port_utils import randomise_tree

    b, t_len, c, f, heads = 2, 30, 32, 48, 2
    rng = np.random.default_rng(ksize)
    mask = (np.arange(t_len)[None, :] < np.asarray([t_len, t_len - 7])[:, None]).astype(np.float32)
    x = rng.standard_normal((b, t_len, c)).astype(np.float32) * mask[..., None]
    cond = rng.standard_normal((b, c)).astype(np.float32)
    blk = jb.DiTConVBlock(c, f, heads, ksize, p_dropout, c)
    args = (jnp.asarray(x), jnp.asarray(cond), jnp.asarray(mask))
    pv = randomise_tree(blk.init(jax.random.PRNGKey(0), *args)["params"], seed=3)
    return blk, pv, args, (x, cond, mask), (c, f, heads)


def _port_block(pv, c, f, heads, ksize, p_dropout):
    from stabletts_torch.nn import blocks as tb
    from stabletts_torch.utils.convert import _export_dit_block

    sd = {}
    _export_dit_block(sd, "b", pv)
    block = tb.DiTConVBlock(c, f, heads, ksize, c, p_dropout)
    block.load_state_dict({k[2:]: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()})
    return block


def test_training_block_with_kernel_size_5_matches_jax():
    """A training forward with kernel_size != 3 takes the composed FFN, as the
    flax block does (its fused FFN half needs 3 taps), and never hands the
    5-tap weights to the 3-tap `ffn_train`."""
    blk, pv, args, (x, cond, mask), (c, f, heads) = _flax_block(5, 0.0)
    want = np.asarray(blk.apply({"params": pv}, *args, False))
    block = _port_block(pv, c, f, heads, 5, 0.0).train()
    got = block(torch.from_numpy(x), torch.from_numpy(cond), torch.from_numpy(mask), None)
    valid = mask > 0
    np.testing.assert_allclose(got.detach().numpy()[valid], want[valid], rtol=2e-4, atol=2e-4)
    got.sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in block.parameters())


def test_train_mode_without_autograd_keeps_dropout():
    """The JAX block's gate is `deterministic` alone: with deterministic=False
    it drops, whether or not anything is differentiated. So the port's gate
    is `self.training` alone: a train-mode forward under torch.no_grad() (a
    validation pass that keeps dropout) draws the same dropout as the same
    forward with autograd on, and differs from the eval-mode forward, which
    is the inference path and drops nothing."""
    blk, pv, args, (x, cond, mask), (c, f, heads) = _flax_block(3, 0.5)
    det = np.asarray(blk.apply({"params": pv}, *args, True))
    drop = np.asarray(blk.apply({"params": pv}, *args, False, rngs={"dropout": jax.random.PRNGKey(1)}))
    valid = mask > 0
    assert np.abs(drop - det)[valid].max() > 1e-2  # nothing is differentiated here, and it drops

    block = _port_block(pv, c, f, heads, 3, 0.5)
    xt, ct, mt = torch.from_numpy(x), torch.from_numpy(cond), torch.from_numpy(mask)
    gen = torch.Generator()
    block.train()
    with_grad = block(xt, ct, mt, gen.manual_seed(7)).detach()
    with torch.no_grad():
        without_grad = block(xt, ct, mt, gen.manual_seed(7))
        assert torch.equal(with_grad, without_grad)
        block.eval()
        evaluated = block(xt, ct, mt, gen.manual_seed(7))
    np.testing.assert_allclose(evaluated.numpy()[valid], det[valid], rtol=2e-4, atol=2e-4)
    assert (without_grad - evaluated).abs()[torch.from_numpy(valid)].max() > 1e-2


# ---- data ---------------------------------------------------------------------

def _filelist(tmp_path, n, n_mels, lengths=(40, 60), seed=0):
    from stabletts_torch.text import symbols

    rng = np.random.default_rng(seed)
    path = tmp_path / "filelist.jsonl"
    with open(path, "w") as f:
        for i in range(n):
            t = int(rng.integers(*lengths))
            mel_path = tmp_path / f"mel_{i}.npy"
            np.save(mel_path, rng.standard_normal((t, n_mels)).astype(np.float32))
            phones = [symbols[k] for k in rng.integers(1, len(symbols), size=int(rng.integers(3, 9)))]
            f.write(json.dumps({"mel_path": str(mel_path), "phone": phones, "mel_length": t}) + "\n")
    return str(path)


@pytest.mark.parametrize("replicas,rank", [(1, 0), (2, 1)])
def test_batches_bit_equal_to_jax_package(tmp_path, replicas, rank):
    from stabletts_torch.data.dataset import StableDataset, collate
    from stabletts_torch.data.sampler import DistributedBucketSampler
    from stabletts_tpu.data.dataset import StableDataset as JStableDataset
    from stabletts_tpu.data.dataset import collate as jcollate
    from stabletts_tpu.data.sampler import DistributedBucketSampler as JSampler

    path = _filelist(tmp_path, 23, 8, lengths=(20, 130))
    ours, theirs = StableDataset(path), JStableDataset(path)
    assert ours.lengths == theirs.lengths
    kw = dict(num_replicas=replicas, rank=rank)
    s1, s2 = DistributedBucketSampler(ours.lengths, 4, [32, 64, 128], **kw), \
        JSampler(theirs.lengths, 4, [32, 64, 128], **kw)
    assert len(s1) == len(s2) > 0
    for epoch in (0, 1):
        s1.set_epoch(epoch)
        s2.set_epoch(epoch)
        got, want = list(s1), list(s2)
        assert got == want
        for bucket, idx in got:
            a = collate(ours, idx, s1.bucket_mel_len(bucket), 16, 8, (3, epoch)).as_tuple()
            b = jcollate(theirs, idx, s2.bucket_mel_len(bucket), 16, 8, (3, epoch)).as_tuple()
            for u, v in zip(a, b):
                assert u.dtype == v.dtype and np.array_equal(u, v)


def test_prefetch_keeps_order_and_matches_sequential():
    from stabletts_torch.data.prefetch import prefetch

    fn = lambda i: (i, i * i)
    assert list(prefetch(range(50), fn, n_workers=3, depth=4)) == list(map(fn, range(50)))


# ---- train() end to end -----------------------------------------------------------

def test_train_end_to_end_with_resume(tmp_path):
    from stabletts_torch.api import StableTTSAPI

    path = _filelist(tmp_path, 8, TINY_MEL.n_mels)
    cfg = TrainConfig(train_dataset_path=path, batch_size=4, num_epochs=2, model_save_path=str(tmp_path / "ck"),
                      warmup_steps=1, bucket_boundaries=(32, 64, 128), max_text_len=16, log_interval=1,
                      loader_workers=2, prefetch_depth=2)
    logged = []
    state = train(cfg, TINY, TINY_MEL, log_fn=lambda step, m: logged.append((step, m)), device="cpu")
    assert (state.step, state.start_epoch) == (4, 0)  # 2 epochs x 2 steps
    assert [s for s, _ in logged] == [0, 1, 2, 3]
    assert all(np.isfinite(list(m.values())).all() for _, m in logged)
    assert set(logged[0][1]) == {"loss", "dur_loss", "diff_loss", "prior_loss", "grad_norm"}
    files = set(os.listdir(tmp_path / "ck"))
    assert {"checkpoint_0.pt", "optimizer_0.pt", "checkpoint_1.pt", "optimizer_1.pt"} <= files

    # resume: one more epoch starts at epoch 2, step 4, with the schedule's count
    state = train(dataclasses.replace(cfg, num_epochs=3), TINY, TINY_MEL,
                  log_fn=lambda step, m: logged.append((step, m)), device="cpu")
    assert (state.start_epoch, state.step) == (2, 6)
    assert [s for s, _ in logged[4:]] == [4, 5]
    assert state.scheduler.last_epoch == 6

    # a model-only checkpoint is a pretrained init at epoch 0
    os.remove(tmp_path / "ck" / "optimizer_2.pt")
    os.remove(tmp_path / "ck" / "optimizer_1.pt")
    os.remove(tmp_path / "ck" / "optimizer_0.pt")
    state = train(dataclasses.replace(cfg, num_epochs=1), TINY, TINY_MEL, device="cpu")
    assert state.start_epoch == 0

    # the API serves a checkpoint the trainer wrote
    api = StableTTSAPI(tts_model_path=str(tmp_path / "ck" / "checkpoint_2.pt"), model_config=TINY,
                       mel_config=TINY_MEL, vocos_config=VocosConfig(input_channels=16, dim=32,
                                                                     intermediate_dim=64, num_layers=1),
                       device="cpu")
    saved = torch.load(tmp_path / "ck" / "checkpoint_2.pt", weights_only=True)
    for name, v in api.tts_model.state_dict().items():
        assert torch.equal(v, saved[name]), name
