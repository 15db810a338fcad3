"""Data parallelism of the port (stabletts_torch/parallel/mesh.py and both
trainers) on the CPU, with gloo process groups.

The ground truth is the JAX package's: an N-process run equals a one-process
run over the same global batches (every rank's shard concatenated), because
every random draw and every loss reduction is over the global batch
(tests/test_multiprocess.py). So:

  (a) two `train()` ranks (dropout 0.1) end bit-equal to each other and equal
      a one-process replay of the global batches within the JAX test's bar
      (rtol 2e-5, atol 2e-6); rank 0 alone wrote the checkpoints, rank 0
      alone logged, and resuming restores the final state bit for bit;
  (b) a run in a gloo group of one gives the bits of a run without a group;
  (c) two `train_vocos()` ranks equal each other and a one-process replay of
      the ranks' crops;
  (d) two shards with the global loss normalisers give, summed, the first
      step's losses and gradients of the JAX package's step over the global
      batch (explicit draws, dropout off);
  (e) a draw over rows [k, k + B) is rows k .. k + B - 1 of the global draw:
      the kernels' Philox bits and the plain draws;
  (f) the mesh's bookkeeping (also asserted inside every rank).
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import torch_ddp_worker as W
from stabletts_torch.ops import philox
from stabletts_torch.parallel import mesh as mesh_lib
from stabletts_torch.train.train_tts import loss_norms, model_losses
from test_torch_train import setup  # noqa: F401  (the tiny model and batch of the training parity tests)

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 2e-5, 2e-6  # tests/test_multiprocess.py:179-181
TIMEOUT = 300


def _spawn(tmp_path, kind, world):
    """Run `world` worker ranks (or one worker for tts_world1) to their end."""
    init = tmp_path / f"rdzv_{kind}"
    out = tmp_path / f"out_{kind}"
    out.mkdir()
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    procs = [subprocess.Popen([sys.executable, os.path.join(REPO, "tests", "torch_ddp_worker.py"), "--kind", kind,
                               "--rank", str(r), "--world", str(world), "--init", str(init), "--data", str(tmp_path),
                               "--out", str(out)], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"{kind}: the ranks did not finish in {TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"rank {r}: OK" in text, f"rank {r} failed:\n{text[-4000:]}"
    infos = [json.loads((out / f"info_rank{r}.json").read_text()) for r in range(world)]
    return out, infos


def _assert_close(got: dict, want: dict):
    assert set(got) == set(want)
    for k in sorted(want):
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=RTOL, atol=ATOL, err_msg=k)


def _tts_replay(filelist, world):
    """The data-parallel run on one process: each step's global batch is the
    ranks' shards concatenated, drawn from the generator at (seed, step)."""
    from stabletts_torch.data.dataset import StableDataset, collate
    from stabletts_torch.data.sampler import DistributedBucketSampler
    from stabletts_torch.models import build_stabletts
    from stabletts_torch.train.scheduler import make_scheduler
    from stabletts_torch.train.train_tts import make_optimizer, train_step

    cfg = W.tts_config(str(filelist))
    dataset = StableDataset(cfg.train_dataset_path)
    samplers = [DistributedBucketSampler(dataset.lengths, cfg.batch_size, list(cfg.bucket_boundaries),
                                         num_replicas=world, rank=r) for r in range(world)]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        model = build_stabletts(W.TINY, W.TINY_MEL, device="cpu")
    model.train()
    opt = make_optimizer(model, cfg)
    sched = make_scheduler(opt, cfg.learning_rate, cfg.warmup_steps, cfg.num_epochs * len(samplers[0]))
    gen = torch.Generator()
    step, losses = 0, []
    for epoch in range(cfg.num_epochs):
        for s in samplers:
            s.set_epoch(epoch)
        for works in zip(*samplers):
            parts = [collate(dataset, idx, s.bucket_mel_len(bucket), cfg.max_text_len, W.TINY_MEL.n_mels,
                             (cfg.seed, epoch)).as_tuple() for s, (bucket, idx) in zip(samplers, works)]
            batch = tuple(torch.from_numpy(np.concatenate(p)) for p in zip(*parts))
            gen.manual_seed((cfg.seed + 1) * 2 ** 32 + step)
            losses.append(float(train_step(model, opt, sched, batch, gen)["loss"]))
            step += 1
    return model.state_dict(), losses


def test_two_tts_ranks_equal_each_other_and_the_one_process_run(tmp_path):
    filelist = W.write_tts_dataset(str(tmp_path))
    out, infos = _spawn(tmp_path, "tts", 2)
    ranks = [torch.load(out / f"final_rank{r}.pt", weights_only=True) for r in range(2)]
    for k, v in ranks[0].items():
        assert torch.equal(v, ranks[1][k]), k
    want, losses = _tts_replay(filelist, 2)
    _assert_close(ranks[0], want)
    # 2 epochs of 2 global batches of 8; rank 0 alone saved (both epochs) and logged the global losses
    assert [i["step"] for i in infos] == [4, 4]
    assert infos[0]["saves"] == [0, 1] and infos[1]["saves"] == []
    assert sorted(os.listdir(out / "ckpt")) == [f"{p}_{e}.pt" for p in ("checkpoint", "optimizer") for e in (0, 1)]
    assert [s for s, _ in infos[0]["logged"]] == [0, 1, 2, 3] and infos[1]["logged"] == []
    np.testing.assert_allclose([m["loss"] for _, m in infos[0]["logged"]], losses, rtol=1e-5)


def test_world_of_one_is_the_run_without_a_group(tmp_path):
    W.write_tts_dataset(str(tmp_path))
    out, _ = _spawn(tmp_path, "tts_world1", 1)
    runs = torch.load(out / "world1.pt", weights_only=True)
    for k, v in runs["alone"].items():
        assert torch.equal(v, runs["group"][k]), k


def _vocos_replay(wav_dir):
    from stabletts_torch.data.vocos_dataset import VocosDataset
    from stabletts_torch.train.train_vocos import init_vocos_training, vocos_train_step

    cfg = W.vocos_config(wav_dir)
    dataset = VocosDataset(cfg.train_dataset_path, cfg.segment_size, W.GAN_MEL.sample_rate)
    steps = len(dataset) // 2 // cfg.batch_size
    state = init_vocos_training(W.GAN_VOCOS, W.GAN_MEL, cfg, cfg.num_epochs * steps, cfg.seed, "cpu")
    for epoch in range(cfg.num_epochs):
        order = np.random.default_rng(epoch).permutation(len(dataset))
        for b in range(steps):
            parts = [dataset.batch(order[r::2][b * cfg.batch_size:(b + 1) * cfg.batch_size],
                                   np.random.default_rng(np.random.SeedSequence([cfg.seed, epoch, r, b])))
                     for r in range(2)]
            vocos_train_step(state, torch.from_numpy(np.concatenate(parts)), W.GAN_MEL, cfg.mel_loss_coeff,
                             cfg.grad_clip)
    return {f"{name}.{k}": v for name in ("gen", "mpd", "mrd") for k, v in getattr(state, name).state_dict().items()}


def test_two_vocos_ranks_equal_each_other_and_the_one_process_run(tmp_path):
    wavs = W.write_wavs(str(tmp_path / "wavs"))
    out, infos = _spawn(tmp_path, "vocos", 2)
    ranks = [torch.load(out / f"final_rank{r}.pt", weights_only=True) for r in range(2)]
    for k, v in ranks[0].items():
        assert torch.equal(v, ranks[1][k]), k
    _assert_close(ranks[0], _vocos_replay(wavs))
    # 8 clips, 2 ranks of 2: 2 steps; rank 0 alone saved and logged
    assert [i["step"] for i in infos] == [2, 2]
    assert infos[0]["saves"] == [0] and infos[1]["saves"] == []
    assert [s for s, _ in infos[0]["logged"]] == [0, 1] and infos[1]["logged"] == []


# ---- (d) the global normaliser against the JAX package's global-batch step ----

def test_shards_with_global_normalisers_sum_to_the_jax_global_step(setup):
    from test_torch_train import GRAD_BAR, LOSS_BAR, TINY, _jax_loss_and_grads, _port, _rel, _torch_batch
    from stabletts_torch.utils.convert import state_dict_from_jax_stabletts

    jmodel, params, batch, draws = setup
    (_, (jdur, jdiff, jprior, _)), jgrads = _jax_loss_and_grads(jmodel, params, batch, draws)
    want_grads = state_dict_from_jax_stabletts(jax.tree_util.tree_map(np.asarray, jgrads), TINY.n_enc_layers,
                                               TINY.n_dec_layers)
    full = _torch_batch(batch)
    norms = loss_norms(mesh_lib.make_mesh("cpu"), full)  # no group: the global batch's own sums
    # the shards' text and mel sums differ, so local normalisers would not add up to the global loss
    assert int(full[1][:2].sum()) != int(full[1][2:].sum()) and int(full[3][:2].sum()) != int(full[3][2:].sum())
    model = _port(params)
    totals, local = np.zeros(3), np.zeros(3)
    for rows in (slice(0, 2), slice(2, 4)):
        shard = tuple(a[rows] for a in full)
        shard_draws = {k: torch.from_numpy(v[rows]) for k, v in draws.items()}
        losses = model_losses(model, shard, None, None, norms, **shard_draws)[:3]
        sum(losses).backward()  # gradients add up over the shards, as the all-reduce sums them
        totals += [float(v.detach()) for v in losses]
        with torch.no_grad():
            local += [float(v) for v in model_losses(model, shard, None, None, None, **shard_draws)[:3]]
    for got, want in zip(totals, (jdur, jdiff, jprior)):
        assert abs(got - float(want)) <= LOSS_BAR * abs(float(want)), (got, float(want))
    # the naive form (each shard over its own sums, averaged over the ranks) misses the bar several times over
    assert abs(local.sum() / 2 - float(jdur + jdiff + jprior)) > 5 * LOSS_BAR * float(jdur + jdiff + jprior)
    worst = {name: _rel(p.grad.numpy(), want_grads[name].numpy()) for name, p in model.named_parameters()}
    assert max(worst.values()) <= GRAD_BAR, sorted(worst.items(), key=lambda kv: -kv[1])[:5]


# ---- (e) row-windowed draws ----

@pytest.mark.parametrize("row0", [0, 3, 5])
def test_philox_rows_are_rows_of_the_global_mask(row0):
    seed = torch.tensor([123456789, 987654321], dtype=torch.int64)
    b, total = 3, 8
    att = philox.attention_keep(seed, total, 2, 37, 0.1)
    assert torch.equal(philox.attention_keep(seed, b, 2, 37, 0.1, row0), att[row0:row0 + b])
    ffn = philox.ffn_keep(seed, total, 29, 45, 0.1)
    assert torch.equal(philox.ffn_keep(seed, b, 29, 45, 0.1, row0), ffn[row0:row0 + b])
    assert philox.kernel_args(0.1, seed, "x", row0)[2] == row0


@pytest.mark.parametrize("row0", [0, 2, 4])
def test_window_draws_are_rows_of_the_global_draw(row0):
    from stabletts_torch.nn.blocks import dropout

    b, total = 2, 6
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((total, 11, 7)).astype(np.float32))
    gen = torch.Generator().manual_seed(7)
    want = [dropout(x, 0.25, gen), torch.rand((total, 1), generator=gen),
            torch.randn((total, 5, 3), generator=gen)]
    want_state = gen.get_state()
    window = mesh_lib.RowWindow(gen.manual_seed(7), row0, total)
    got = [dropout(x[row0:row0 + b], 0.25, window), mesh_lib.rows_rand(window, (b, 1), "cpu"),
           mesh_lib.rows_rand(window, (b, 5, 3), "cpu", normal=True)]
    for g, w in zip(got, want):
        assert torch.equal(g, w[row0:row0 + b])
    assert torch.equal(gen.get_state(), want_state)  # the next draw is the same on every rank
    fork = mesh_lib.forked(window, want_state)
    assert (fork.row0, fork.rows) == (row0, total) and torch.equal(fork.generator.get_state(), want_state)
    assert mesh_lib.row0_of(window) == row0 and mesh_lib.row0_of(gen) == 0 and mesh_lib.generator_of(window) is gen
    # a bare generator is the window of its own batch
    gen.manual_seed(7)
    assert torch.equal(mesh_lib.rows_rand(gen, (total, 1), "cpu"), torch.rand((total, 1), generator=gen.manual_seed(7)))
    with pytest.raises(ValueError):
        mesh_lib.rows_rand(mesh_lib.RowWindow(gen, total - 1, total), (b, 1), "cpu")


def test_model_window_over_the_whole_batch_is_the_bare_generator(setup):
    """The trainer always passes a window; over the whole batch it must draw
    the bits of the bare generator (dropout, CFG mask, t and noise)."""
    from test_torch_train import _port, _torch_batch

    _, params, batch, _ = setup
    model = _port(params)
    full = _torch_batch(batch)
    out = []
    for gen in (torch.Generator().manual_seed(3), mesh_lib.RowWindow(torch.Generator().manual_seed(3), 0, 4)):
        with torch.no_grad():
            out.append(torch.stack(model_losses(model, full, gen)[:3]))
    assert torch.equal(out[0], out[1])


# ---- (f) bookkeeping ----

@pytest.mark.parametrize("rank,world", [(0, 1), (1, 2), (2, 3)])
def test_shard_bookkeeping(rank, world):
    mesh = mesh_lib.Mesh(rank, world, torch.device("cpu"), world > 1)
    shard = mesh_lib.shard_batch(mesh, 4)
    assert (shard.local_rows, shard.global_rows, shard.row0) == (4, 4 * world, 4 * rank)
    window = mesh_lib.window(torch.Generator(), shard)
    assert (window.row0, window.rows) == (4 * rank, 4 * world)


def test_make_mesh_without_a_group_is_a_world_of_one():
    mesh = mesh_lib.make_mesh("cpu")
    assert (mesh.rank, mesh.world, mesh.group, mesh.device) == (0, 1, False, torch.device("cpu"))
    t = torch.ones(3)
    assert mesh_lib.all_reduce_sum(mesh, t) is t and torch.equal(t, torch.ones(3))
    with pytest.raises(RuntimeError):  # no GPU here, and no silent move to the CPU
        mesh_lib.make_mesh()


def test_cli_joins_torchrun_group_only_above_world_one(monkeypatch):
    """`train` and `train-vocos` join torchrun's group when WORLD_SIZE > 1 (no new flag)."""
    from stabletts_torch import cli

    calls = []
    monkeypatch.setattr(mesh_lib, "init_distributed", lambda device=None, **kw: calls.append(device))
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    cli._join_group("cpu")
    monkeypatch.setenv("WORLD_SIZE", "1")
    cli._join_group("cpu")
    assert calls == []
    monkeypatch.setenv("WORLD_SIZE", "2")
    cli._join_group("cpu")
    assert calls == ["cpu"]
