"""TTS training on one GPU (reference: train.py:39-96).

One step is the training forward of `StableTTS` (MAS alignment on the
device, the duration, diffusion and prior losses), the backward pass and an
AdamW update with the cosine-warmup schedule. Loss = dur + diff + prior,
summed unweighted (train.py:78-79). With `compute_dtype="bfloat16"` the
forward and backward run in bf16 against f32 master parameters, as the JAX
package's `make_train_step` does it: every floating parameter and the mels
are cast to bf16 through a differentiable cast (so the gradients arrive in
f32 on the master parameters), the loss reductions and MAS stay f32 where the
model keeps them so, and the optimizer state is f32. It is not
`torch.autocast`, whose per-op casting list differs from that cast.

Data parallelism (`parallel/mesh.py`): run one process per rank under a
process group (`torchrun`, or `parallel.mesh.init_distributed`). Each rank
trains on its rank-strided shard of every global batch and the step stays the
JAX package's one SPMD step over the global batch: the loss denominators (the
text and mel lengths) are summed over the ranks before the forward, so each
rank's loss is its share of the global loss and the summed gradient is the
global batch's; every random draw is made at the global batch's row count
(`mesh.RowWindow`); the gradients are summed over one flat buffer before the
norm and the update. Rank 0 writes the checkpoints and calls `log_fn`.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from stabletts_torch.config import MelConfig, ModelConfig, TrainConfig
from stabletts_torch.models import build_stabletts
from stabletts_torch.parallel import mesh as mesh_lib
from stabletts_torch.train.scheduler import make_scheduler
from stabletts_torch.train.state import continue_training, optimizer_steps, save_checkpoint
from stabletts_torch.utils.metrics import count, span

logger = logging.getLogger("stabletts_torch.train")


def make_optimizer(model: torch.nn.Module, cfg: TrainConfig) -> torch.optim.AdamW:
    """AdamW as the JAX package's optax.adamw (reference: train.py:60-61):
    b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay 0.01 on every
    parameter; the rate comes from `make_scheduler`."""
    return torch.optim.AdamW(model.parameters(), lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.01)


COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def resolve_compute_dtype(name: str):
    """`TrainConfig.compute_dtype` -> None (f32) or torch.bfloat16."""
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(COMPUTE_DTYPES)}, got {name!r}")
    return COMPUTE_DTYPES[name]


def cast_params(module: torch.nn.Module, dtype) -> dict:
    """{name: parameter cast to `dtype`} for every floating parameter, as a
    differentiable cast: gradients flow back to the f32 parameters."""
    return {name: p.to(dtype) for name, p in module.named_parameters() if p.is_floating_point()}


def model_losses(model, batch, gen, compute_dtype=None, norms=None, **draws):
    """The training forward: (dur, diff, prior, attn). The mels arrive in f32
    or f16 and are widened (or cast to `compute_dtype`) here. `gen`: a
    generator or a `mesh.RowWindow`; `norms`: the global loss denominators
    (`loss_norms`) or None."""
    x, x_lengths, y, y_lengths, z, z_lengths = batch
    if compute_dtype is None:
        return model(x, x_lengths, y.float(), y_lengths, z.float(), z_lengths, gen, norms=norms, **draws)
    draws = {k: v.to(compute_dtype) for k, v in draws.items()}
    args = (x, x_lengths, y.to(compute_dtype), y_lengths, z.to(compute_dtype), z_lengths, gen)
    return torch.func.functional_call(model, cast_params(model, compute_dtype), args, {**draws, "norms": norms})


def loss_norms(mesh: mesh_lib.Mesh, batch) -> tuple:
    """(sum of x_lengths, sum of the mel mask as f32) over the global batch:
    one all-reduce of two integers. The sums are exact, so each equals the
    one-process sum bit for bit."""
    _, x_lengths, y, y_lengths = batch[:4]
    sums = torch.stack([x_lengths.sum(), y_lengths.clamp(max=y.shape[1]).sum()]).to(torch.int64)
    mesh_lib.all_reduce_sum(mesh, sums)
    return sums[0], sums[1].float()


def train_step(model, optimizer, scheduler, batch, gen, compute_dtype=None,
               mesh: Optional[mesh_lib.Mesh] = None, **draws) -> dict:
    """One update. batch = (x, x_lengths, y, y_lengths, z, z_lengths) on the
    model's device (mels in f32, or f16 widened here); `gen` (a generator or
    a `mesh.RowWindow`) draws dropout, the CFG mask, t and the noise
    (`draws` may pass cfg_mask / t_rand / noise explicitly);
    `compute_dtype=torch.bfloat16` runs forward and backward in bf16 against
    the f32 parameters. With a `mesh` in a process group the step is the
    global batch's (module docstring). Returns 0-dim tensors loss, dur_loss,
    diff_loss, prior_loss (the global batch's) and grad_norm (the global L2
    norm of the gradients)."""
    with span("train.step", new_unit=True):
        count("train.steps")
        dp = mesh is not None and mesh.group
        norms = loss_norms(mesh, batch) if dp else None
        optimizer.zero_grad(set_to_none=True)
        with span("train.forward"):
            dur, diff, prior, _ = model_losses(model, batch, gen, compute_dtype, norms, **draws)
            loss = dur + diff + prior
        with span("train.backward"):
            loss.backward()
        with span("train.update"):
            params = [p for group in optimizer.param_groups for p in group["params"]]
            for p in params:
                if p.grad is None:  # optax decays every parameter, with or without a gradient
                    p.grad = torch.zeros_like(p)
            if dp:
                mesh_lib.all_reduce_grads(mesh, params)
                loss, dur, diff, prior = mesh_lib.all_reduce_sum(mesh, torch.stack([loss, dur, diff, prior]).detach())
            grad_norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(p.grad) for p in params]))
            optimizer.step()
            scheduler.step()
    return {"loss": loss.detach(), "dur_loss": dur.detach(), "diff_loss": diff.detach(),
            "prior_loss": prior.detach(), "grad_norm": grad_norm}


@dataclass
class TrainState:
    step: int          # updates taken, counting those before a resume
    start_epoch: int   # the epoch this run started at (0, or the resumed epoch + 1)
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def train(train_cfg: Optional[TrainConfig] = None, model_cfg: Optional[ModelConfig] = None,
          mel_cfg: Optional[MelConfig] = None, log_fn: Callable[[int, dict], None] = None,
          device=None) -> TrainState:
    """Full training entry point (reference: train.py:39-96), on `device`:
    the GPU unless the caller passes "cpu" (cuda:LOCAL_RANK in a process
    group). Resumes from `train_cfg.model_save_path` as
    `train.state.continue_training` says; on rank 0 `log_fn(step, metrics)`
    gets float metrics every `log_interval` steps. In a process group each
    call is one rank of a data-parallel run (module docstring)."""
    from stabletts_torch.data.dataset import StableDataset, collate
    from stabletts_torch.data.prefetch import prefetch
    from stabletts_torch.data.sampler import DistributedBucketSampler

    train_cfg = train_cfg or TrainConfig()
    model_cfg = model_cfg or ModelConfig()
    mel_cfg = mel_cfg or MelConfig()
    mesh = mesh_lib.make_mesh(device)
    device = mesh.device
    compute_dtype = resolve_compute_dtype(train_cfg.compute_dtype)

    dataset = StableDataset(train_cfg.train_dataset_path)
    sampler = DistributedBucketSampler(dataset.lengths, train_cfg.batch_size, list(train_cfg.bucket_boundaries),
                                       num_replicas=mesh.world, rank=mesh.rank)
    steps_per_epoch = len(sampler)
    total_steps = train_cfg.num_epochs * max(steps_per_epoch, 1)

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(train_cfg.seed)
        model = build_stabletts(model_cfg, mel_cfg, device=device)
    model.train()
    optimizer = make_optimizer(model, train_cfg)
    start_epoch = continue_training(train_cfg.model_save_path, model, optimizer)
    mesh_lib.replicate(mesh, model, optimizer)
    scheduler = make_scheduler(optimizer, train_cfg.learning_rate, train_cfg.warmup_steps, total_steps,
                               optimizer_steps(optimizer))
    gen = torch.Generator(device=device)
    step = start_epoch * steps_per_epoch

    for epoch in range(start_epoch, train_cfg.num_epochs):
        sampler.set_epoch(epoch)
        t_start = time.time()
        metrics = {}

        def make_device_batch(work):
            # on loader threads: disk reads, padding, pinned copy and H2D.
            # The z-slice PRNG is seeded per (seed, epoch, item) inside
            # collate, so batches do not depend on worker scheduling.
            _, (bucket, indices) = work
            batch = collate(dataset, indices, sampler.bucket_mel_len(bucket), train_cfg.max_text_len,
                            mel_cfg.n_mels, (train_cfg.seed, epoch))
            tup = batch.as_tuple()
            if train_cfg.transfer_dtype == "float16":
                tup = tuple(a.astype(np.float16) if a.dtype == np.float32 else a for a in tup)
            return tuple(_to_device(a, device) for a in tup)

        if train_cfg.loader_workers > 0:
            batches = prefetch(enumerate(sampler), make_device_batch, n_workers=train_cfg.loader_workers,
                               depth=train_cfg.prefetch_depth)
        else:
            batches = map(make_device_batch, enumerate(sampler))
        for batch_idx, batch in enumerate(batches):
            # the step's random streams depend on (seed, step) only, so a
            # resumed run draws what an uninterrupted one would
            # every rank seeds alike and keeps its own rows of the global batch's draws
            gen.manual_seed((train_cfg.seed + 1) * 2 ** 32 + step)
            rows = mesh_lib.window(gen, mesh_lib.shard_batch(mesh, batch[0].shape[0]))
            metrics = train_step(model, optimizer, scheduler, batch, rows, compute_dtype, mesh)
            if mesh.rank == 0 and log_fn is not None and batch_idx % train_cfg.log_interval == 0:
                log_fn(step, {k: float(v) for k, v in metrics.items()})
            step += 1

        if epoch % train_cfg.save_interval == 0:
            if mesh.rank == 0:
                save_checkpoint(train_cfg.model_save_path, epoch, model, optimizer)
            mesh_lib.barrier(mesh)  # every rank resumes from the same files
        if metrics:
            logger.info("rank %d epoch %d loss %.4f (%.1fs)", mesh.rank, epoch, float(metrics["loss"]),
                        time.time() - t_start)
    return TrainState(step, start_epoch, model, optimizer, scheduler)
