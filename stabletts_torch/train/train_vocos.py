"""Vocos GAN training on one GPU: the discriminator step, then the generator
step (reference: vocoders/vocos/train.py:43-165).

As in the JAX package's step:
  * the generator's forward runs once per step: its output, detached, feeds
    the discriminator step, and the generator step backpropagates through
    the same graph;
  * mel extraction (the input mel and the 7-scale mel loss) runs on the
    device inside the step, not in the loader;
  * weight norm is folded into the discriminators' kernels once per loss
    evaluation and the folded kernels feed every application; in the
    generator step they are constants (no weight-norm backward there);
  * MPD and MRD gradients are clipped separately at `grad_clip`, the
    generator's by its global norm; AdamW (weight decay 0.01) with the
    cosine-warmup schedule;
  * `compute_dtype=torch.bfloat16` casts the f32 master parameters, the
    input mel and the real audio to bf16 (a differentiable cast, not
    `torch.autocast`). The generator runs in bf16 up to its ISTFT, which
    returns f32; the discriminators see that f32 fake beside bf16 real
    audio and bf16-folded kernels, and each conv runs in the wider of its
    operands' types, so the MPD's real branch runs in bf16 and its fake
    branch and the whole MRD (its STFT gives f32) in f32, as the JAX step's
    type promotion has it. The mel-loss STFTs, the loss reductions, the
    gradients and the optimizers stay f32.

`ops.mpd_cuda.mpd_stack`, the port of the TPU kernel mpd_stack_fused, is an
entry point beside `DiscriminatorP` and has no gradient in either package:
the step does not call it.

Data parallelism (`parallel/mesh.py`), as the JAX package's `train_vocos`:
in a process group each rank takes `order[rank::W]` of every epoch's
permutation and the same number of steps, crops its clips from the seed
(seed, epoch, rank, batch), and averages each optimizer's gradients over the
ranks before the clips: every GAN loss is a mean over equal-sized shards, so
the mean of the ranks' gradients is the global batch's. Rank 0 writes the
checkpoints and calls `log_fn` with the metrics averaged over the ranks.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from stabletts_torch.config import MelConfig, VocosConfig, VocosTrainConfig
from stabletts_torch.models.discriminators import MultiPeriodDiscriminator, MultiResolutionDiscriminator
from stabletts_torch.models.gan_losses import (
    discriminator_loss,
    feature_loss,
    generator_loss,
    multi_scale_mel_configs,
    multi_scale_mel_loss,
)
from stabletts_torch.models.vocos import Vocos
from stabletts_torch.ops.stft import log_mel_spectrogram
from stabletts_torch.parallel import mesh as mesh_lib
from stabletts_torch.train.scheduler import make_scheduler
from stabletts_torch.train.state import continue_training_vocos, optimizer_steps, save_checkpoint_named
from stabletts_torch.train.train_tts import _to_device, cast_params, resolve_compute_dtype
from stabletts_torch.utils.device import resolve_device

logger = logging.getLogger("stabletts_torch.train")


@dataclass
class VocosTrainState:
    step: int          # updates taken, counting those before a resume
    start_epoch: int   # the epoch this run started at (0, or the resumed epoch + 1)
    gen: Vocos
    mpd: MultiPeriodDiscriminator
    mrd: MultiResolutionDiscriminator
    opt_g: torch.optim.Optimizer
    opt_d: torch.optim.Optimizer
    sched_g: torch.optim.lr_scheduler.LambdaLR
    sched_d: torch.optim.lr_scheduler.LambdaLR

    def parts(self) -> dict:
        """The five checkpoint parts under the reference's names."""
        return {"generator": self.gen, "mpd": self.mpd, "mrd": self.mrd, "optimizerg": self.opt_g,
                "optimizerd": self.opt_d}


def make_gan_optimizer(params, cfg: VocosTrainConfig, total_steps: int, start_step: int = 0):
    """(AdamW, its cosine-warmup LambdaLR) (reference: train.py:73-77).
    weight_decay 0.01 is torch.optim.AdamW's default, which the reference
    uses implicitly; the clip is applied in the step (the generator's global
    norm, MPD and MRD separately: train.py:108-109)."""
    opt = torch.optim.AdamW(list(params), lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
    return opt, make_scheduler(opt, cfg.learning_rate, cfg.warmup_steps, total_steps, start_step)


def _clip_by_norm(params, max_norm: float) -> torch.Tensor:
    """Scale the gradients by min(1, max_norm / norm) (optax's
    clip_by_global_norm); returns the global L2 norm before the clip. The
    per-tensor norms and the scaling are one multi-tensor call each: the
    discriminators have over 300 parameter tensors."""
    grads = [p.grad for p in params]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, max_norm / torch.clamp(norm, min=max_norm))
    return norm


def _fill_missing_grads(params) -> None:
    for p in params:
        if p.grad is None:  # optax decays every parameter, with or without a gradient
            p.grad = torch.zeros_like(p)


def vocos_train_step(state: VocosTrainState, audio: torch.Tensor, mel_cfg: MelConfig, mel_loss_coeff: float,
                     grad_clip: float = 1000.0, compute_dtype=None, mesh: Optional[mesh_lib.Mesh] = None) -> dict:
    """One GAN update on audio [B, segment_size] (f32, on the models'
    device): the discriminator step first, then the generator step against
    the updated discriminators (reference: train.py:95-132). With a `mesh`
    in a process group, `audio` is this rank's shard and each optimizer's
    gradients are averaged over the ranks before the clips. Returns the JAX
    step's metrics as 0-dim f32 tensors (this rank's losses; the norms after
    the reduction)."""
    gen, mpd, mrd = state.gen, state.mpd, state.mrd
    ms_cfgs = multi_scale_mel_configs(mel_cfg)
    cast = (lambda a: a) if compute_dtype is None else (lambda a: a.to(compute_dtype))
    with torch.no_grad():
        mels_c = cast(log_mel_spectrogram(audio, mel_cfg))
    audio_c = cast(audio)

    if compute_dtype is None:
        fake = gen(mels_c)
    else:
        fake = torch.func.functional_call(gen, cast_params(gen, compute_dtype), (mels_c,))
    # the ISTFT returns f32 whatever the compute dtype, and the discriminators get the fake as it is
    fake_sg = fake.detach()

    # ---- discriminator step ----
    state.opt_d.zero_grad(set_to_none=True)
    rf, gf, _, _ = mpd(audio_c, fake_sg, mpd.fold(compute_dtype))
    loss_disc_f = discriminator_loss(rf, gf)[0]
    rs, gs, _, _ = mrd(audio_c, fake_sg, mrd.fold(compute_dtype))
    loss_disc_s = discriminator_loss(rs, gs)[0]
    (loss_disc_f + loss_disc_s).backward()
    p_mpd, p_mrd = list(mpd.parameters()), list(mrd.parameters())
    _fill_missing_grads(p_mpd + p_mrd)
    if mesh is not None:
        mesh_lib.all_reduce_grads(mesh, p_mpd + p_mrd, average=True)
    grad_norm_mpd = _clip_by_norm(p_mpd, grad_clip)
    grad_norm_mrd = _clip_by_norm(p_mrd, grad_clip)
    state.opt_d.step()
    state.sched_d.step()

    # ---- generator step, against the updated discriminators ----
    # folded outside the graph: the generator step differentiates with respect
    # to the fake audio only, so the folded kernels are constants
    with torch.no_grad():
        f_mpd, f_mrd = mpd.fold(compute_dtype), mrd.fold(compute_dtype)
    state.opt_g.zero_grad(set_to_none=True)
    # mel L1 in f32 whatever the compute dtype (the log of a clamp at 1e-5 underflows bf16's mantissa)
    loss_mel = multi_scale_mel_loss(audio, fake, ms_cfgs) * mel_loss_coeff
    _, gf, fr, fg = mpd(audio_c, fake, f_mpd)
    loss_fm_f = feature_loss(fr, fg)
    loss_gen_f = generator_loss(gf)[0]
    _, gs, sr, sg = mrd(audio_c, fake, f_mrd)
    loss_fm_s = feature_loss(sr, sg)
    loss_gen_s = generator_loss(gs)[0]
    loss_g = loss_gen_s + loss_gen_f + loss_fm_s + loss_fm_f + loss_mel
    loss_g.backward()
    p_g = list(gen.parameters())
    _fill_missing_grads(p_g)
    if mesh is not None:
        mesh_lib.all_reduce_grads(mesh, p_g, average=True)
    grad_norm_g = _clip_by_norm(p_g, grad_clip)
    state.opt_g.step()
    state.sched_g.step()
    state.step += 1

    d = lambda v: v.detach().float()
    return {"gen_loss_total": d(loss_g), "disc_loss_mpd": d(loss_disc_f), "disc_loss_mrd": d(loss_disc_s),
            "grad_norm_g": d(grad_norm_g), "grad_norm_mpd": d(grad_norm_mpd), "grad_norm_mrd": d(grad_norm_mrd),
            "mel_loss": d(loss_mel), "fm_loss_mpd": d(loss_fm_f), "gen_loss_mpd": d(loss_gen_f),
            "fm_loss_mrd": d(loss_fm_s), "gen_loss_mrd": d(loss_gen_s)}


def init_vocos_training(vocos_cfg: VocosConfig, mel_cfg: MelConfig, train_cfg: VocosTrainConfig, total_steps: int,
                        seed: int = 0, device=None) -> VocosTrainState:
    """The generator and both discriminators (random weights from `seed`, in
    train mode, on `device`: the GPU unless the caller passes "cpu") with
    their optimizers and schedules."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        gen = Vocos(vocos_cfg, mel_cfg, device=device)
        mpd = MultiPeriodDiscriminator().to(device)
        mrd = MultiResolutionDiscriminator().to(device)
    for m in (gen, mpd, mrd):
        m.train()
    opt_g, sched_g = make_gan_optimizer(gen.parameters(), train_cfg, total_steps)
    opt_d, sched_d = make_gan_optimizer([*mpd.parameters(), *mrd.parameters()], train_cfg, total_steps)
    return VocosTrainState(0, 0, gen, mpd, mrd, opt_g, opt_d, sched_g, sched_d)


def train_vocos(train_cfg: Optional[VocosTrainConfig] = None, vocos_cfg: Optional[VocosConfig] = None,
                mel_cfg: Optional[MelConfig] = None, num_epochs: Optional[int] = None,
                log_fn: Callable[[int, dict], None] = None, device=None) -> VocosTrainState:
    """Full GAN training entry point (reference: vocoders/vocos/train.py:43-165),
    on `device`: the GPU unless the caller passes "cpu" (cuda:LOCAL_RANK in a
    process group). Resumes from `train_cfg.model_save_path` as
    `train.state.continue_training_vocos` says; on rank 0 `log_fn(step,
    metrics)` gets float metrics every `log_interval` steps. In a process
    group each call is one rank of a data-parallel run (module docstring)."""
    from stabletts_torch.data.prefetch import prefetch
    from stabletts_torch.data.vocos_dataset import VocosDataset

    train_cfg = train_cfg or VocosTrainConfig()
    vocos_cfg = vocos_cfg or VocosConfig()
    mel_cfg = mel_cfg or MelConfig()
    if vocos_cfg.input_channels != mel_cfg.n_mels:
        raise ValueError("input_channels and n_mels must be equal.")
    mesh = mesh_lib.make_mesh(device)
    device = mesh.device
    compute_dtype = resolve_compute_dtype(train_cfg.compute_dtype)

    dataset = VocosDataset(train_cfg.train_dataset_path, train_cfg.segment_size, mel_cfg.sample_rate)
    n_epochs = num_epochs or train_cfg.num_epochs
    # the same on every rank (each rank's slice of the order holds at least
    # per_rank clips), so every rank takes the same collective steps
    steps_per_epoch = len(dataset) // mesh.world // train_cfg.batch_size
    if steps_per_epoch == 0:
        raise ValueError(f"dataset ({len(dataset)} clips) is smaller than one global batch ({mesh.world} ranks x "
                         f"batch_size {train_cfg.batch_size})")
    total_steps = n_epochs * steps_per_epoch

    state = init_vocos_training(vocos_cfg, mel_cfg, train_cfg, total_steps, train_cfg.seed, device)
    state.start_epoch = continue_training_vocos(train_cfg.model_save_path, state.parts())
    mesh_lib.replicate(mesh, state.gen, state.mpd, state.mrd, state.opt_g, state.opt_d)
    # the schedules go on from the optimizers' own update counts
    for opt, name in ((state.opt_g, "sched_g"), (state.opt_d, "sched_d")):
        setattr(state, name, make_scheduler(opt, train_cfg.learning_rate, train_cfg.warmup_steps, total_steps,
                                            optimizer_steps(opt)))
    state.step = state.start_epoch * steps_per_epoch

    for epoch in range(state.start_epoch, n_epochs):
        order = np.random.default_rng(epoch).permutation(len(dataset))[mesh.rank::mesh.world]
        t0 = time.time()
        metrics = {}

        def make_device_batch(b):
            # on loader threads: wav decode, crop, pinned copy and H2D. Crop
            # offsets are seeded per (seed, epoch, rank, batch), so results
            # do not depend on worker scheduling
            idx = order[b * train_cfg.batch_size : (b + 1) * train_cfg.batch_size]
            rng = np.random.default_rng(np.random.SeedSequence([train_cfg.seed, epoch, mesh.rank, b]))
            return _to_device(dataset.batch(idx, rng), device)

        steps = range(steps_per_epoch)  # always full batches
        if train_cfg.loader_workers > 0:
            batches = prefetch(steps, make_device_batch, n_workers=train_cfg.loader_workers,
                               depth=train_cfg.prefetch_depth)
        else:
            batches = map(make_device_batch, steps)
        for b, audio in enumerate(batches):
            metrics = vocos_train_step(state, audio, mel_cfg, train_cfg.mel_loss_coeff, train_cfg.grad_clip,
                                       compute_dtype, mesh)
            if b % train_cfg.log_interval == 0:
                if mesh.group:  # every rank takes part; the norms are taken after the reduction already
                    losses = [k for k in metrics if not k.startswith("grad_norm")]
                    avg = mesh_lib.all_reduce_sum(mesh, torch.stack([metrics[k] for k in losses])) / mesh.world
                    metrics.update(zip(losses, avg))
                if mesh.rank == 0 and log_fn is not None:
                    log_fn(epoch * steps_per_epoch + b, {k: float(v) for k, v in metrics.items()})
        if epoch % train_cfg.save_interval == 0:
            if mesh.rank == 0:
                save_checkpoint_named(train_cfg.model_save_path, epoch,
                                      {name: part.state_dict() for name, part in state.parts().items()})
            mesh_lib.barrier(mesh)  # every rank resumes from the same files
        if metrics:
            logger.info("epoch %d gen_loss %.4f (%.1fs)", epoch, float(metrics["gen_loss_total"]), time.time() - t0)
    return state
