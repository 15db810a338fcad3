"""StableTTS top model: style encoder, text encoder, duration predictor and
the flow-matching decoder, with the training forward (MAS alignment, CFG
dropout, the duration, diffusion and prior losses)
(reference: models/model.py:30-178)."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from stabletts_torch.models.duration_predictor import DurationPredictor, duration_loss
from stabletts_torch.models.flow_matching import CFMDecoder
from stabletts_torch.models.reference_encoder import MelStyleEncoder
from stabletts_torch.models.text_encoder import TextEncoder
from stabletts_torch.ops.mas_cuda import mas
from stabletts_torch.ops.mask import sequence_mask
from stabletts_torch.parallel.mesh import rows_rand
from stabletts_torch.utils.device import resolve_device
from stabletts_torch.utils.metrics import span


def generate_path(duration: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """duration [B, Tx] (possibly fractional), mask [B, Tx, Ty] -> hard
    monotonic alignment path [B, Tx, Ty] (reference: models/model.py:17-27)."""
    t_y = mask.shape[2]
    cum = torch.cumsum(duration, dim=1)
    pos = torch.arange(t_y, dtype=cum.dtype, device=cum.device)
    path = (pos[None, None, :] < cum[:, :, None]).to(mask.dtype)
    path = path - F.pad(path, (0, 0, 1, 0))[:, :-1]
    return path * mask


class StableTTS(nn.Module):
    def __init__(self, n_vocab: int, mel_channels: int, hidden_channels: int = 256,
                 filter_channels: int = 1024, n_heads: int = 4, n_enc_layers: int = 3,
                 n_dec_layers: int = 6, kernel_size: int = 3, gin_channels: int = 256,
                 p_dropout: float = 0.1, cfg_dropout: float = 0.2, remat: bool = False, device=None):
        super().__init__()
        self.mel_channels = mel_channels
        self.gin_channels = gin_channels
        self.cfg_dropout = cfg_dropout
        self.encoder = TextEncoder(n_vocab, mel_channels, hidden_channels, filter_channels,
                                   n_heads, n_enc_layers, kernel_size, gin_channels, p_dropout)
        self.ref_encoder = MelStyleEncoder(n_mel_channels=mel_channels, style_vector_dim=gin_channels,
                                           style_kernel_size=5, dropout=0.25)
        self.dp = DurationPredictor(hidden_channels, filter_channels, kernel_size, gin_channels, 0.5)
        self.decoder = CFMDecoder(mel_channels, mel_channels, hidden_channels, mel_channels,
                                  filter_channels, n_heads, n_dec_layers, kernel_size, gin_channels, p_dropout,
                                  remat=remat)
        # learned unconditional embeddings for CFG (reference layouts)
        self.fake_speaker = nn.Parameter(torch.zeros(1, gin_channels))
        self.fake_content = nn.Parameter(torch.zeros(1, mel_channels, 1))
        self.to(resolve_device(device))
        self.eval()

    def prepare_synthesis(self, x, x_lengths, y_ref, max_mel_len: int, length_scale: float = 1.0,
                          y_ref_mask=None, clip_len: Optional[int] = None) -> dict:
        """Text ids [B, Tx] + reference mel [B, Tref, n_mels] -> aligned
        encoder output mu_y [B, max_mel_len, n_mels], style vector, masks and
        the (clipped) lengths."""
        c = self.ref_encoder(y_ref, y_ref_mask)
        with span("text_encoder"):
            h, mu_x, x_mask = self.encoder(x, c, x_lengths)
        with span("duration_predictor"):
            logw = self.dp(h, x_mask, c)  # [B, Tx, 1]

        # durations and frame positions stay f32 under bf16: above frame 512
        # bf16's ulp is 4 and would merge consecutive frame positions
        w = torch.exp(logw.float()) * x_mask[..., None].float()
        w_ceil = torch.ceil(w) * length_scale
        raw_lengths = w_ceil.sum(dim=(1, 2))
        cap = clip_len or max_mel_len
        y_lengths = raw_lengths.clamp(1, cap).to(torch.int32)
        y_clamped = raw_lengths > cap

        y_mask = sequence_mask(y_lengths, max_mel_len, dtype=x_mask.dtype)
        attn_mask = (x_mask[:, :, None] * y_mask[:, None, :]).float()
        attn = generate_path(w_ceil[..., 0], attn_mask)
        mu_y = torch.einsum("bxy,bxc->byc", attn.to(mu_x.dtype), mu_x)
        return {"mu_y": mu_y, "c": c, "y_mask": y_mask, "y_lengths": y_lengths,
                "y_clamped": y_clamped, "attn": attn}

    # ---- the sampler's interface (models/sampler.py: `sample`)
    frame_quantum = 256  # the multiple of frames `prepare` computes at, and a length group's

    def flow_condition(self, prep: dict, cfg: float) -> dict:
        """The mu prenet over mu_y, and under CFG (cfg != 1) over the
        unconditional content: once a synthesis, at the model's frames."""
        mu_y = prep["mu_y"]
        fake = None
        h_mu = self.precompute_mu(mu_y)
        if cfg != 1.0:
            fake = self.precompute_fake_mu(mu_y.shape[0], mu_y.shape[1], prep["cap"])
        return {"h_mu": h_mu, "fake_h_mu": fake, "c": prep["c"], "y_mask": prep["y_mask"]}

    def flow_rows(self, cond: dict, rows, frames: int) -> dict:
        """`flow_condition`'s output for the items `rows` (an index tensor)
        over their first `frames` frames."""
        cut = lambda a: None if a is None else a[rows, :frames]
        return {"h_mu": cut(cond["h_mu"]), "fake_h_mu": cut(cond["fake_h_mu"]), "c": cond["c"][rows],
                "y_mask": cut(cond["y_mask"])}

    def time_grid(self, n_steps: int, device) -> torch.Tensor:
        return torch.linspace(0.0, 1.0, n_steps + 1, dtype=torch.float32, device=device)

    def flow_velocity(self, cond: dict, t, xt, cfg: float):
        tb = t.expand(xt.shape[0]).to(xt.dtype)
        if cond["fake_h_mu"] is not None:
            return self.cfg_velocity(tb, xt, cond["y_mask"], cond["h_mu"], cond["c"], cfg, cond["fake_h_mu"], True)
        return self.velocity(tb, xt, cond["y_mask"], cond["h_mu"], cond["c"], True)

    def flow_output(self, prep: dict, mel) -> dict:
        n = prep["cap"]
        return {
            "encoder_outputs": prep["mu_y"][:, :n].float(),
            "decoder_outputs": mel[:, :n].float(),
            "attn": prep["attn"][:, :, :n].float(),
            "y_lengths": prep["y_lengths"],
            "y_clamped": prep["y_clamped"],
            "y_mask": prep["y_mask"][:, :n].float(),
        }

    def velocity(self, t, xt, y_mask, mu, c, mu_is_precomputed: bool = False):
        return self.decoder(t, xt, y_mask, mu, c, mu_is_precomputed)

    def precompute_mu(self, mu):
        return self.decoder.estimator.precompute_mu(mu)

    def precompute_fake_mu(self, b: int, t_len: int, valid_len: Optional[int] = None):
        """Prenet over the unconditional content embedding. Frames past
        valid_len are zeroed so the unmasked prenet convs see the boundary an
        unpadded run sees."""
        fake_mu = self.fake_content[:, :, 0][:, None, :].expand(b, t_len, self.mel_channels)
        if valid_len is not None and valid_len < t_len:
            keep = (torch.arange(t_len, device=fake_mu.device) < valid_len).to(fake_mu.dtype)
            fake_mu = fake_mu * keep[None, :, None]
        return self.precompute_mu(fake_mu)

    def cfg_velocity(self, t, xt, y_mask, mu, c, cfg_strength: float, fake_mu=None,
                     mu_is_precomputed: bool = False):
        """uncond + s * (cond - uncond), both branches in one [2B] call."""
        b, t_len = mu.shape[0], mu.shape[1]
        fake_c = self.fake_speaker.expand(b, self.gin_channels)
        if fake_mu is None:
            if mu_is_precomputed:
                raise ValueError(
                    "cfg_velocity: mu is precomputed but fake_mu is None; pass "
                    "precompute_fake_mu(...) output for the unconditional branch"
                )
            fake_mu = self.fake_content[:, :, 0][:, None, :].expand(b, t_len, self.mel_channels)
        cat = lambda a, b_: torch.cat([a, b_], dim=0)
        out = self.decoder(cat(t, t), cat(xt, xt), cat(y_mask, y_mask), cat(mu, fake_mu),
                           cat(c, fake_c), mu_is_precomputed)
        cond, uncond = out[:b], out[b:]
        return uncond + cfg_strength * (cond - uncond)

    def forward(self, x, x_lengths, y, y_lengths, z, z_lengths, gen=None, cfg_mask=None, t_rand=None, noise=None,
                norms=None):
        """Training forward: returns (dur_loss, diff_loss, prior_loss, attn
        [B, Ty, Tx]) (reference: models/model.py:114-178).

        x [B, Tx] ids; y [B, Ty, n_mels] target mel; z [B, Tz, n_mels] sliced
        reference mel. `gen` (a torch.Generator on the model's device, or a
        `parallel.mesh.RowWindow` over it) draws every dropout and whichever
        of cfg_mask [B, 1] (1 = conditional), t_rand [B] and noise (like y) is
        not passed; gen=None turns dropout off, and then the three draws must
        be passed. `norms` = (sum of x_lengths, sum of the mel mask) over the
        global batch of a data-parallel step: the losses' denominators, so
        each rank's loss is its share of the global loss (None: this batch's
        own sums)."""
        b = y.shape[0]
        if gen is None and (cfg_mask is None or t_rand is None or noise is None):
            raise ValueError("StableTTS.forward: without a generator, pass cfg_mask, t_rand and noise")
        y_mask = sequence_mask(y_lengths, y.shape[1], dtype=y.dtype)
        z_mask = sequence_mask(z_lengths, z.shape[1], dtype=z.dtype)
        if cfg_mask is None:
            cfg_mask = (rows_rand(gen, (b, 1), y.device) > self.cfg_dropout).to(y.dtype)
        if t_rand is None:
            t_rand = rows_rand(gen, (b,), y.device, y.dtype)
        if noise is None:
            noise = rows_rand(gen, y.shape, y.device, y.dtype, normal=True)
        text_total, mel_total = (None, None) if norms is None else norms

        # one CFG mask for speaker and content
        c = self.ref_encoder(z, z_mask, gen)
        c = c * cfg_mask + (1 - cfg_mask) * self.fake_speaker
        h, mu_x, x_mask = self.encoder(x, c, x_lengths, gen)
        logw = self.dp(h, x_mask, c, gen)  # [B, Tx, 1]

        # MAS target: Gaussian log-likelihood of each (mel, text) pair with unit
        # variance; the product is left to torch.matmul as the JAX package
        # leaves it to XLA
        with torch.no_grad():
            neg_cent = (-0.5 * math.log(2 * math.pi) * self.mel_channels
                        - 0.5 * (y ** 2).sum(-1, keepdim=True)
                        + torch.matmul(y, mu_x.transpose(1, 2))
                        - 0.5 * (mu_x ** 2).sum(-1)[:, None, :])
            attn = mas(neg_cent, y_mask[:, :, None] * x_mask[:, None, :]).to(y.dtype)

        logw_ = torch.log(1e-8 + attn.sum(dim=1))[..., None] * x_mask[..., None]
        dur = duration_loss(logw, logw_, x_lengths, text_total)

        mu_y = torch.matmul(attn, mu_x)  # [B, Ty, n_mels]
        cfg3 = cfg_mask[..., None]
        mu_y_masked = mu_y * cfg3 + (1 - cfg3) * self.fake_content[:, :, 0][:, None, :]
        diff, _ = self.decoder.compute_loss(y, y_mask, mu_y_masked, c, t_rand, noise, gen, mel_total)

        resid = (y - mu_y).float()
        prior = (0.5 * (resid ** 2 + math.log(2 * math.pi)) * y_mask[..., None].float()).sum()
        prior = prior / ((y_mask.float().sum() if mel_total is None else mel_total) * self.mel_channels)
        return dur, diff, prior, attn
