"""Synthesis pipeline: text -> mel via the flow-matching ODE
(reference: models/model.py:48-112).

`synthesise` is `prepare` (the text side and the durations at a mel cap)
then `sample` (the flow), so a caller that settles its cap from the predicted
lengths (the API's regrow) runs the flow once. The estimator's t-independent
mu prenet runs once per synthesis, and CFG runs the conditional and
unconditional branches as one [2B] batch.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
import torch.nn.functional as F

from stabletts_torch.models.stabletts import StableTTS
from stabletts_torch.ops.ode import ADAPTIVE_SOLVERS, odeint
from stabletts_torch.utils.device import resolve_device
from stabletts_torch.utils.metrics import count, span


def _as_tensor(a, device, dtype=None):
    if a is None:
        return None
    t = torch.as_tensor(np.asarray(a)) if not isinstance(a, torch.Tensor) else a
    return t.to(device=device, dtype=dtype or t.dtype)


def cast_model(model: StableTTS, dtype: torch.dtype) -> StableTTS:
    """The model with float parameters in `dtype` (a copy unless it already is)."""
    if next(model.parameters()).dtype == dtype:
        return model
    return copy.deepcopy(model).to(dtype)


def _on_device(model: StableTTS, device, compute_dtype) -> tuple:
    """(the model in compute_dtype, the resolved device), or raises when the
    model's parameters are on another kind of device."""
    device = resolve_device(device)
    if next(model.parameters()).device.type != device.type:
        raise ValueError(f"model is on {next(model.parameters()).device}, synthesise asked for {device}")
    return (model if compute_dtype is None else cast_model(model, compute_dtype)), device


@torch.no_grad()
def synthesise(model: StableTTS, x, x_lengths, noise, y_ref, n_timesteps: int = 10,
               temperature: float = 1.0, length_scale: float = 1.0, solver: str = "euler",
               cfg: float = 1.0, max_mel_len: int = 1000, compute_dtype=None, y_ref_mask=None,
               device=None) -> dict:
    """x [B, Tx] phoneme ids; noise [B, max_mel_len, n_mels] standard normal;
    y_ref [B, Tref, n_mels] reference mel. Returns decoder_outputs
    [B, max_mel_len, n_mels] (float32), y_lengths and y_clamped.

    Runs on `device` (the GPU unless the caller passes "cpu"), where the
    model's parameters must already be. compute_dtype=torch.bfloat16 runs the
    network in bf16 (on a bf16 copy of the model, unless it is one).
    `prepare`, then `sample`."""
    model, device = _on_device(model, device, compute_dtype)
    prep = prepare(model, x, x_lengths, y_ref, max_mel_len, length_scale, compute_dtype, y_ref_mask, device)
    return sample(model, prep, noise, n_timesteps, temperature, solver, cfg, compute_dtype, device)


@torch.no_grad()
def prepare(model: StableTTS, x, x_lengths, y_ref, max_mel_len: int = 1000, length_scale: float = 1.0,
            compute_dtype=None, y_ref_mask=None, device=None) -> dict:
    """The flow's conditioning at the mel cap max_mel_len (arguments as
    `synthesise`'s): `prepare_synthesis`'s dict plus "cap", with the lengths
    clipped at the cap. Its y_clamped is final here: the durations do not
    depend on the cap, so a caller can settle the cap before any ODE runs."""
    model, device = _on_device(model, device, compute_dtype)
    x = _as_tensor(x, device, torch.long)
    x_lengths = _as_tensor(x_lengths, device, torch.long)
    y_ref = _as_tensor(y_ref, device, torch.float32)
    y_ref_mask = _as_tensor(y_ref_mask, device, torch.float32)
    if compute_dtype is not None:
        y_ref = y_ref.to(compute_dtype)
        if y_ref_mask is not None:
            y_ref_mask = y_ref_mask.to(compute_dtype)
    # compute at a multiple of 256 frames and trim back: every conv and
    # attention boundary masks by y_mask, so the extra frames are inert
    with span("sampler.prepare"):
        prep = model.prepare_synthesis(x, x_lengths, y_ref, -(-max_mel_len // 256) * 256, length_scale,
                                       y_ref_mask, max_mel_len)
    prep["cap"] = max_mel_len
    return prep


@torch.no_grad()
def sample(model: StableTTS, prep: dict, noise, n_timesteps: int = 10, temperature: float = 1.0,
           solver: str = "euler", cfg: float = 1.0, compute_dtype=None, device=None) -> dict:
    """The flow from `prepare`'s output: the mu prenet, then the ODE from
    noise [B, prep["cap"], n_mels]. Returns `synthesise`'s dict."""
    model, device = _on_device(model, device, compute_dtype)
    noise = _as_tensor(noise, device, torch.float32)
    if compute_dtype is not None:
        noise = noise.to(compute_dtype)
    mu_y, c, y_mask = prep["mu_y"], prep["c"], prep["y_mask"]
    requested_len, max_mel_len = prep["cap"], mu_y.shape[1]
    if max_mel_len != requested_len:
        noise = F.pad(noise, (0, 0, 0, max_mel_len - requested_len))
    # each item's frames (clipped at the requested length), and the rows times the frames the estimator runs
    count("sampler.frames_valid", prep["y_lengths"])
    count("sampler.frames_computed", noise.shape[0] * max_mel_len)
    h_mu = model.precompute_mu(mu_y)
    cfg_on = cfg != 1.0
    if cfg_on:
        fake_h_mu = model.precompute_fake_mu(mu_y.shape[0], mu_y.shape[1], requested_len)

    def f(t, xt):
        tb = t.expand(xt.shape[0]).to(xt.dtype)
        if cfg_on:
            return model.cfg_velocity(tb, xt, y_mask, h_mu, c, cfg, fake_h_mu, True)
        return model.velocity(tb, xt, y_mask, h_mu, c, True)

    t_span = torch.linspace(0.0, 1.0, n_timesteps + 1, dtype=torch.float32, device=device).to(noise.dtype)
    ode_kwargs = {}
    if solver in ADAPTIVE_SOLVERS:
        # the adaptive error norm covers the requested frames only: the frames
        # added for the 256 multiple have zero velocity and would deflate it
        frame_valid = (torch.arange(max_mel_len, device=device) < requested_len)[None, :, None]
        ode_kwargs = dict(err_weight=frame_valid, err_count=noise.shape[0] * requested_len * noise.shape[2])
    with span("sampler.ode"):
        mel = odeint(f, noise * temperature, t_span, method=solver, **ode_kwargs)
    return {
        "encoder_outputs": mu_y[:, :requested_len].float(),
        "decoder_outputs": mel[:, :requested_len].float(),
        "attn": prep["attn"][:, :, :requested_len].float(),
        "y_lengths": prep["y_lengths"],
        "y_clamped": prep["y_clamped"],
        "y_mask": y_mask[:, :requested_len].float(),
    }
