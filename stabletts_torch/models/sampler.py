"""Synthesis pipeline: text -> mel via the flow-matching ODE
(reference: models/model.py:48-112).

`synthesise` is `prepare` (the text side and the durations at a mel cap)
then `sample` (the flow), so a caller that settles its cap from the predicted
lengths (the API's regrow) runs the flow once. Both run any acoustic model
that has the methods they call: `prepare_synthesis` (the conditioning and
the lengths), `flow_condition` (what every ODE step shares), `flow_rows` (its
part for one length group), `time_grid`, `flow_velocity` (CFG's branches as
one packed batch) and `flow_output`, with `frame_quantum` for the length
groups.
StableTTS (`models/stabletts.py`): durations from its predictor, the mu
prenet once per synthesis, a linear grid, uncond + s (cond - uncond).
F5-TTS (`models/f5tts.py`): the byte-ratio rule's durations, the prompt's
mel kept as a condition, the text embedded once a `prepare`, the sway grid,
v + s (v - v_null), and the generated frames alone returned.

`sample` runs the flow in length groups: it reads the items' lengths on the
host, sorts the items by them and runs one ODE pass per group of the sorted
items at that group's longest length plus one frame, rounded up to the
model's `frame_quantum`, so the estimator skips most of the frames that no
item owns. `length_groups` picks the partition with the fewest frames,
counting a fixed number of frames for each group's launches. The estimator
reads nothing past the frame after an item's last (its convs and attention
mask by the item's frames, but for one long-skip conv), so an item's valid
frames do not depend on its group.
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
               device=None, x_ref_lengths=None) -> dict:
    """x [B, Tx] phoneme ids; noise [B, max_mel_len, n_mels] standard normal;
    y_ref [B, Tref, n_mels] reference mel. Returns decoder_outputs
    [B, max_mel_len, n_mels] (float32), y_lengths and y_clamped.

    F5-TTS (`models/f5tts.py`): x holds the prompt's text then the text to
    speak, x_ref_lengths the ids of the prompt's text, y_ref the prompt's
    mel with its frames marked by y_ref_mask, max_mel_len the cap on the
    total frames; noise covers at least the longest total (the first frames
    of each row are used); decoder_outputs are the generated frames
    [B, longest generation, n_mels] and y_lengths their counts.

    Runs on `device` (the GPU unless the caller passes "cpu"), where the
    model's parameters must already be. compute_dtype=torch.bfloat16 runs the
    network in bf16 (on a bf16 copy of the model, unless it is one).
    `prepare`, then `sample`."""
    model, device = _on_device(model, device, compute_dtype)
    prep = prepare(model, x, x_lengths, y_ref, max_mel_len, length_scale, compute_dtype, y_ref_mask, device,
                   x_ref_lengths)
    return sample(model, prep, noise, n_timesteps, temperature, solver, cfg, compute_dtype, device)


@torch.no_grad()
def prepare(model: StableTTS, x, x_lengths, y_ref, max_mel_len: int = 1000, length_scale: float = 1.0,
            compute_dtype=None, y_ref_mask=None, device=None, x_ref_lengths=None) -> dict:
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
    extra = {} if x_ref_lengths is None else {"x_ref_lengths": _as_tensor(x_ref_lengths, device, torch.long)}
    # compute at a multiple of the model's frame quantum and trim back: every
    # conv and attention boundary masks by y_mask, so the extra frames are inert
    q = model.frame_quantum
    with span("sampler.prepare"):
        prep = model.prepare_synthesis(x, x_lengths, y_ref, -(-max_mel_len // q) * q, length_scale,
                                       y_ref_mask, max_mel_len, **extra)
    prep["cap"] = max_mel_len
    return prep


@torch.no_grad()
def sample(model: StableTTS, prep: dict, noise, n_timesteps: int = 10, temperature: float = 1.0,
           solver: str = "euler", cfg: float = 1.0, compute_dtype=None, device=None) -> dict:
    """The flow from `prepare`'s output: the model's conditioning
    (`flow_condition`), then the ODE from noise [B, prep["cap"], n_mels]
    (padded or cut to the frames the model computes) over its `time_grid`
    with its `flow_velocity`, one pass per length group (`length_groups`;
    one group at the model's frames under an adaptive solver, whose error
    norm spans the whole batch). Returns the model's `flow_output`:
    `synthesise`'s dict."""
    model, device = _on_device(model, device, compute_dtype)
    noise = _as_tensor(noise, device, torch.float32)
    if compute_dtype is not None:
        noise = noise.to(compute_dtype)
    # the frames the model computes, and of them those asked for: StableTTS
    # computes the cap rounded up to 256, F5-TTS its longest total (<= cap)
    max_mel_len = prep["y_mask"].shape[1]
    requested_len = min(prep["cap"], max_mel_len)
    if noise.shape[1] < max_mel_len:
        noise = F.pad(noise, (0, 0, 0, max_mel_len - noise.shape[1]))
    elif noise.shape[1] > max_mel_len:
        noise = noise[:, :max_mel_len]
    # each item's frames (clipped at the requested length)
    count("sampler.frames_valid", prep["y_lengths"])
    b = noise.shape[0]
    lengths = None if solver in ADAPTIVE_SOLVERS else _read_lengths(prep["y_lengths"])
    cond = model.flow_condition(prep, cfg)  # queued while the host waits for the lengths
    groups = ([(list(range(b)), max_mel_len)] if lengths is None
              else length_groups(lengths(), model.frame_quantum, max_mel_len))
    # the groups, and the items times the frames the estimator runs
    count("sampler.groups", len(groups))
    count("sampler.frames_computed", sum(len(rows) * frames for rows, frames in groups))

    t_span = model.time_grid(n_timesteps, device).to(noise.dtype)
    ode_kwargs = {}
    if lengths is None:
        # the adaptive error norm covers the requested frames only: the frames
        # added for the 256 multiple have zero velocity and would deflate it
        frame_valid = (torch.arange(max_mel_len, device=device) < requested_len)[None, :, None]
        ode_kwargs = dict(err_weight=frame_valid, err_count=b * requested_len * noise.shape[2])
    # each group's result lands in its rows and frames of mel; the frames past
    # them keep the noise, which a pass at the model's frames leaves there too
    # (the velocity is 0 past an item's length)
    mel = noise * temperature
    with span("sampler.ode"):
        rows = _to_device([i for r, _ in groups for i in r], device)
        start = 0
        for r, frames in groups:
            idx, start = rows[start:start + len(r)], start + len(r)
            sub = model.flow_rows(cond, idx, frames)
            mel[idx, :frames] = odeint(lambda t, xt: model.flow_velocity(sub, t, xt, cfg), mel[idx, :frames],
                                       t_span, method=solver, **ode_kwargs)
    return model.flow_output(prep, mel)


# What a length group costs besides its items times its frames, in frames of
# one item: each group issues its own launches every solver step. Read on the
# card from the batch cells' throughput (PERF.md §3).
GROUP_FRAMES = 768


def length_groups(lengths, quantum: int, max_frames: int) -> list:
    """The items as contiguous groups of their order by length (ties keep
    the input order), each group at its longest length plus one frame,
    rounded up to `quantum` and at most max_frames: [(item indices,
    frames)], the longest group first. The frame past an item's last is
    kept wherever the model's frames hold it, because StableTTS's estimator
    reads it: its last long-skip conv runs over the unmasked input
    projection, and attention spreads that frame's effect over the item.
    Of the partitions whose boundaries lie where the rounded length changes,
    the one with the fewest frames, each group's items times its frames
    plus GROUP_FRAMES, found by a dynamic program over those boundaries;
    equal counts keep the fewer groups."""
    n = len(lengths)
    order = sorted(range(n), key=lambda i: lengths[i])
    rounded = [min(-(-(int(lengths[i]) + 1) // quantum) * quantum, max_frames) for i in order]
    edges = [0] + [j + 1 for j in range(n) if j + 1 == n or rounded[j + 1] != rounded[j]]
    # best[e]: (least frames, groups as (s, e) pairs of edges) of the items before edges[e]
    best = [(0, [])]
    for e in range(1, len(edges)):
        best.append(min(((best[s][0] + (edges[e] - edges[s]) * rounded[edges[e] - 1] + GROUP_FRAMES,
                          best[s][1] + [(s, e)]) for s in range(e)), key=lambda c: (c[0], len(c[1]))))
    return [(sorted(order[edges[s]:edges[e]]), rounded[edges[e] - 1]) for s, e in reversed(best[-1][1])]


def _to_device(values: list, device: torch.device) -> torch.Tensor:
    """A list of ints as a tensor on `device`, copied from pinned memory on
    the GPU so that the host does not wait for the work queued before it."""
    t = torch.tensor(values)
    return t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t


def _read_lengths(y_lengths: torch.Tensor):
    """A function that returns y_lengths as a list. On the GPU the copy is
    started now and waited for when the function is called, so work queued
    after this call does not delay it."""
    if y_lengths.device.type != "cuda":
        return y_lengths.tolist
    host = torch.empty(y_lengths.shape, dtype=y_lengths.dtype, pin_memory=True)
    host.copy_(y_lengths, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def wait():
        done.synchronize()
        return host.tolist()

    return wait
