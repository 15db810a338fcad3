"""How a served item is judged against the float32 reference.

Synthesis makes one discrete decision, the frames of each phoneme
(ceil(w) x length_scale of the duration predictor's w), and then continuous
outputs. The durations are judged like served tokens: where the program's
frames differ from the reference's, the gap is how far the reference's w
lies from the integer that the program crossed, relative to w. The mel and
the waveform are then judged by their relative L2 error against the
reference run on the program's durations (and, for the waveform, on the
program's mel where the program returns it), so that each stage is held to
the reference by itself.
"""

from __future__ import annotations

import math

import torch


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want|| in float64."""
    got, want = got.double().flatten(), want.double().flatten()
    if got.shape != want.shape:
        return math.inf
    den = want.norm()
    return float((got - want).norm() / den) if den > 0 else float((got - want).norm())


def duration_gap(w_ref: torch.Tensor, frames_prog: torch.Tensor, length_scale: float, cap: int) -> float:
    """Widest relative gap of w_ref [Tx] from the ceiling that the program's
    frames [Tx] imply, over the phonemes that end before the cap on both
    sides (a clamped item's frames stop at the cap: the phoneme cut there,
    and those after it, have no frames of their own). 0 where all agree."""
    w = w_ref.double()
    c_ref = torch.ceil(w)
    c_prog = torch.round(frames_prog.double() / length_scale)
    inside = (torch.cumsum(c_ref * length_scale, 0) < cap) & (torch.cumsum(frames_prog.double(), 0) < cap)
    up = (c_prog > c_ref) & inside      # the program's w crossed c_ref .. c_prog - 1 upwards
    down = (c_prog < c_ref) & inside    # and c_prog .. c_ref - 1 downwards
    gaps = torch.zeros_like(w)
    gaps[up] = ((c_prog - 1 - w) / w)[up]
    gaps[down] = ((w - c_prog) / w)[down]
    return float(gaps.max()) if len(gaps) else 0.0


def explain_length(w_ref: torch.Tensor, length_scale: float, y_prog: int, cap: int) -> tuple:
    """The frames [Tx] nearest to the reference's that give the program's
    total `y_prog` (all the program returns of its durations), and the gap
    that this needs: 0 where the totals agree; else one phoneme's ceiling
    moved by one, the one whose w lies nearest that boundary; inf where no
    such move explains the total."""
    w = w_ref.double()
    c = torch.ceil(w)
    y_ref = min(int(round(float(c.sum()) * length_scale)), cap)
    if y_ref == y_prog:
        return c * length_scale, 0.0
    steps = (y_prog - float(c.sum()) * length_scale) / length_scale
    valid = w > 0
    if abs(steps - round(steps)) > 1e-6 or abs(round(steps)) != 1 or y_prog >= cap:
        return c * length_scale, math.inf
    if steps > 0:
        margin = torch.where(valid, (c - w) / w, torch.full_like(w, math.inf))
    else:
        margin = torch.where(valid & (c > 1), (w - (c - 1)) / w, torch.full_like(w, math.inf))
    j = int(torch.argmin(margin))
    c = c.clone()
    c[j] += 1 if steps > 0 else -1
    return c * length_scale, float(margin[j])
