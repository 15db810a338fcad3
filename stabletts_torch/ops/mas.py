"""Monotonic Alignment Search (MAS), plain PyTorch, and its numpy oracle.

Semantics (the reference's numba kernel, kept exactly, including band
restriction and tie-breaking):

  forward, for y in [0, t_y):
    for x in [max(0, t_x + y - t_y), min(t_x, y + 1)):
      v_cur  = -1e9            if x == y else value[y-1, x]
      v_prev = (0 if y == 0 else -1e9) if x == 0 else value[y-1, x-1]
      value[y, x] += max(v_prev, v_cur)
  backtrace, from index = t_x - 1, for y in (t_y-1 .. 0]:
    path[y, index] = 1
    if index != 0 and (index == y or value[y-1, index] < value[y-1, index-1]):
      index -= 1

Cells outside the band keep their raw (unaccumulated) neg_cent value, and
the backtrace's `value[-1, :]` read at y == 0 wraps around (numpy
semantics); both are reproduced. The CUDA kernel is `ops/mas_cuda.py`.
"""

from __future__ import annotations

import numpy as np
import torch

_MAX_NEG = -1e9


def _lengths(mask: torch.Tensor):
    return mask[:, :, 0].sum(dim=1).to(torch.int64), mask[:, 0, :].sum(dim=1).to(torch.int64)


def maximum_path(neg_cent: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Batched MAS. neg_cent [B, Ty, Tx] log-likelihoods, mask [B, Ty, Tx]
    validity. Returns the binary path [B, Ty, Tx] f32 maximising the path
    sum: the forward DP is a loop over mel rows with the batch and the text
    axis vectorised, then a vectorised backtrace."""
    neg = neg_cent.float()
    b, t_y_max, t_x_max = neg.shape
    dev = neg.device
    t_ys, t_xs = _lengths(mask)
    xs = torch.arange(t_x_max, device=dev)
    batch = torch.arange(b, device=dev)
    neg_row = torch.full((b, 1), _MAX_NEG, device=dev)

    prev = torch.zeros(b, t_x_max, device=dev)
    rows = []
    for y in range(t_y_max):
        v_cur = torch.where(xs[None, :] == y, torch.full_like(prev, _MAX_NEG), prev)
        edge = torch.zeros_like(neg_row) if y == 0 else neg_row
        v_prev = torch.cat([edge, prev[:, :-1]], dim=1)
        lo = (t_xs + y - t_ys).clamp(min=0)[:, None]
        hi = t_xs.clamp(max=y + 1)[:, None]
        in_band = (xs[None, :] >= lo) & (xs[None, :] < hi)
        prev = torch.where(in_band, neg[:, y] + torch.maximum(v_prev, v_cur), neg[:, y])
        rows.append(prev)
    value = torch.stack(rows, dim=1)

    path = torch.zeros(b, t_y_max, t_x_max, device=dev)
    index = t_xs - 1
    for y in range(t_y_max - 1, -1, -1):
        active = (y < t_ys) & (index >= 0)
        path[batch[active], y, index[active]] = 1.0
        prev_row = value[:, (y - 1) % t_y_max]  # wraps at y == 0, as numpy does
        idx = index.clamp(min=0)
        a = prev_row[batch, idx]
        bb = prev_row[batch, (idx - 1).clamp(min=0)]
        move = (index != 0) & ((index == y) | (a < bb)) & active
        index = index - move.to(index.dtype)
    return path


def maximum_path_numpy(neg_cent: np.ndarray, t_ys: np.ndarray, t_xs: np.ndarray) -> np.ndarray:
    """Pure-numpy oracle with the reference kernel's exact semantics (for tests)."""
    b, t_y_max, t_x_max = neg_cent.shape
    paths = np.zeros((b, t_y_max, t_x_max), dtype=np.int32)
    values = neg_cent.astype(np.float32).copy()
    for i in range(b):
        value = values[i]
        path = paths[i]
        t_y, t_x = int(t_ys[i]), int(t_xs[i])
        for y in range(t_y):
            for x in range(max(0, t_x + y - t_y), min(t_x, y + 1)):
                v_cur = _MAX_NEG if x == y else value[y - 1, x]
                if x == 0:
                    v_prev = 0.0 if y == 0 else _MAX_NEG
                else:
                    v_prev = value[y - 1, x - 1]
                value[y, x] += max(v_prev, v_cur)
        index = t_x - 1
        for y in range(t_y - 1, -1, -1):
            path[y, index] = 1
            if index != 0 and (index == y or value[y - 1, index] < value[y - 1, index - 1]):
                index -= 1
    return paths
