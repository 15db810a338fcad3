"""Counter-based dropout bits: Philox4x32-10, the same generator as
`csrc/common.cuh::philox4x32_10`, here in integer tensor arithmetic.

A dropout call draws one 64-bit key from the trainer's `torch.Generator`
(`draw_seed`, a device int64 [2] tensor, so drawing needs no host sync);
each element's counter is built from its coordinates, so the kernels and
these plain versions give the same keep mask bit for bit, and a backward
pass regenerates its forward's mask instead of storing it:

  attention weight (b, h, q, k):  counter (k // 4, q, (b + row0) * H + h, 0), word k % 4
  FFN activation (b, t, f):       counter (f // 4, t, b + row0, 1),         word f % 4

`row0` is the first row of the batch in the global batch of a data-parallel
step (0 on one process): each rank then draws its own rows of the mask that
one process would draw over the whole batch.

An element is kept when its 32-bit word is >= thresh = min(int(rate * 2**32),
2**32 - 1) (the TPU kernels' rule on their own bits, which cannot be
reproduced), and kept values are scaled by 1 / (1 - rate).
"""

from __future__ import annotations

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def draw_seed(gen: torch.Generator, device) -> torch.Tensor:
    """One dropout key: int64 [2], each word in [0, 2**32), on `device`."""
    return torch.randint(0, 2 ** 32, (2,), generator=gen, device=device, dtype=torch.int64)


def threshold(rate: float) -> int:
    return min(int(rate * float(2 ** 32)), 2 ** 32 - 1)


def kernel_args(rate: float, seed, what: str, row0: int = 0):
    """(seed pointer, threshold as a C int, row0, keep scale) for a CUDA
    kernel's `Dropout` (csrc/common.cuh); a null pointer turns dropout off."""
    if row0 < 0:
        raise ValueError(f"{what}: row0 must be >= 0, got {row0}")
    if rate <= 0.0:
        return 0, 0, row0, 1.0
    if seed is None or seed.dtype != torch.int64 or seed.numel() != 2:
        raise ValueError(f"{what}: dropout needs an int64 [2] seed on x's device")
    thresh = threshold(rate)
    return seed.data_ptr(), thresh - 2 ** 32 if thresh >= 2 ** 31 else thresh, row0, 1.0 / (1.0 - rate)


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit halves of a * m for a in [0, 2**32) (int64 tensor) and
    a 32-bit constant m, from 16-bit partial products (no int64 overflow)."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    m_lo, m_hi = m & 0xFFFF, m >> 16
    ll, lh, hl, hh = a_lo * m_lo, a_lo * m_hi, a_hi * m_lo, a_hi * m_hi
    mid = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
    lo = ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)
    hi = hh + (lh >> 16) + (hl >> 16) + (mid >> 16)
    return hi, lo


def philox4x32(c0, c1, c2, c3, key) -> torch.Tensor:
    """The four 32-bit words (int64, stacked on a new last dim) of
    Philox4x32-10 at counters (c0, c1, c2, c3) (int64 tensors that broadcast)
    under key = (k0, k1)."""
    k0, k1 = int(key[0]), int(key[1])
    c0, c1, c2, c3 = torch.broadcast_tensors(c0, c1, c2, c3)
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return torch.stack([c0, c1, c2, c3], dim=-1)


def _keep(words: torch.Tensor, n: int, rate: float) -> torch.Tensor:
    """[..., n // 4 rounded up, 4] words -> [..., n] f32 multiplier
    (1 / (1 - rate) where kept, 0 where dropped)."""
    keep = words.flatten(-2)[..., :n] >= threshold(rate)
    return keep.float() * (1.0 / (1.0 - rate))


def attention_keep(seed: torch.Tensor, b: int, h: int, t: int, rate: float, row0: int = 0) -> torch.Tensor:
    """Dropout multiplier of the attention weights, [B, H, Tq, Tk] f32, for
    global rows row0 .. row0 + B - 1."""
    dev = seed.device
    ar = lambda n: torch.arange(n, device=dev, dtype=torch.int64)
    c0 = ar((t + 3) // 4)[None, None, None, :]
    c1 = ar(t)[None, None, :, None]
    c2 = ((ar(b)[:, None] + row0) * h + ar(h)[None, :])[:, :, None, None]
    words = philox4x32(c0, c1, c2, torch.zeros((), device=dev, dtype=torch.int64), seed.tolist())
    return _keep(words, t, rate)


def ffn_keep(seed: torch.Tensor, b: int, t: int, f: int, rate: float, row0: int = 0) -> torch.Tensor:
    """Dropout multiplier of the FFN activations, [B, T, F] f32, for global
    rows row0 .. row0 + B - 1."""
    dev = seed.device
    ar = lambda n: torch.arange(n, device=dev, dtype=torch.int64)
    words = philox4x32(ar((f + 3) // 4)[None, None, :], ar(t)[None, :, None], ar(b)[:, None, None] + row0,
                       torch.ones((), device=dev, dtype=torch.int64), seed.tolist())
    return _keep(words, f, rate)
