"""Packed-head attention in training: CUDA kernels (csrc/attention_train.cu),
forward and backward, and their plain PyTorch version.

    o = drop(softmax(q k^T / sqrt(D) + key bias)) v      per head, [B, T, H*D]

Replaces the JAX package's TPU kernel `ops/attention_pallas_train.py::
fused_attention_train` and keeps its numerics: raw q and k, the f32 scores
scaled by 1/sqrt(D) after the product, key bias -0.7*f32max on padded keys
only (padded query rows are garbage by contract), f32 softmax, dropout on the
normalised weights, the dropped weights rounded to the inputs' dtype before
the PV product. The dropout bits cannot be the TPU PRNG's: the contract is
keep ~ Bernoulli(1 - rate) per (b, h, q, k), kept weights scaled by
1 / (1 - rate), the same mask forward and backward, here from the Philox
counters of `ops/philox.py` under a key drawn from the trainer's generator,
which the plain version reproduces bit for bit.

`attention_train` is the differentiable entry point. A CPU tensor takes the
plain version (autograd differentiates it); a CUDA tensor runs
`AttentionTrainFn`, whose forward is one `attention_train_fwd` call and
backward one `attention_train_bwd` call, each counting its launches in
`.launches`. The residuals are q, k, v, the mask, the seed, the output, the
per-row log-sum-exp [B, H, T] and, in bf16, the output's rounding remainder
`o_lo` (the f32 output minus its bf16 rounding, in bf16: the backward's
row sums D = rowsum(d_o * o) then carry f32's error, not bf16's, as the
plain version's do). No [B, H, T, T] tensor is saved between the passes; the
f32 backward holds one while it runs, dS^T (`ds_workspace`: its dK/dV kernel
writes it, its dQ kernel reads it, so the scores are recomputed once, not
twice).
"""

from __future__ import annotations

import math

import torch

from stabletts_torch.ops import philox
from stabletts_torch.ops.dit_block_cuda import _NEG


def attention_train_plain(q, k, v, mask=None, rate: float = 0.0, seed=None, n_heads: int = 4, row0: int = 0):
    """q, k, v [B, T, H*D]; mask [B, T] key validity (1 = valid) or None;
    seed int64 [2] when rate > 0; row0 the batch's first row in the global
    batch (`ops/philox.py`). Differentiable plain PyTorch; returns
    [B, T, H*D] in q's dtype."""
    dt = q.dtype
    b, t, c = q.shape
    d = c // n_heads
    heads = lambda z: z.float().reshape(b, t, n_heads, d)
    s = torch.einsum("bqhd,bkhd->bhqk", heads(q), heads(k)) * (1.0 / math.sqrt(d))
    if mask is not None:
        s = s + torch.where(mask > 0, 0.0, _NEG).float()[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    if rate > 0.0:
        p = p * philox.attention_keep(seed, b, n_heads, t, rate, row0)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(dt).float(), heads(v)).reshape(b, t, c).to(dt)


def _check(q, k, v, mask, n_heads):
    b, t, c = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"attention_train kernel takes float32 or bfloat16, got {q.dtype}")
    if c != 64 * n_heads:
        raise ValueError(f"attention_train kernel needs head_dim 64 (C={c}, heads={n_heads})")
    for ten in (q, k, v):
        if ten.shape != q.shape or ten.device != q.device or ten.dtype != q.dtype or not ten.is_contiguous():
            raise ValueError("attention_train kernel: q, k, v must be contiguous [B, T, C] tensors of one "
                             "device and dtype")
    if mask.shape != (b, t) or mask.dtype != torch.float32 or mask.device != q.device or not mask.is_contiguous():
        raise ValueError("attention_train kernel: mask must be a contiguous f32 [B, T] on q's device")


def attention_train_fwd(q, k, v, mask, n_heads, rate, seed, row0: int = 0):
    """One launch of the forward kernel; mask f32 [B, T]. Returns
    (o [B, T, C], lse [B, H, T] f32, o_lo like o in bf16, None in f32)."""
    from stabletts_torch.ops import _build

    _check(q, k, v, mask, n_heads)
    b, t, c = q.shape
    seed_ptr, thresh, row0, keep_scale = philox.kernel_args(rate, seed, "attention_train", row0)
    o = torch.empty_like(q)
    o_lo = torch.empty_like(q) if q.dtype == torch.bfloat16 else None
    lse = torch.empty(b, n_heads, t, device=q.device, dtype=torch.float32)
    fn = _build.load("attention_train", "attention_train_forward", 8, 7, 1)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), seed_ptr, o.data_ptr(),
             None if o_lo is None else o_lo.data_ptr(), lse.data_ptr(), b, t, c, n_heads, int(q.dtype == torch.bfloat16), thresh, row0, keep_scale,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "attention_train_fwd")
    attention_train_fwd.launches += 1
    return o, lse, o_lo


def ds_workspace(b: int, n_heads: int, t: int, like: torch.Tensor):
    """The f32 backward's dS^T workspace, [B*H, T', T'] f32 with T' = T
    rounded up to 128, the dK/dV kernel's key tile (it writes it, the dQ
    kernel reads it: 537 MB at B=32, T=1000, 4 heads); None in bf16."""
    if like.dtype != torch.float32:
        return None
    tp = (t + 127) // 128 * 128
    return torch.empty(b * n_heads * tp * tp, device=like.device, dtype=torch.float32)


def attention_train_bwd(q, k, v, mask, n_heads, rate, seed, o, lse, d_o, o_lo=None, row0: int = 0):
    """One launch of the backward kernel on the forward's (o, lse, o_lo);
    returns (dq, dk, dv) like q."""
    from stabletts_torch.ops import _build

    _check(q, k, v, mask, n_heads)
    if (o_lo is None) != (q.dtype == torch.float32):
        raise ValueError("attention_train_bwd: o_lo is the forward's third result (bf16 only)")
    for ten in (o, d_o) if o_lo is None else (o, d_o, o_lo):
        if ten.shape != q.shape or ten.dtype != q.dtype or not ten.is_contiguous():
            raise ValueError("attention_train_bwd: o and d_o must be contiguous tensors like q")
    b, t, c = q.shape
    seed_ptr, thresh, row0, keep_scale = philox.kernel_args(rate, seed, "attention_train", row0)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    d_rows = torch.empty(b, n_heads, t, device=q.device, dtype=torch.float32)
    ds_ws = ds_workspace(b, n_heads, t, q)
    fn = _build.load("attention_train", "attention_train_backward", 14, 7, 1)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), seed_ptr, o.data_ptr(),
             None if o_lo is None else o_lo.data_ptr(), lse.data_ptr(), d_o.data_ptr(), d_rows.data_ptr(),
             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), None if ds_ws is None else ds_ws.data_ptr(),
             b, t, c, n_heads, int(q.dtype == torch.bfloat16), thresh, row0, keep_scale,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "attention_train_bwd")
    attention_train_bwd.launches += 1
    return dq, dk, dv


attention_train_fwd.launches = 0
attention_train_bwd.launches = 0


class AttentionTrainFn(torch.autograd.Function):
    """The kernel pair as an autograd function; saves its inputs, the output
    (in bf16 with its rounding remainder) and the log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, maskf, n_heads, rate, seed, row0):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse, o_lo = attention_train_fwd(q, k, v, maskf, n_heads, rate, seed, row0)
        ctx.save_for_backward(q, k, v, maskf, seed, o, lse, o_lo)
        ctx.n_heads, ctx.rate, ctx.row0 = n_heads, rate, row0
        return o

    @staticmethod
    def backward(ctx, d_o):
        q, k, v, maskf, seed, o, lse, o_lo = ctx.saved_tensors
        dq, dk, dv = attention_train_bwd(q, k, v, maskf, ctx.n_heads, ctx.rate, seed, o, lse, d_o.contiguous(),
                                         o_lo, ctx.row0)
        return dq, dk, dv, None, None, None, None, None


def attention_train(q, k, v, mask=None, rate: float = 0.0, seed=None, n_heads: int = 4, row0: int = 0):
    """Differentiable packed-head attention on q's device: plain PyTorch on
    the CPU, the CUDA kernels on the GPU. seed: int64 [2]
    (`philox.draw_seed`), needed when rate > 0; row0: the batch's first row
    in a data-parallel step's global batch."""
    if q.device.type == "cpu":
        return attention_train_plain(q, k, v, mask, rate, seed, n_heads, row0)
    if q.device.type != "cuda":
        raise ValueError(f"attention_train runs on cpu or cuda, not {q.device}")
    b, t, _ = q.shape
    maskf = (torch.ones(b, t, device=q.device) if mask is None else mask.float()).contiguous()
    if seed is None:
        seed = torch.zeros(2, device=q.device, dtype=torch.int64)
    return AttentionTrainFn.apply(q, k, v, maskf, n_heads, rate, seed, row0)
