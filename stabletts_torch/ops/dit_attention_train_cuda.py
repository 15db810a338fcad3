"""The DiT block's attention half in training: CUDA kernels
(csrc/dit_attention_train.cu), forward and backward, and their plain
PyTorch version.

    out = x + gate * out_proj(drop(attn(rope(qkv(mod(LN(x))))))) * m

Replaces the JAX package's TPU kernel `ops/dit_attention_pallas_train.py::
fused_dit_attention_train` and keeps its numerics: LayerNorm without affine
and with f32 statistics; q, k, v rounded to x's dtype before partial RoPE
(rotary dim D/2, the concatenated-halves form); scores scaled by 1/sqrt(D)
after the product, key bias -0.7*f32max on padded keys only (padded query
rows are garbage that `* m` removes); natural-exp softmax; dropout on the
normalised weights with the Philox bits of `ops/philox.py`, the weights
rounded before the PV product; gradients of mod and of the weights in f32,
cast to their parameters' dtype.

`dit_attention_train` is the differentiable entry point. A CPU tensor takes
the plain version (autograd differentiates it); a CUDA tensor runs
`DiTAttentionTrainFn`, whose forward is one `dit_attention_train_fwd` call
and backward one `dit_attention_train_bwd` call, each counting its launches
in `.launches`. The residuals are the inputs, the seed, the attention
output [B, T, C] and the per-row log-sum-exp [B, H, T]; no [B, H, T, T]
tensor is saved between the passes (the f32 backward holds dS^T while it
runs: `attention_train_cuda.ds_workspace`).
"""

from __future__ import annotations

import math

import torch

from stabletts_torch.ops import philox
from stabletts_torch.ops.attention_train_cuda import ds_workspace
from stabletts_torch.ops.dit_block_cuda import _NEG, apply_rope, layer_norm, rope_tables


def dit_attention_train_plain(x, mod, mask, wq, bq, wk, bk, wv, bv, wo, bo, n_heads: int, rate: float = 0.0,
                              seed=None, eps: float = 1e-5, row0: int = 0):
    """x [B, T, C]; mod [B, 3, C] (shift, scale, gate); mask [B, T]; dense
    weights [C, C] (in, out) and biases [C]; seed int64 [2] when rate > 0;
    row0 the batch's first row in the global batch (`ops/philox.py`).
    Differentiable plain PyTorch; returns [B, T, C] in x's dtype."""
    dt = x.dtype
    b, t, c = x.shape
    d = c // n_heads
    m = mask.float()[..., None]
    mo = mod.float()
    xf = x.float()
    h = (layer_norm(xf, eps) * (1.0 + mo[:, 1:2]) + mo[:, 0:1]).to(dt)
    proj = lambda w, bias: (h.float() @ w.float() + bias.float()).to(dt).view(b, t, n_heads, d)
    cos, sin = rope_tables(t, d, x.device)
    q = apply_rope(proj(wq, bq), cos, sin)
    k = apply_rope(proj(wk, bk), cos, sin)
    v = proj(wv, bv)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(d))
    s = s + torch.where(mask > 0, 0.0, _NEG).float()[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    if rate > 0.0:
        p = p * philox.attention_keep(seed, b, n_heads, t, rate, row0)
    att = torch.einsum("bhqk,bkhd->bqhd", p.to(dt).float(), v.float()).reshape(b, t, c).to(dt)
    z = att.float() @ wo.float() + bo.float()
    return (xf + mo[:, 2:3] * z * m).to(dt)


def _check(x, mod, mask, ws, n_heads):
    b, t, c = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dit_attention_train kernel takes float32 or bfloat16, got {x.dtype}")
    if c != 64 * n_heads:
        raise ValueError(f"dit_attention_train kernel needs head_dim 64 (C={c}, heads={n_heads})")
    for ten in (x, mod, *ws):
        if ten.device != x.device or ten.dtype != x.dtype or not ten.is_contiguous():
            raise ValueError("dit_attention_train kernel: every input must be a contiguous tensor of x's "
                             "device and dtype")
    wqkv, bqkv, wo, bo = ws
    if mod.shape != (b, 3, c) or wqkv.shape != (c, 3 * c) or bqkv.shape != (3 * c,) or wo.shape != (c, c) \
            or bo.shape != (c,):
        raise ValueError("dit_attention_train kernel: unexpected shapes")
    if mask.shape != (b, t) or mask.dtype != torch.float32 or mask.device != x.device or not mask.is_contiguous():
        raise ValueError("dit_attention_train kernel: mask must be a contiguous f32 [B, T] on x's device")


def dit_attention_train_fwd(x, mod, mask, wqkv, bqkv, wo, bo, n_heads, rate, seed, eps: float = 1e-5,
                            row0: int = 0):
    """One launch of the forward kernel. wqkv [C, 3C] (q | k | v), bqkv [3C].
    Returns (out [B, T, C], att [B, T, C], lse [B, H, T] f32, att_lo: in
    bf16 the f32 attention output minus att, rounded to bf16, which keeps the
    backward's row sums D = rowsum(datt * att) at f32's error; None in f32)."""
    from stabletts_torch.ops import _build

    _check(x, mod, mask, (wqkv, bqkv, wo, bo), n_heads)
    b, t, c = x.shape
    seed_ptr, thresh, row0, keep_scale = philox.kernel_args(rate, seed, "dit_attention_train", row0)
    cos, sin = rope_tables(t, c // n_heads, x.device)
    h, q, k, v, att, out = (torch.empty_like(x) for _ in range(6))
    att_lo = torch.empty_like(x) if x.dtype == torch.bfloat16 else None
    lse = torch.empty(b, n_heads, t, device=x.device, dtype=torch.float32)
    fn = _build.load("dit_attention_train", "dit_attention_train_forward", 18, 7, 2)
    err = fn(x.data_ptr(), mod.data_ptr(), mask.data_ptr(), cos.data_ptr(), sin.data_ptr(), wqkv.data_ptr(),
             bqkv.data_ptr(), wo.data_ptr(), bo.data_ptr(), seed_ptr, h.data_ptr(), q.data_ptr(), k.data_ptr(),
             v.data_ptr(), att.data_ptr(), None if att_lo is None else att_lo.data_ptr(), lse.data_ptr(),
             out.data_ptr(), b, t, c, n_heads, int(x.dtype == torch.bfloat16), thresh, row0, keep_scale, eps,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "dit_attention_train_fwd")
    dit_attention_train_fwd.launches += 1
    return out, att, lse, att_lo


def dit_attention_train_bwd(x, mod, mask, wqkv, bqkv, wo, bo, n_heads, rate, seed, att, lse, dout,
                            eps: float = 1e-5, att_lo=None, row0: int = 0):
    """One launch of the backward kernel on the forward's (att, lse, att_lo); returns (dx, dmod [B, 3, C],
    dwqkv [C, 3C], dbqkv [3C], dwo [C, C], dbo [C]), all but dx in f32."""
    from stabletts_torch.ops import _build

    _check(x, mod, mask, (wqkv, bqkv, wo, bo), n_heads)
    if (att_lo is None) != (x.dtype == torch.float32):
        raise ValueError("dit_attention_train_bwd: att_lo is the forward's fourth result (bf16 only)")
    for ten, shape in ((att, x.shape), (dout, x.shape), (x if att_lo is None else att_lo, x.shape)):
        if ten.shape != shape or ten.dtype != x.dtype or not ten.is_contiguous():
            raise ValueError("dit_attention_train_bwd: att and dout must be contiguous tensors like x")
    b, t, c = x.shape
    seed_ptr, thresh, row0, keep_scale = philox.kernel_args(rate, seed, "dit_attention_train", row0)
    cos, sin = rope_tables(t, c // n_heads, x.device)
    dev = x.device
    e32 = lambda *s: torch.empty(s, device=dev, dtype=torch.float32)
    h, q, k, v, dzc, datt, dq_r, dk_r, dx = (torch.empty_like(x) for _ in range(9))
    dqkv = torch.empty(b, t, 3 * c, device=dev, dtype=x.dtype)
    pz, dh0, dh0n = e32(b, t, c), e32(b, t, c), e32(b, t, c)
    dv_rows = e32(b, n_heads, t)
    dmod, dwqkv, dbqkv, dwo, dbo = e32(b, 3, c), e32(c, 3 * c), e32(3 * c), e32(c, c), e32(c)
    ws = e32(_build.WGRAD_WS_FLOATS)
    ds_ws = ds_workspace(b, n_heads, t, x)
    fn = _build.load("dit_attention_train", "dit_attention_train_backward", 35, 8, 2)
    err = fn(x.data_ptr(), mod.data_ptr(), mask.data_ptr(), cos.data_ptr(), sin.data_ptr(), wqkv.data_ptr(),
             bqkv.data_ptr(), wo.data_ptr(), bo.data_ptr(), seed_ptr, att.data_ptr(),
             None if att_lo is None else att_lo.data_ptr(), lse.data_ptr(), dout.data_ptr(), h.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(), pz.data_ptr(),
             dzc.data_ptr(), datt.data_ptr(), dv_rows.data_ptr(), dq_r.data_ptr(), dk_r.data_ptr(),
             dqkv.data_ptr(), dh0.data_ptr(), dh0n.data_ptr(), dx.data_ptr(), dmod.data_ptr(),
             dwqkv.data_ptr(), dbqkv.data_ptr(), dwo.data_ptr(), dbo.data_ptr(), ws.data_ptr(),
             None if ds_ws is None else ds_ws.data_ptr(), b, t, c, n_heads, int(x.dtype == torch.bfloat16), thresh,
             row0, ws.numel(), keep_scale, eps, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "dit_attention_train_bwd")
    dit_attention_train_bwd.launches += 1
    return dx, dmod, dwqkv, dbqkv, dwo, dbo


dit_attention_train_fwd.launches = 0
dit_attention_train_bwd.launches = 0


class DiTAttentionTrainFn(torch.autograd.Function):
    """The kernel pair as an autograd function; saves its inputs, the
    attention output and the log-sum-exp."""

    @staticmethod
    def forward(ctx, x, mod, mask, wq, bq, wk, bk, wv, bv, wo, bo, n_heads, rate, seed, eps, row0):
        x, mod, wo, bo = (a.contiguous() for a in (x, mod, wo, bo))
        wqkv = torch.cat([wq, wk, wv], dim=1).contiguous()
        bqkv = torch.cat([bq, bk, bv]).contiguous()
        maskf = mask.float().contiguous()
        out, att, lse, att_lo = dit_attention_train_fwd(x, mod, maskf, wqkv, bqkv, wo, bo, n_heads, rate, seed, eps,
                                                        row0)
        ctx.save_for_backward(x, mod, maskf, wqkv, bqkv, wo, bo, seed, att, lse, att_lo)
        ctx.n_heads, ctx.rate, ctx.eps, ctx.row0 = n_heads, rate, eps, row0
        return out

    @staticmethod
    def backward(ctx, dout):
        x, mod, maskf, wqkv, bqkv, wo, bo, seed, att, lse, att_lo = ctx.saved_tensors
        dx, dmod, dwqkv, dbqkv, dwo, dbo = dit_attention_train_bwd(
            x, mod, maskf, wqkv, bqkv, wo, bo, ctx.n_heads, ctx.rate, seed, att, lse, dout.contiguous(), ctx.eps,
            att_lo, ctx.row0)
        wdt = wqkv.dtype
        dwq, dwk, dwv = (g.to(wdt) for g in dwqkv.chunk(3, dim=1))
        dbq, dbk, dbv = (g.to(wdt) for g in dbqkv.chunk(3))
        return (dx, dmod.to(mod.dtype), None, dwq, dbq, dwk, dbk, dwv, dbv, dwo.to(wdt), dbo.to(wdt),
                None, None, None, None, None)


def dit_attention_train(x, mod, mask, wq, bq, wk, bk, wv, bv, wo, bo, n_heads: int, rate: float = 0.0,
                        seed=None, eps: float = 1e-5, row0: int = 0):
    """The differentiable attention half on x's device: plain PyTorch on the
    CPU, the CUDA kernels on the GPU. seed: int64 [2] (`philox.draw_seed`),
    needed when rate > 0; row0: the batch's first row in a data-parallel
    step's global batch."""
    if x.device.type == "cpu":
        return dit_attention_train_plain(x, mod, mask, wq, bq, wk, bk, wv, bv, wo, bo, n_heads, rate, seed, eps,
                                         row0)
    if x.device.type != "cuda":
        raise ValueError(f"dit_attention_train runs on cpu or cuda, not {x.device}")
    if seed is None:
        seed = torch.zeros(2, device=x.device, dtype=torch.int64)
    return DiTAttentionTrainFn.apply(x, mod, mask, wq, bq, wk, bk, wv, bv, wo, bo, n_heads, rate, seed, eps, row0)
