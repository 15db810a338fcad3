"""The DiT block's FFN half in training: CUDA kernels (csrc/ffn_train.cu),
forward and backward, and their plain PyTorch version.

    out = x + gate * conv2(drop(silu(conv1(mod(LN(x)) * m))) * m) * m

Replaces the JAX package's TPU kernel `ops/ffn_pallas_train.py::
fused_adaln_ffn_train` and keeps its numerics: LayerNorm without affine and
with f32 statistics; k=3 convs with zero padding at both ends (tap
convention y[t] = h[t-1] w0 + h[t] w1 + h[t+1] w2); dropout after SiLU with
the Philox bits of `ops/philox.py`; in bf16, h, the dropped activations, dz,
dy and dx rounded where the TPU kernel rounds them; gradients of mod and of
the weights in f32, cast to their parameters' dtype.

`ffn_train` is the differentiable entry point. A CPU tensor takes the plain
version (autograd differentiates it); a CUDA tensor runs `FFNTrainFn`, whose
forward is one `ffn_train_fwd` call and backward one `ffn_train_bwd` call,
each counting its launches in `.launches`. The residuals are the inputs and
the seed: nothing of size [B, T, F] is kept between the passes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from stabletts_torch.ops import philox
from stabletts_torch.ops.dit_block_cuda import conv3, layer_norm


def ffn_train_plain(x, mod, mask, w1, b1, w2, b2, rate: float = 0.0, seed=None, eps: float = 1e-5, row0: int = 0):
    """x [B, T, C]; mod [B, 3, C] (shift, scale, gate); mask [B, T];
    w1 [3, C, F], w2 [3, F, C]; seed int64 [2] when rate > 0; row0 the
    batch's first row in the global batch (`ops/philox.py`). Differentiable
    plain PyTorch; returns [B, T, C] in x's dtype."""
    dt = x.dtype
    m = mask.float()[..., None]
    mo = mod.float()
    xf = x.float()
    h = ((layer_norm(xf, eps) * (1.0 + mo[:, 1:2]) + mo[:, 0:1]) * m).to(dt)
    s = F.silu(conv3(h, w1, b1))
    if rate > 0.0:
        b, t, f = s.shape
        s = s * philox.ffn_keep(seed, b, t, f, rate, row0)
    sd = (s * m).to(dt)
    z = conv3(sd, w2, b2) * m
    return (xf + mo[:, 2:3] * z).to(dt)


def _check(x, mod, mask, w1, b1, w2, b2):
    b, t, c = x.shape
    f = w1.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ffn_train kernel takes float32 or bfloat16, got {x.dtype}")
    for ten in (x, mod, w1, b1, w2, b2):
        if ten.device != x.device or ten.dtype != x.dtype or not ten.is_contiguous():
            raise ValueError("ffn_train kernel: every input must be a contiguous tensor of x's device and dtype")
    if mod.shape != (b, 3, c) or w1.shape != (3, c, f) or w2.shape != (3, f, c) or b1.shape != (f,) \
            or b2.shape != (c,):
        raise ValueError("ffn_train kernel: unexpected shapes")
    if mask.shape != (b, t) or mask.dtype != torch.float32 or mask.device != x.device or not mask.is_contiguous():
        raise ValueError("ffn_train kernel: mask must be a contiguous f32 [B, T] on x's device")


def ffn_train_fwd(x, mod, mask, w1, b1, w2, b2, rate, seed, eps: float = 1e-5, row0: int = 0):
    """One launch of the forward kernel; returns out [B, T, C]."""
    from stabletts_torch.ops import _build

    _check(x, mod, mask, w1, b1, w2, b2)
    b, t, c = x.shape
    f = w1.shape[-1]
    seed_ptr, thresh, row0, keep_scale = philox.kernel_args(rate, seed, "ffn_train", row0)
    h = torch.empty_like(x)
    sd = torch.empty(b, t, f, device=x.device, dtype=x.dtype)
    out = torch.empty_like(x)
    fn = _build.load("ffn_train", "ffn_train_forward", 11, 7, 2)
    err = fn(x.data_ptr(), mod.data_ptr(), mask.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
             b2.data_ptr(), seed_ptr, h.data_ptr(), sd.data_ptr(), out.data_ptr(),
             b, t, c, f, int(x.dtype == torch.bfloat16), thresh, row0, keep_scale, eps,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ffn_train_fwd")
    ffn_train_fwd.launches += 1
    return out


def ffn_train_bwd(x, mod, mask, w1, b1, w2, b2, rate, seed, dout, eps: float = 1e-5, row0: int = 0):
    """One launch of the backward kernel; returns (dx, dmod [B, 3, C] f32,
    dw1, db1, dw2, db2 f32)."""
    from stabletts_torch.ops import _build

    _check(x, mod, mask, w1, b1, w2, b2)
    if dout.shape != x.shape or dout.dtype != x.dtype or not dout.is_contiguous():
        raise ValueError("ffn_train_bwd: dout must be a contiguous tensor like x")
    b, t, c = x.shape
    f = w1.shape[-1]
    seed_ptr, thresh, row0, keep_scale = philox.kernel_args(rate, seed, "ffn_train", row0)
    dev = x.device
    e32 = lambda *s: torch.empty(s, device=dev, dtype=torch.float32)
    ex = lambda *s: torch.empty(s, device=dev, dtype=x.dtype)
    h, dzc, dx = ex(b, t, c), ex(b, t, c), ex(b, t, c)
    sd, dyc = ex(b, t, f), ex(b, t, f)
    y, dyf = e32(b, t, f), e32(b, t, f)
    pz, dzf, dh0, dh0n = (e32(b, t, c) for _ in range(4))
    dmod, dw1, db1, dw2, db2 = e32(b, 3, c), e32(3, c, f), e32(f), e32(3, f, c), e32(c)
    ws = e32(_build.WGRAD_WS_FLOATS)
    fn = _build.load("ffn_train", "ffn_train_backward", 26, 8, 2)
    err = fn(x.data_ptr(), mod.data_ptr(), mask.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
             b2.data_ptr(), seed_ptr, dout.data_ptr(), h.data_ptr(), y.data_ptr(), sd.data_ptr(), pz.data_ptr(),
             dzf.data_ptr(), dzc.data_ptr(), dyf.data_ptr(), dyc.data_ptr(), dh0.data_ptr(), dh0n.data_ptr(),
             dx.data_ptr(), dmod.data_ptr(), dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(), db2.data_ptr(),
             ws.data_ptr(), b, t, c, f, int(x.dtype == torch.bfloat16), thresh, row0, ws.numel(), keep_scale, eps,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ffn_train_bwd")
    ffn_train_bwd.launches += 1
    return dx, dmod, dw1, db1, dw2, db2


ffn_train_fwd.launches = 0
ffn_train_bwd.launches = 0


class FFNTrainFn(torch.autograd.Function):
    """The kernel pair as an autograd function; saves only its inputs."""

    @staticmethod
    def forward(ctx, x, mod, mask, w1, b1, w2, b2, rate, seed, eps, row0):
        ins = [a.contiguous() for a in (x, mod, w1, b1, w2, b2)]
        maskf = mask.float().contiguous()
        ctx.save_for_backward(*ins, maskf, seed)
        ctx.rate, ctx.eps, ctx.row0 = rate, eps, row0
        return ffn_train_fwd(ins[0], ins[1], maskf, *ins[2:], rate, seed, eps, row0)

    @staticmethod
    def backward(ctx, dout):
        x, mod, w1, b1, w2, b2, maskf, seed = ctx.saved_tensors
        dx, dmod, dw1, db1, dw2, db2 = ffn_train_bwd(x, mod, maskf, w1, b1, w2, b2, ctx.rate, seed,
                                                     dout.contiguous(), ctx.eps, ctx.row0)
        return (dx, dmod.to(mod.dtype), None, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
                db2.to(b2.dtype), None, None, None, None)


def ffn_train(x, mod, mask, w1, b1, w2, b2, rate: float = 0.0, seed=None, eps: float = 1e-5, row0: int = 0):
    """The differentiable FFN half on x's device: plain PyTorch on the CPU,
    the CUDA kernels on the GPU. seed: int64 [2] (`philox.draw_seed`), needed
    when rate > 0; row0: the batch's first row in a data-parallel step's
    global batch."""
    if x.device.type == "cpu":
        return ffn_train_plain(x, mod, mask, w1, b1, w2, b2, rate, seed, eps, row0)
    if x.device.type != "cuda":
        raise ValueError(f"ffn_train runs on cpu or cuda, not {x.device}")
    if seed is None:
        seed = torch.zeros(2, device=x.device, dtype=torch.int64)
    return FFNTrainFn.apply(x, mod, mask, w1, b1, w2, b2, rate, seed, eps, row0)
