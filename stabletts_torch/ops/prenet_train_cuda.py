"""The estimator's mu prenet in training: CUDA kernels (csrc/prenet_train.cu),
forward and backward, and their plain PyTorch version.

    out = conv_c(silu(conv_b(silu(conv_a(mu)))))       k=3, Cin -> F -> F -> Cout

Replaces the JAX package's TPU kernel `ops/prenet_pallas_train.py::
fused_prenet_train` and keeps its numerics: three k=3 convs with zero padding
at both ends of every item (tap convention y[t] = h[t-1] w0 + h[t] w1 +
h[t+1] w2), unmasked, no dropout; in bf16 the activations h1, h2 and the
gradients dy2, dy1, dmu are rounded where the TPU kernel rounds them, the
pre-activations stay f32; parameter gradients are f32, cast to their
parameters' dtype at the end.

`prenet_train` is the differentiable entry point. A CPU tensor takes the plain
version (autograd differentiates it); a CUDA tensor runs `PrenetTrainFn`,
whose forward is one `prenet_train_fwd` call and backward one
`prenet_train_bwd` call, each counting its launches in `.launches`. The
residuals are the inputs only: the backward recomputes y1, h1, y2, h2, as the
TPU kernel does, so nothing of size [B, T, F] lives between the passes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from stabletts_torch.ops.dit_block_cuda import conv3


def prenet_train_plain(mu, wa, ba, wb, bb, wc, bc):
    """mu [B, T, Cin]; wa [3, Cin, F], wb [3, F, F], wc [3, F, Cout] and their
    biases. Differentiable plain PyTorch; returns [B, T, Cout] in mu's dtype."""
    dt = mu.dtype
    h1 = F.silu(conv3(mu, wa, ba)).to(dt)
    h2 = F.silu(conv3(h1, wb, bb)).to(dt)
    return conv3(h2, wc, bc).to(dt)


def _check(mu, wa, ba, wb, bb, wc, bc):
    cin, f, cout = mu.shape[-1], wa.shape[-1], wc.shape[-1]
    if mu.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"prenet_train kernel takes float32 or bfloat16, got {mu.dtype}")
    for ten in (mu, wa, ba, wb, bb, wc, bc):
        if ten.device != mu.device or ten.dtype != mu.dtype or not ten.is_contiguous():
            raise ValueError("prenet_train kernel: every input must be a contiguous tensor of mu's device and dtype")
    if mu.dim() != 3 or wa.shape != (3, cin, f) or wb.shape != (3, f, f) or wc.shape != (3, f, cout) \
            or ba.shape != (f,) or bb.shape != (f,) or bc.shape != (cout,):
        raise ValueError("prenet_train kernel: unexpected shapes (the kernel has 3 taps)")


def prenet_train_fwd(mu, wa, ba, wb, bb, wc, bc):
    """One launch of the forward kernel; returns out [B, T, Cout]."""
    from stabletts_torch.ops import _build

    _check(mu, wa, ba, wb, bb, wc, bc)
    b, t, cin = mu.shape
    f, cout = wa.shape[-1], wc.shape[-1]
    ex = lambda *s: torch.empty(s, device=mu.device, dtype=mu.dtype)
    h1, h2, out = ex(b, t, f), ex(b, t, f), ex(b, t, cout)
    fn = _build.load("prenet_train", "prenet_train_forward", 10, 6)
    err = fn(mu.data_ptr(), wa.data_ptr(), ba.data_ptr(), wb.data_ptr(), bb.data_ptr(), wc.data_ptr(),
             bc.data_ptr(), h1.data_ptr(), h2.data_ptr(), out.data_ptr(), b, t, cin, f, cout,
             int(mu.dtype == torch.bfloat16), torch.cuda.current_stream(mu.device).cuda_stream)
    _build.check(err, "prenet_train_fwd")
    prenet_train_fwd.launches += 1
    return out


def prenet_train_bwd(mu, wa, ba, wb, bb, wc, bc, d_out):
    """One launch of the backward kernel; returns (dmu like mu, dwa, dba,
    dwb, dbb, dwc, dbc in f32)."""
    from stabletts_torch.ops import _build

    _check(mu, wa, ba, wb, bb, wc, bc)
    b, t, cin = mu.shape
    f, cout = wa.shape[-1], wc.shape[-1]
    if d_out.shape != (b, t, cout) or d_out.dtype != mu.dtype or not d_out.is_contiguous():
        raise ValueError("prenet_train_bwd: d_out must be a contiguous [B, T, Cout] tensor of mu's dtype")
    dev = mu.device
    e32 = lambda *s: torch.empty(s, device=dev, dtype=torch.float32)
    ex = lambda *s: torch.empty(s, device=dev, dtype=mu.dtype)
    y1, y2 = e32(b, t, f), e32(b, t, f)
    h1, h2, dy2, dy1, dmu = ex(b, t, f), ex(b, t, f), ex(b, t, f), ex(b, t, f), ex(b, t, cin)
    dwa, dba, dwb, dbb, dwc, dbc = e32(3, cin, f), e32(f), e32(3, f, f), e32(f), e32(3, f, cout), e32(cout)
    ws = e32(_build.WGRAD_WS_FLOATS)
    fn = _build.load("prenet_train", "prenet_train_backward", 21, 7)
    err = fn(mu.data_ptr(), wa.data_ptr(), ba.data_ptr(), wb.data_ptr(), bb.data_ptr(), wc.data_ptr(),
             d_out.data_ptr(), y1.data_ptr(), h1.data_ptr(), y2.data_ptr(), h2.data_ptr(), dy2.data_ptr(),
             dy1.data_ptr(), dmu.data_ptr(), dwa.data_ptr(), dba.data_ptr(), dwb.data_ptr(), dbb.data_ptr(),
             dwc.data_ptr(), dbc.data_ptr(), ws.data_ptr(), b, t, cin, f, cout,
             int(mu.dtype == torch.bfloat16), ws.numel(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "prenet_train_bwd")
    prenet_train_bwd.launches += 1
    return dmu, dwa, dba, dwb, dbb, dwc, dbc


prenet_train_fwd.launches = 0
prenet_train_bwd.launches = 0


class PrenetTrainFn(torch.autograd.Function):
    """The kernel pair as an autograd function; saves only its inputs."""

    @staticmethod
    def forward(ctx, mu, wa, ba, wb, bb, wc, bc):
        ins = [a.contiguous() for a in (mu, wa, ba, wb, bb, wc, bc)]
        ctx.save_for_backward(*ins)
        return prenet_train_fwd(*ins)

    @staticmethod
    def backward(ctx, d_out):
        ins = ctx.saved_tensors
        dmu, *dparams = prenet_train_bwd(*ins, d_out.contiguous())
        return (dmu, *(g.to(p.dtype) for g, p in zip(dparams, ins[1:])))


def prenet_train(mu, wa, ba, wb, bb, wc, bc):
    """The differentiable mu prenet on mu's device: plain PyTorch on the CPU,
    the CUDA kernels on the GPU."""
    if mu.device.type == "cpu":
        return prenet_train_plain(mu, wa, ba, wb, bb, wc, bc)
    if mu.device.type != "cuda":
        raise ValueError(f"prenet_train runs on cpu or cuda, not {mu.device}")
    return PrenetTrainFn.apply(mu, wa, ba, wb, bb, wc, bc)
