"""One period discriminator's conv stack as CUDA kernels (csrc/mpd_stack.cu)
and its plain PyTorch version.

Replaces the JAX package's TPU kernel `ops/mpd_pallas.py::mpd_stack_fused`:
from period-folded audio, `DiscriminatorP`'s convs (kernel (5,1), stride (3,1)
for convs 0-3 and 1 for conv 4, leaky ReLU 0.1) and conv_post (kernel (3,1)),
with weight norm already folded. As there, conv 0 (one input channel) and the
reflect pad for T % period != 0 run outside the kernel, in PyTorch, and the
kernel takes convs 1-4 and conv_post; it is forward only (f32), an entry
point beside `models.discriminators.DiscriminatorP`, which GAN training
differentiates and which this function matches.

`mpd_stack` dispatches on the tensor's device: the plain version on the CPU,
the kernel on the GPU. `mpd_stack.launches` counts launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

LEAK = 0.1
_CHANNELS = (32, 128, 512, 1024, 1024)


def layer_lens(l0: int) -> list:
    """Lengths along the folded time axis: the input, the outputs of convs
    0-3 (stride 3, kernel 5, padding 2: ceil(l / 3)), conv 4 and conv_post."""
    lens = [l0]
    for _ in range(4):
        lens.append(-(-lens[-1] // 3))
    return lens + [lens[-1], lens[-1]]


def fold_period(x: torch.Tensor, period: int) -> torch.Tensor:
    """[B, T] audio -> [B, 1, ceil(T / period), period], reflect-padded at the end."""
    b, t = x.shape
    if t % period:
        x = F.pad(x[:, None, :], (0, period - t % period), mode="reflect")[:, 0, :]
    return x.reshape(b, 1, -1, period)


def mpd_stack_plain(x, folded, period: int):
    """x [B, T] audio; folded: the six (kernel [out, in, k, 1], bias) pairs of
    one `DiscriminatorP` (convs 0-4, conv_post). Returns (logits [B, L5 *
    period], [5 feature maps [B, C, L, period]])."""
    h = fold_period(x.float(), period)
    fmap = []
    for i in range(5):
        w, b = folded[i]
        h = F.leaky_relu(F.conv2d(h, w.float(), b.float(), (3 if i < 4 else 1, 1), (2, 0)), LEAK)
        if i > 0:
            fmap.append(h)
    w, b = folded[5]
    h = F.conv2d(h, w.float(), b.float(), (1, 1), (1, 0))
    fmap.append(h)
    return h.flatten(1), fmap


def _mpd_stack_cuda(x, folded, period: int):
    from stabletts_torch.ops import _build

    if x.dim() != 2 or len(folded) != 6:
        raise ValueError("mpd_stack kernel: x must be [B, T] and folded the six (kernel, bias) pairs")
    ins = (1,) + _CHANNELS[:-1]
    for i, (w, b) in enumerate(folded[:5]):
        if w.shape != (_CHANNELS[i], ins[i], 5, 1) or b.shape != (_CHANNELS[i],):
            raise ValueError(f"mpd_stack kernel: conv {i} has kernel {tuple(w.shape)}, bias {tuple(b.shape)}")
    if folded[5][0].shape != (1, 1024, 3, 1) or folded[5][1].shape != (1,):
        raise ValueError("mpd_stack kernel: conv_post must be [1, 1024, 3, 1]")
    if any(t.device != x.device for pair in folded for t in pair):
        raise ValueError("mpd_stack kernel: the weights must be on x's device")
    dev = x.device
    bsz = x.shape[0]
    h = fold_period(x.float(), period)
    lens = layer_lens(h.shape[2])
    # conv 0 in PyTorch, then [B, 32, l1, p] -> streams [B * p, l1, 32]
    w0, b0 = folded[0]
    h = F.leaky_relu(F.conv2d(h, w0.float(), b0.float(), (3, 1), (2, 0)), LEAK)
    a0 = h.permute(0, 3, 2, 1).contiguous()
    # kernels [out, in, k, 1] -> [k, in, out]
    ws = [folded[i][0].float()[..., 0].permute(2, 1, 0).contiguous() for i in range(1, 6)]
    bs = [folded[i][1].float().contiguous() for i in range(1, 6)]
    s = bsz * period
    outs = [torch.empty(bsz, period, lens[i + 1], c, device=dev, dtype=torch.float32)
            for i, c in ((1, 128), (2, 512), (3, 1024), (4, 1024))]
    outs.append(torch.empty(bsz, period, lens[6], 1, device=dev, dtype=torch.float32))
    fn = _build.load("mpd_stack", "mpd_stack_forward", 16, 5)
    args = [a0.data_ptr()]
    for w, b in zip(ws, bs):
        args += [w.data_ptr(), b.data_ptr()]
    err = fn(*args, *(o.data_ptr() for o in outs), s, lens[1], lens[2], lens[3], lens[4],
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "mpd_stack")
    mpd_stack.launches += 1
    fmap = [o.permute(0, 3, 2, 1) for o in outs]  # [B, p, L, C] -> [B, C, L, p] (views)
    return fmap[-1].flatten(1), fmap


def mpd_stack(x: torch.Tensor, folded, period: int):
    """One `DiscriminatorP` forward from folded weights on x's device: plain
    PyTorch on the CPU, the CUDA kernels on the GPU. No gradient."""
    with torch.no_grad():
        if x.device.type == "cpu":
            return mpd_stack_plain(x, folded, period)
        if x.device.type != "cuda":
            raise ValueError(f"mpd_stack runs on cpu or cuda, not {x.device}")
        return _mpd_stack_cuda(x, folded, period)


mpd_stack.launches = 0
