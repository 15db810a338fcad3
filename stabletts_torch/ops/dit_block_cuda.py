"""The whole inference DiT block: CUDA kernel (csrc/dit_block.cu) and its
plain PyTorch version.

    x1 = x + gate_msa * out_proj(attn(rope(qkv(mod(LN(x)))))) * mask
    y  = x1 + gate_mlp * conv2(act(conv1(mod(LN(x1)) * mask)) * mask) * mask

Replaces the JAX package's TPU kernel `ops/dit_block_pallas.py::fused_dit_block`
and keeps its numerics: LayerNorm without affine and with f32 statistics;
log2(e)/sqrt(D) folded into q before RoPE (the concatenated-halves form);
softmax in exp2 with the key bias -0.7*f32max on padded keys only (padded
query rows are garbage that `* mask` removes); convs with zero padding at
both ends; x1 kept in f32. In bf16 the values are rounded to bf16 at the
same points as the TPU kernel; every product accumulates in f32.

Two models run this one block. StableTTS: RoPE on the first half of each
head (`rot` = D/2), an FFN of two k=3 convs with SiLU, eps 1e-5 (the
defaults). F5-TTS: RoPE on the whole head (`rot` = D; its interleaved pairs
after a fixed permutation of each head's q and k columns, made once by
the model), an FFN of two dense layers (w1 [1, C, F]) with GELU in its tanh
form (`act="gelu_tanh"`), eps 1e-6. The FFN's taps are w1's first size.

`dit_block` dispatches on the tensor's device: a CPU tensor takes the plain
version, a CUDA tensor the kernel (or an error). `dit_block.launches` counts
kernel launches.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from stabletts_torch.ops.tap_gemm_cuda import count_conv_paths

_NEG = -0.7 * torch.finfo(torch.float32).max
_LOG2E = math.log2(math.e)


class DiTWeights(NamedTuple):
    """Kernel-layout weights of one block (made once per model by
    `packed_weights`)."""

    wqkv: torch.Tensor  # [C, 3C]: q | k | v projections
    bqkv: torch.Tensor  # [3C]
    wo: torch.Tensor    # [C, C]
    bo: torch.Tensor    # [C]
    w1: torch.Tensor    # [taps, C, F] conv taps (3, or 1: a dense layer)
    b1: torch.Tensor    # [F]
    w2: torch.Tensor    # [taps, F, C]
    b2: torch.Tensor    # [C]


def packed_weights(owner, layers, pack) -> DiTWeights:
    """The kernel-layout weights of the block `owner`, kept in `owner._packed`
    and rebuilt only when a weight or bias of `layers` (the block's q, k, v,
    output, FFN-in and FFN-out layers) was replaced, moved, cast or written
    in place (`load_state_dict`, `.to`, an optimiser step). `pack()` gives the
    eight tensors of `DiTWeights` in the block's own layout; each is copied
    contiguous."""
    params = [p for layer in layers for p in (layer.weight, layer.bias)]
    key = tuple((p.data_ptr(), p._version, p.dtype, p.device) for p in params)
    if owner._packed is None or owner._packed[0] != key:
        with torch.no_grad():
            w = DiTWeights(*(t.detach().clone(memory_format=torch.contiguous_format) for t in pack()))
        owner._packed = (key, w)
    return owner._packed[1]


_rope_cache: dict = {}


def rope_tables(t: int, head_dim: int, device, rot: int | None = None) -> tuple:
    """cos/sin [T, rot/2] f32 for RoPE over the first `rot` features of a
    head (default head_dim/2, StableTTS's partial RoPE):
    theta_i = 10000^(-2i/rot), entry (t, i) = cos/sin(t * theta_i)."""
    rot = head_dim // 2 if rot is None else rot
    key = (t, head_dim, rot, str(device))
    if key not in _rope_cache:
        if len(_rope_cache) > 32:
            _rope_cache.clear()
        half = rot // 2
        theta = 1.0 / (10_000.0 ** (torch.arange(half, dtype=torch.float32) * 2.0 / rot))
        idx = torch.arange(t, dtype=torch.float32)[:, None] * theta[None, :]
        _rope_cache[key] = (torch.cos(idx).to(device), torch.sin(idx).to(device))
    return _rope_cache[key]


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Partial RoPE on [B, T, H, D] (f32 math, result in x's dtype): the first
    2*half features rotate as x*cos + neg_half(x)*sin with
    neg_half(x) = [-x[half:rot], x[:half]]; the rest pass through."""
    half = cos.shape[-1]
    rot = 2 * half
    xf = x.float()
    xr, xp = xf[..., :rot], xf[..., rot:]
    neg = torch.cat([-xr[..., half:], xr[..., :half]], dim=-1)
    c = torch.cat([cos, cos], dim=-1)[None, :, None, :]
    s = torch.cat([sin, sin], dim=-1)[None, :, None, :]
    return torch.cat([xr * c + neg * s, xp], dim=-1).to(x.dtype)


def attention_exp2(q, k, v, mask) -> torch.Tensor:
    """q (pre-scaled by log2(e)/sqrt(D)), k, v: [B, T, H, D]; mask [B, T].
    softmax in exp2 with an additive key bias; the weights are rounded to v's
    dtype before the product, the normaliser is the f32 sum. -> [B, T, H, D] f32."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s + torch.where(mask > 0, 0.0, _NEG).float()[:, None, None, :]
    w = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    denom = w.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bhqd", w.to(v.dtype).float(), v.float()) / denom
    return o.permute(0, 2, 1, 3)


def layer_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm without affine, f32 in and out."""
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


def conv_taps(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The FFN's conv over rows in f32: `conv3` for w [3, Cin, Cout], a
    dense layer for w [1, Cin, Cout]."""
    if w.shape[0] == 1:
        return h.float() @ w[0].float() + b.float()
    return conv3(h, w, b)


_ACTS = {"silu": F.silu, "gelu_tanh": lambda z: F.gelu(z, approximate="tanh")}


def conv3(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """k=3 conv over rows with zero padding at both ends, in f32:
    h [B, T, Cin], w [3, Cin, Cout], b [Cout]."""
    h, w = h.float(), w.float()
    down = F.pad(h, (0, 0, 1, 0))[:, :-1]  # row t holds h[t-1]
    up = F.pad(h, (0, 0, 0, 1))[:, 1:]     # row t holds h[t+1]
    return h @ w[1] + down @ w[0] + up @ w[2] + b.float()


def attention_half_plain(x, mods, mask, wqkv, bqkv, wo, bo, n_heads: int, eps: float = 1e-5,
                         rot: int | None = None) -> torch.Tensor:
    """The block's attention half, x + gate * out_proj(attention) * mask, as
    f32 (the whole block keeps it so; the half alone rounds it to x's dtype).
    x [B, T, C]; mods [B, 3, C] (shift, scale, gate); mask [B, T]; RoPE on
    the first `rot` features of each head (default D/2)."""
    dt = x.dtype
    b, t, c = x.shape
    d = c // n_heads
    mo = mods.float()
    xf = x.float()
    h = (layer_norm(xf, eps) * (1.0 + mo[:, 1:2]) + mo[:, 0:1]).to(dt)
    qkv = h.float() @ wqkv.float() + bqkv.float()
    q = (qkv[..., :c] * (_LOG2E / math.sqrt(d))).to(dt).view(b, t, n_heads, d)
    k = qkv[..., c:2 * c].to(dt).view(b, t, n_heads, d)
    v = qkv[..., 2 * c:].to(dt).view(b, t, n_heads, d)
    cos, sin = rope_tables(t, d, x.device, rot)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    att = attention_exp2(q, k, v, mask).reshape(b, t, c).to(dt)
    out = att.float() @ wo.float() + bo.float()
    return xf + out * mo[:, 2:3] * mask.float()[..., None]


def ffn_half_plain(x, mods, mask, w1, b1, w2, b2, dtype, eps: float = 1e-5, act: str = "silu") -> torch.Tensor:
    """The block's FFN half, x + gate * conv2(act(conv1(mod(LN(x)) * m)) * m) * m,
    with the activations rounded to `dtype`. x [B, T, C] in f32 or `dtype`;
    mods [B, 3, C] (shift, scale, gate); w1 [taps, C, F], w2 [taps, F, C];
    act "silu" or "gelu_tanh"."""
    m = mask.float()[..., None]
    mo = mods.float()
    xf = x.float()
    h = ((layer_norm(xf, eps) * (1.0 + mo[:, 1:2]) + mo[:, 0:1]) * m).to(dtype)
    y = (_ACTS[act](conv_taps(h, w1, b1)) * m).to(dtype)
    z = conv_taps(y, w2, b2) * m
    return (xf + mo[:, 2:3] * z).to(dtype)


def dit_block_plain(x, mods, mask, w: DiTWeights, n_heads: int, eps: float = 1e-5, rot: int | None = None,
                    act: str = "silu"):
    """x [B, T, C] (pre-masked); mods [B, 6, C] (shift/scale/gate msa, then
    mlp); mask [B, T]. Returns [B, T, C] in x's dtype."""
    x1 = attention_half_plain(x, mods[:, :3], mask, w.wqkv, w.bqkv, w.wo, w.bo, n_heads, eps, rot)
    return ffn_half_plain(x1, mods[:, 3:], mask, w.w1, w.b1, w.w2, w.b2, x.dtype, eps, act)


def _dit_block_cuda(x, mods, mask, w: DiTWeights, n_heads: int, eps: float, rot: int | None, act: str):
    from stabletts_torch.ops import _build

    b, t, c = x.shape
    f = w.w1.shape[-1]
    d = c // n_heads
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dit_block kernel takes float32 or bfloat16, got {x.dtype}")
    if d != 64 or c % 64 or f % 64 or c != n_heads * d:
        raise ValueError(f"dit_block kernel needs head_dim 64 and C, F multiples of 64 (C={c}, F={f}, heads={n_heads})")
    rot = d // 2 if rot is None else rot
    taps = w.w1.shape[0]
    if taps not in (1, 3) or rot % 2 or not 2 <= rot <= d or act not in _ACTS:
        raise ValueError(f"dit_block kernel takes 1 or 3 taps, an even rotary width up to {d} and act in "
                         f"{sorted(_ACTS)} (taps={taps}, rot={rot}, act={act!r})")
    tensors = (x, mods, *w)
    for ten in tensors:
        if ten.device != x.device or ten.dtype != x.dtype or not ten.is_contiguous():
            raise ValueError("dit_block kernel: every input must be a contiguous tensor of x's device and dtype")
    if mods.shape != (b, 6, c) or w.wqkv.shape != (c, 3 * c) or w.w1.shape != (taps, c, f) or w.w2.shape != (taps, f, c):
        raise ValueError("dit_block kernel: unexpected shapes")
    maskf = mask.float().contiguous()
    if maskf.shape != (b, t) or maskf.device != x.device:
        raise ValueError("dit_block kernel: mask must be [B, T] on x's device")
    cos, sin = rope_tables(t, d, x.device, rot)

    empty = lambda *s, dtype=x.dtype: torch.empty(s, device=x.device, dtype=dtype)
    h, q, k, v, att, h2, out = (empty(b, t, c) for _ in range(7))
    x1 = empty(b, t, c, dtype=torch.float32)
    y = empty(b, t, f)
    fn = _build.load("dit_block", "dit_block_forward", 22, 9, 1)
    err = fn(
        x.data_ptr(), mods.data_ptr(), maskf.data_ptr(), cos.data_ptr(), sin.data_ptr(),
        *(ten.data_ptr() for ten in w),
        h.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(), att.data_ptr(),
        x1.data_ptr(), h2.data_ptr(), y.data_ptr(), out.data_ptr(),
        b, t, c, f, n_heads, taps, int(act == "gelu_tanh"), rot // 2, int(x.dtype == torch.bfloat16), eps,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "dit_block")
    dit_block.launches += 1
    if x.dtype == torch.bfloat16:
        count_conv_paths((h, w.wqkv, c, 3 * c, t), (att, w.wo, c, c, t), (h2, w.w1, c, f, t, taps),
                         (y, w.w2, f, c, t, taps))
    return out


def dit_block(x, mods, mask, w: DiTWeights, n_heads: int, eps: float = 1e-5, rot: int | None = None,
              act: str = "silu"):
    """The DiT block on x's device: plain PyTorch on the CPU, the CUDA kernel
    on the GPU. `rot`: the rotary width of a head (default D/2); `act`: the
    FFN's activation, "silu" or "gelu_tanh"."""
    if x.device.type == "cpu":
        return dit_block_plain(x, mods, mask, w, n_heads, eps, rot, act)
    if x.device.type != "cuda":
        raise ValueError(f"dit_block runs on cpu or cuda, not {x.device}")
    return _dit_block_cuda(x, mods, mask, w, n_heads, eps, rot, act)


dit_block.launches = 0
