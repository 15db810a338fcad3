"""Packed-head attention variants of the attention microbenchmark: CUDA
kernels (csrc/attention_variants.cu), their plain PyTorch versions, and
adapters onto the port's packed-attention kernels.

    out_h = softmax2(q'_h k_h^T + key_bias) v_h,   q' = round(q * log2(e)/sqrt(D))

Replaces the JAX package's TPU kernels
  - `ops/attention_pallas_v2.py::fused_attention_packed` -> `attention_packed_v2`:
    q pre-scaled by log2(e)/sqrt(D) and rounded to its dtype, softmax in exp2;
  - `ops/attention_pallas.py::fused_attention_packed_rope` ->
    `attention_packed_rope`: the same on q and k rotated by partial RoPE,
    each product and the sum rounded to the dtype; on the card two kernels,
    the rotation (`rope_rotate_packed`) and then the v2 core on the rotated
    q and k;
  - `tools/attn_exp4.py::run_kt` -> `attention_packed_kt`: K given
    channel-major, [B, C, T];
  - `tools/attn_exp2.py::run` -> `attention_decompose(which=...)`: "matmul"
    (out = round(q' k^T) v, no softmax), "nomax" (w = exp2(s + bias), no max;
    "nomax_bf16" is the same math), "bf16" (scores and bias rounded to bf16,
    the weights exp2(s - max) in f32 rounded to bf16, the normaliser their f32
    sum: XLA folds the TPU body's bf16 s - m into the f32 exp2's argument);
and, as adapters onto a kernel that computes the same function,
`tools/attn_exp.py::run_pair` (`attention_head_pair`),
`tools/attn_exp3.py::run_flash` (`attention_flash_chunks`) and
`tools/attn_exp5.py::run_bpair` (`attention_batch_pair`).

Every function takes [B, T, H*64] operands (K of `attention_packed_kt`:
[B, H*64, T]); `mask` ([B, T], 1 = valid, or None) masks keys only, with the
finite bias -0.7*f32max, so padded query rows come out finite and the caller
masks them. Softmax statistics in f32, the weights rounded to v's dtype
before the PV product, the normaliser the unrounded f32 sum (the "bf16" mode:
the sum of the rounded weights).

The wrappers dispatch on the tensor's device: a CPU tensor takes the plain
version, a CUDA tensor the kernel (or an error). `attention_packed_v2`,
`attention_packed_rope` (one count a call: the rotation and the core),
`rope_rotate_packed` and `attention_packed_kt` count kernel launches in
`.launches`; `attention_decompose.launches` is a dict by mode.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from stabletts_torch.ops import attention_packed_cuda as _ap
from stabletts_torch.ops.dit_block_cuda import _LOG2E, _NEG, attention_exp2

DECOMPOSE_MODES = {"matmul": 0, "nomax": 1, "bf16": 2}


# ------------------------------------------------------------- RoPE tables --


_tables: dict = {}


def rope_packed_tables(t: int, n_heads: int, head_dim: int = 64, rotary_dim: int = 32,
                       dtype=torch.float32, device="cpu") -> tuple:
    """Full-width cos/sin tables [T, H*D] for packed-layout partial RoPE, in
    `dtype`: the first `rotary_dim` features of each head carry
    cos/sin(t * theta_i), theta_i = 10000^(-2i/rotary_dim) for each half, the
    others cos 1 and sin 0. The angles are f32; cos and sin are taken in f64
    and rounded once (the JAX package's f32 cos/sin agree to the last bit in
    bf16 and within one f32 ulp). Made once per shape, dtype and device and
    shared: callers must not write to them."""
    key = (t, n_heads, head_dim, rotary_dim, dtype, str(device))
    if key not in _tables:
        if len(_tables) > 32:
            _tables.clear()
        half, rest = rotary_dim // 2, head_dim - rotary_dim
        theta = 1.0 / (10_000.0 ** (torch.arange(0, rotary_dim, 2, dtype=torch.float32) / rotary_dim))
        idx = torch.arange(t, dtype=torch.float32)[:, None] * theta[None, :half]
        idx = torch.cat([idx, idx], dim=1).double()
        cos = torch.cat([torch.cos(idx).float(), torch.ones(t, rest)], dim=1).repeat(1, n_heads)
        sin = torch.cat([torch.sin(idx).float(), torch.zeros(t, rest)], dim=1).repeat(1, n_heads)
        _tables[key] = (cos.to(device, dtype), sin.to(device, dtype))
    return _tables[key]


def apply_rope_packed(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, n_heads: int,
                      rotary_dim: int) -> torch.Tensor:
    """x [B, T, H*D] -> x*cos + neg_half(x)*sin in x's dtype, each product and
    the sum rounded to it; neg_half(x) = [-x[half:rot], x[:half], 0...] per
    head (the JAX package's signed permutation matrix, which is exact)."""
    b, t, c = x.shape
    half = rotary_dim // 2
    xh = x.view(b, t, n_heads, c // n_heads)
    neg = torch.cat([-xh[..., half:rotary_dim], xh[..., :half], torch.zeros_like(xh[..., rotary_dim:])], dim=-1)
    return x * cos + neg.reshape(b, t, c) * sin


# --------------------------------------------------------- plain versions --


def _prescale(q: torch.Tensor, n_heads: int) -> torch.Tensor:
    d = q.shape[-1] // n_heads
    return (q.float() * (_LOG2E / math.sqrt(d))).to(q.dtype)


def _v2_core(qs, k, v, mask, n_heads: int) -> torch.Tensor:
    b, t, c = qs.shape
    if mask is None:
        mask = torch.ones(b, t, device=qs.device)
    hd = (b, t, n_heads, c // n_heads)
    return attention_exp2(qs.view(hd), k.view(hd), v.view(hd), mask).reshape(b, t, c).to(qs.dtype)


def attention_packed_v2_plain(q, k, v, mask: Optional[torch.Tensor] = None, n_heads: int = 4) -> torch.Tensor:
    """q/k/v [B, T, H*D]; mask [B, T] or None -> [B, T, H*D] in q's dtype."""
    return _v2_core(_prescale(q, n_heads), k, v, mask, n_heads)


def rope_rotate_packed_plain(q, k, n_heads: int = 4, rotary_dim: int = 32, tables: Optional[tuple] = None) -> tuple:
    """(RoPE(round(q * log2(e)/sqrt(D))), RoPE(k)) in q's dtype, each product
    and the sum rounded to it; q/k [B, T, H*D]. `tables` (cos, sin) [T, H*D]
    in q's dtype, or None for `rope_packed_tables`."""
    b, t, c = q.shape
    cos, sin = tables if tables is not None else rope_packed_tables(t, n_heads, c // n_heads, rotary_dim, q.dtype,
                                                                    q.device)
    return (apply_rope_packed(_prescale(q, n_heads), cos, sin, n_heads, rotary_dim),
            apply_rope_packed(k, cos, sin, n_heads, rotary_dim))


def attention_packed_rope_plain(q, k, v, mask: Optional[torch.Tensor] = None, n_heads: int = 4,
                                rotary_dim: int = 32) -> torch.Tensor:
    """The v2 core (q not scaled again) on `rope_rotate_packed_plain`'s
    rotated q and k; q/k/v unrotated [B, T, H*D]."""
    return _v2_core(*rope_rotate_packed_plain(q, k, n_heads, rotary_dim), v, mask, n_heads)


def attention_packed_kt_plain(q, kt, v, mask: Optional[torch.Tensor] = None, n_heads: int = 4) -> torch.Tensor:
    """q/v [B, T, H*D], kt [B, H*D, T] -> [B, T, H*D]."""
    return attention_packed_v2_plain(q, kt.transpose(1, 2).contiguous(), v, mask, n_heads)


def attention_decompose_plain(q, k, v, which: str = "nomax", n_heads: int = 4) -> torch.Tensor:
    """The v2 product with the softmax of `which` (see the module docstring);
    every key valid. q/k/v [B, T, H*D] -> [B, T, H*D] in q's dtype."""
    which = _mode(which)
    b, t, c = q.shape
    hd = (b, t, n_heads, c // n_heads)
    qs, kh, vh = _prescale(q, n_heads).view(hd), k.view(hd), v.view(hd).float()
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), kh.float())
    denom = None
    if which == "matmul":
        w = s.to(v.dtype).float()
    elif which == "nomax":
        w = torch.exp2(s)
        denom = w.sum(dim=-1, keepdim=True)
        w = w.to(v.dtype).float()
    else:
        sb = s.to(torch.bfloat16).float()
        w = torch.exp2(sb - sb.amax(dim=-1, keepdim=True)).to(torch.bfloat16).float()
        denom = w.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bhqd", w, vh)
    if denom is not None:
        o = o / denom
    return o.permute(0, 2, 1, 3).reshape(b, t, c).to(q.dtype)


def _mode(which: str) -> str:
    which = "nomax" if which == "nomax_bf16" else which
    if which not in DECOMPOSE_MODES:
        raise ValueError(f"attention_decompose: which must be one of matmul, nomax, nomax_bf16, bf16, not {which!r}")
    return which


# ---------------------------------------------------------------- kernels --


def _check(entry: str, q, k, v, n_heads: int, mask, kt: bool = False):
    """Raises on what the kernel does not take; returns the mask's pointer
    (0 for None) and the f32 mask to keep alive over the launch."""
    b, t, c = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{entry} kernel takes float32 or bfloat16, got {q.dtype}")
    if c != n_heads * 64:
        raise ValueError(f"{entry} kernel needs head_dim 64 (H*D={c}, heads={n_heads})")
    if v.shape != q.shape or k.shape != ((b, c, t) if kt else q.shape):
        raise ValueError(f"{entry} kernel: q and v must be [B, T, C] and k {'[B, C, T]' if kt else 'the same'}")
    for ten in (q, k, v):
        if ten.device != q.device or ten.dtype != q.dtype or not ten.is_contiguous():
            raise ValueError(f"{entry} kernel: operands must be contiguous and share device and dtype")
    if mask is None:
        return 0, None
    maskf = mask.float().contiguous()
    if maskf.shape != (b, t) or maskf.device != q.device:
        raise ValueError(f"{entry} kernel: mask must be [B, T] on q's device")
    return maskf.data_ptr(), maskf


def _run(entry: str, n_ptr: int, ptrs: list, ints: list, q) -> None:
    from stabletts_torch.ops import _build

    fn = _build.load("attention_variants", f"{entry}_forward", n_ptr, len(ints) + 1)
    err = fn(*ptrs, *ints, int(q.dtype == torch.bfloat16), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, entry)


def _device_ok(name: str, q) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (take the plain version); raises for any other device."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {q.device}")
    return True


def attention_packed_v2(q, k, v, mask: Optional[torch.Tensor] = None, n_heads: int = 4) -> torch.Tensor:
    """#9: packed-head attention with q pre-scaled in its dtype and an exp2
    softmax, on q's device."""
    if not _device_ok("attention_packed_v2", q):
        return attention_packed_v2_plain(q, k, v, mask, n_heads)
    b, t, c = q.shape
    mask_ptr, _keep = _check("attention_packed_v2", q, k, v, n_heads, mask)
    out = torch.empty_like(q)
    _run("attention_packed_v2", 5, [q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr()],
         [b, t, c, n_heads], q)
    attention_packed_v2.launches += 1
    return out


def _check_rotary(name: str, q, n_heads: int, rotary_dim: int) -> None:
    if rotary_dim < 0 or rotary_dim % 2 or rotary_dim > q.shape[-1] // n_heads:
        raise ValueError(f"{name}: rotary_dim must be even and <= head_dim, got {rotary_dim}")


def rope_rotate_packed(q, k, n_heads: int = 4, rotary_dim: int = 32) -> tuple:
    """The first of #7's two kernels: (RoPE(round(q * log2(e)/sqrt(D))),
    RoPE(k)) in q's dtype, on q's device; q/k unrotated [B, T, H*D]. On the
    card both land in one workspace [2, B, T, H*D] allocated here with
    torch.empty (65.5 MB in bf16, 131 MB in f32 at B=64, T=1000, H=4)."""
    _check_rotary("rope_rotate_packed", q, n_heads, rotary_dim)
    if not _device_ok("rope_rotate_packed", q):
        return rope_rotate_packed_plain(q, k, n_heads, rotary_dim)
    b, t, c = q.shape
    _check("rope_rotate_packed", q, k, k, n_heads, None)
    cos, sin = rope_packed_tables(t, n_heads, c // n_heads, rotary_dim, q.dtype, q.device)
    ws = torch.empty((2, b, t, c), dtype=q.dtype, device=q.device)
    _run("rope_packed", 6, [q.data_ptr(), k.data_ptr(), cos.data_ptr(), sin.data_ptr(), ws[0].data_ptr(),
                            ws[1].data_ptr()], [b, t, c, n_heads, rotary_dim], q)
    rope_rotate_packed.launches += 1
    return ws[0], ws[1]


def attention_packed_rope(q, k, v, mask: Optional[torch.Tensor] = None, n_heads: int = 4,
                          rotary_dim: int = 32) -> torch.Tensor:
    """#7: `attention_packed_v2` with partial RoPE of `rotary_dim` features
    per head applied to q and k; q/k/v unrotated. On the card two launches:
    `rope_rotate_packed` (its workspace lives until the core has run), then
    the v2 core on the rotated q and k with no pre-scaling."""
    _check_rotary("attention_packed_rope", q, n_heads, rotary_dim)
    if not _device_ok("attention_packed_rope", q):
        return attention_packed_rope_plain(q, k, v, mask, n_heads, rotary_dim)
    b, t, c = q.shape
    mask_ptr, _keep = _check("attention_packed_rope", q, k, v, n_heads, mask)
    out = _rope_core(*rope_rotate_packed(q, k, n_heads, rotary_dim), v, mask_ptr, n_heads)
    attention_packed_rope.launches += 1
    return out


def _rope_core(qr, kr, v, mask_ptr: int, n_heads: int) -> torch.Tensor:
    """The second of #7's kernels: the v2 core on `rope_rotate_packed`'s
    outputs, q not scaled again (CUDA tensors, checked by the caller)."""
    b, t, c = qr.shape
    out = torch.empty_like(qr)
    _run("attention_packed_rope", 5, [qr.data_ptr(), kr.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr()],
         [b, t, c, n_heads], qr)
    return out


def attention_packed_kt(q, kt, v, mask: Optional[torch.Tensor] = None, n_heads: int = 4) -> torch.Tensor:
    """17d: the v2 function with K channel-major: q/v [B, T, H*D], kt
    [B, H*D, T] (read with t contiguous, never transposed in memory)."""
    if not _device_ok("attention_packed_kt", q):
        return attention_packed_kt_plain(q, kt, v, mask, n_heads)
    b, t, c = q.shape
    mask_ptr, _keep = _check("attention_packed_kt", q, kt, v, n_heads, mask, kt=True)
    out = torch.empty_like(q)
    _run("attention_packed_kt", 5, [q.data_ptr(), kt.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr()],
         [b, t, c, n_heads], q)
    attention_packed_kt.launches += 1
    return out


def attention_decompose(q, k, v, which: str = "nomax", n_heads: int = 4) -> torch.Tensor:
    """17b: the v2 product with another softmax, `which` in matmul, nomax
    (or nomax_bf16, the same math), bf16; every key valid."""
    which = _mode(which)
    if not _device_ok("attention_decompose", q):
        return attention_decompose_plain(q, k, v, which, n_heads)
    b, t, c = q.shape
    _check("attention_decompose", q, k, v, n_heads, None)
    out = torch.empty_like(q)
    _run("attention_decompose", 4, [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()],
         [b, t, c, n_heads, DECOMPOSE_MODES[which]], q)
    attention_decompose.launches[which] += 1
    return out


attention_packed_v2.launches = 0
attention_packed_rope.launches = 0
rope_rotate_packed.launches = 0
attention_packed_kt.launches = 0
attention_decompose.launches = {mode: 0 for mode in DECOMPOSE_MODES}


# --------------------------------------------------------------- adapters --


def attention_head_pair(q, k, v, n_heads: int = 4) -> torch.Tensor:
    """17a, `tools/attn_exp.py::run_pair`: two heads per product against a
    block-diagonal K, every key valid. The function is #9's without a mask,
    so this is `attention_packed_v2`. The pairing only filled the TPU MXU's
    128 lanes with two 64-wide heads; a Hopper CTA already takes one head
    per 64-wide tile, so it has no counterpart here."""
    return attention_packed_v2(q, k, v, None, n_heads)


def attention_flash_chunks(q, k, v, mask: Optional[torch.Tensor] = None, n_heads: int = 4) -> torch.Tensor:
    """17c, `tools/attn_exp3.py::run_flash`: online softmax over key chunks.
    The function is #9's, and the port's kernel already is an online softmax
    over 64-key chunks, so this is `attention_packed_v2`. The experiment's
    `blk_q` and `kc` sized tiles for VMEM and the score tile for vector
    registers; the kernel's 64 x 64 tiles are fixed, so it takes neither."""
    return attention_packed_v2(q, k, v, mask, n_heads)


def attention_batch_pair(q, k, v, kbias: torch.Tensor, n_heads: int = 4) -> torch.Tensor:
    """17e, `tools/attn_exp5.py::run_bpair`: two batch items per grid cell
    against a block-diagonal K/V, f32 scores scaled by log2(e)/sqrt(D) inside
    the kernel (#6's numerics) with an additive key bias [B, 1, T] of 0 or
    -0.7*f32max. That is `attention_packed` with the bias as a mask; any other
    bias value raises. Batch pairing filled the TPU MXU's 128 lanes; a Hopper
    CTA works on one (head, item) tile, so it has no counterpart here."""
    b, t, c = q.shape
    if kbias.shape != (b, 1, t):
        raise ValueError(f"attention_batch_pair: kbias must be [B, 1, T] = {(b, 1, t)}, got {tuple(kbias.shape)}")
    kb = kbias.float()
    if not bool(((kb == 0.0) | (kb == _NEG)).all()):
        raise ValueError("attention_batch_pair: kbias takes only 0 (valid key) and -0.7*f32max (padded key)")
    return _ap.attention_packed(q, k, v, (kb[:, 0, :] == 0.0).float(), n_heads)
