"""The tap GEMM of `csrc/common.cuh` on its own (csrc/tap_gemm.cu), its
weight-gradient GEMM and the column sums (csrc/wgrad.cu), and their plain
PyTorch versions.

    out[b * t_out + i, n] = sum_tap sum_k A_tap[b, i, k] * W_tap[k, n]

A_tap[b, i] is activation row t = row_stride * i + shift0 + tap * shift_step
of item b, zero outside [0, min(t_in, row_len[b])); its column k comes from a0 for
k < k_split and from a1 (column k - k_split) otherwise, up to k_in. W_tap is
read from w's storage at offset tap * w_tap_stride with row stride ldw, as
[k_in, N], or with `w_trans` as [N, k_in] and transposed. This is the
product inside the DiT kernels (k=3 convs and projections), ConvNeXt, the
training kernels' forward and input
gradients and the MPD stack's stride-3 convs (`row_stride` 3); on the card
bf16 runs on wgmma and f32 on fp32 FMA, in a CTA tile that `tap_gemm_tile`
names.

`tap_gemm` dispatches on the tensor's device: the plain version on the CPU,
the kernel on the GPU. `tap_gemm.launches` counts launches. The output is in
the activations' dtype (the sums are f32).

The bf16 kernel feeds its ring one of three ways, the path, and runs a 128 x
BN tile; `tap_gemm_path` and `tap_gemm_bn` state the rule (the C functions of
the same names in csrc/common.cuh, which `tap_gemm_route` reports from the
built library): "tma" where A is a plain [M, lda] matrix (one tap, no shift,
stride or row_len, k_split >= k_in), "producer_copy" for other A, "fallback"
where lda, ldw, w_tap_stride or k_split is not a multiple of 8 or a pointer
not 16-byte aligned; BN = 256 where N > 128 and the waves of the card's 132
SMs that the 128 x 256 tiles take are at most 2/3 of those of the 128 x 128
ones, else 128. While a profiler records, the bf16 wrappers count each tap
GEMM launch under `tap_gemm.<path>` (`count_conv_paths`).

The weight gradient of such a product, the backward product of #11, #12 and
#13 (the `WGrad` contract):

    out[tap, m, n] = sum_r A_tap[r, m] * G[r, n]      (f32)

with row r = b * t_len + t of a [B * t_len, lda] activation A and a
[B * t_len, ldg] gradient G; A_tap[r] is activation row t + shift0 + tap *
shift_step of item b, zero outside [0, t_len); m < ka, n < n_out. On the
card bf16 runs on wgmma and f32 on fp32 FMA, the rows in chunks whose
partials are added in a fixed order. `colsum` is the bias gradients' sum,
out[g, n] = sum_r x[g * rows + r, n] in f32. Both dispatch as `tap_gemm`
does and count their launches in `.launches`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.autograd import _profiler_enabled

from stabletts_torch.utils.metrics import count

NUM_SMS = 132  # the H100 SXM's, as csrc/common.cuh has it
TAP_PATHS = ("tma", "producer_copy", "fallback")  # csrc/common.cuh TapPath, in order


class TapGemmShape(NamedTuple):
    b: int
    lda: int
    k_split: int
    k_in: int
    n: int
    ldw: int
    w_tap_stride: int


def _shape(a0, w, t_in, taps, a1, k_split, k_in, w_trans, n_out, ldw, w_tap_stride) -> TapGemmShape:
    if a0.dim() != 2 or a0.shape[0] % t_in:
        raise ValueError(f"tap_gemm: a0 must be [B * t_in, lda] (t_in={t_in}, a0 {tuple(a0.shape)})")
    if a1 is not None and a1.shape != a0.shape:
        raise ValueError("tap_gemm: a1 must have a0's shape")
    lda = a0.shape[1]
    if k_in is None:
        k_in = lda if a1 is None else 2 * lda
    if k_split is None:
        k_split = k_in if a1 is None else lda
    if min(k_split, k_in) > lda or (k_split < k_in and k_in - k_split > lda):
        raise ValueError(f"tap_gemm: k_split={k_split}, k_in={k_in} do not fit rows of {lda}")
    if n_out is None:
        if w.dim() != 3 or w.shape[0] != taps:
            raise ValueError("tap_gemm: give n_out, ldw and w_tap_stride unless w is [taps, K, N] ([taps, N, K])")
        n_out = w.shape[1] if w_trans else w.shape[2]
        ldw = w.shape[2]
        w_tap_stride = w.shape[1] * w.shape[2]
    last = (taps - 1) * w_tap_stride + (n_out - 1) * (ldw if w_trans else 1) + (k_in - 1) * (1 if w_trans else ldw)
    if last >= w.numel():
        raise ValueError("tap_gemm: w is too small for its strides")
    return TapGemmShape(a0.shape[0] // t_in, lda, k_split, k_in, n_out, ldw, w_tap_stride)


def tap_gemm_plain(a0, w, *, t_in: int, t_out: int, taps: int = 1, shift0: int = 0, shift_step: int = 0,
                   a1=None, k_split=None, k_in=None, row_len=None, w_trans: bool = False, n_out=None, ldw=None,
                   w_tap_stride=None, row_stride: int = 1) -> torch.Tensor:
    """The TapGemm contract in plain PyTorch (f32 sums, one product per tap)."""
    s = _shape(a0, w, t_in, taps, a1, k_split, k_in, w_trans, n_out, ldw, w_tap_stride)
    a1 = a0 if a1 is None else a1
    ka = min(s.k_split, s.k_in)
    af = torch.cat([a0[:, :ka], a1[:, : s.k_in - ka]], dim=1).float().view(s.b, t_in, s.k_in)
    lim = torch.full((s.b,), t_in, device=a0.device)
    if row_len is not None:
        lim = torch.clamp(row_len.to(a0.device, torch.long), max=t_in)
    wf = w.reshape(-1).float()
    i = torch.arange(t_out, device=a0.device)
    out = torch.zeros(s.b * t_out, s.n, device=a0.device)
    for tap in range(taps):
        t = row_stride * i + shift0 + tap * shift_step
        valid = (t[None, :] >= 0) & (t[None, :] < lim[:, None])
        rows = af[:, t.clamp(0, t_in - 1)] * valid[..., None]
        off = wf.storage_offset() + tap * s.w_tap_stride
        if w_trans:
            wt = wf.as_strided((s.n, s.k_in), (s.ldw, 1), off).t()
        else:
            wt = wf.as_strided((s.k_in, s.n), (s.ldw, 1), off)
        out += rows.reshape(-1, s.k_in) @ wt
    return out.to(a0.dtype)


def tap_gemm_path(*, lda: int, k_in: int, k_split: int, ldw: int, w_tap_stride: int, t_in: int, t_out: int,
                  taps: int = 1, shift0: int = 0, row_stride: int = 1, row_len: bool = False,
                  ptrs: tuple = (0, 0, 0)) -> str:
    """The bf16 kernel's path for a launch with these TapGemm fields;
    `ptrs` are the data pointers of a0, a1 and w (16-byte alignment counts)."""
    a0, a1, w = (p % 16 == 0 for p in ptrs)
    vec_a = lda % 8 == 0 and a0 and (k_split >= k_in or (k_split % 8 == 0 and a1))
    vec_b = ldw % 8 == 0 and w_tap_stride % 8 == 0 and w
    if not (vec_a and vec_b):
        return "fallback"
    plain = taps == 1 and shift0 == 0 and row_stride == 1 and t_out == t_in and not row_len and k_split >= k_in
    return "tma" if plain else "producer_copy"


def tap_gemm_bn(m: int, n: int) -> int:
    """The width BN of the bf16 kernel's 128 x BN tile for an [m, n] output."""
    if n <= 128:
        return 128
    m_tiles = -(-m // 128)
    waves = lambda bn: -(-m_tiles * -(-n // bn) // NUM_SMS)
    return 256 if 3 * waves(256) <= 2 * waves(128) else 128


def conv_path(a: torch.Tensor, w: torch.Tensor, k_in: int, n_out: int, t: int, taps: int = 1,
              transposed: bool = False) -> str:
    """tap_gemm_path of csrc/common.cuh's conv_gemm(a, k_in, w, n_out, ., t,
    taps, transposed): a "same" conv along t, or a dense layer at one tap."""
    half = (taps - 1) // 2
    return tap_gemm_path(lda=k_in, k_in=k_in, k_split=k_in, ldw=k_in if transposed else n_out,
                         w_tap_stride=k_in * n_out, t_in=t, t_out=t, taps=taps, shift0=half if transposed else -half,
                         ptrs=(a.data_ptr(), a.data_ptr(), w.data_ptr()))


def count_conv_paths(*convs) -> None:
    """While a profiler records, adds one to `tap_gemm.<path>` for each bf16
    tap GEMM launch given as conv_path's arguments (a tuple each)."""
    if _profiler_enabled():
        for conv in convs:
            count("tap_gemm." + conv_path(*conv))


def _tap_gemm_cuda(a0, w, t_in, t_out, taps, shift0, shift_step, a1, k_split, k_in, row_len, w_trans, n_out, ldw,
                   w_tap_stride, row_stride) -> torch.Tensor:
    from stabletts_torch.ops import _build

    if a0.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"tap_gemm kernel takes float32 or bfloat16, got {a0.dtype}")
    s = _shape(a0, w, t_in, taps, a1, k_split, k_in, w_trans, n_out, ldw, w_tap_stride)
    a1 = a0 if a1 is None else a1
    for ten in (a0, a1, w):
        if ten.device != a0.device or ten.dtype != a0.dtype or not ten.is_contiguous():
            raise ValueError("tap_gemm kernel: a0, a1 and w must be contiguous tensors of one device and dtype")
    if row_len is None:
        lens = torch.empty(0, dtype=torch.int32, device=a0.device)
    else:
        lens = row_len.to(device=a0.device, dtype=torch.int32).contiguous()
        if lens.shape != (s.b,):
            raise ValueError("tap_gemm kernel: row_len must be [B]")
    m = s.b * t_out
    out = torch.empty(m, s.n, device=a0.device, dtype=a0.dtype)
    fn = _build.load("tap_gemm", "tap_gemm_forward", 5, 15)
    err = fn(
        a0.data_ptr(), a1.data_ptr(), lens.data_ptr() if row_len is not None else 0, w.data_ptr(), out.data_ptr(),
        s.k_split, s.lda, t_in, t_out, s.k_in, taps, shift0, shift_step, s.ldw, m, s.n, int(w_trans),
        s.w_tap_stride, row_stride, int(a0.dtype == torch.bfloat16),
        torch.cuda.current_stream(a0.device).cuda_stream,
    )
    _build.check(err, "tap_gemm")
    tap_gemm.launches += 1
    if a0.dtype == torch.bfloat16 and _profiler_enabled():
        count("tap_gemm." + tap_gemm_path(lda=s.lda, k_in=s.k_in, k_split=s.k_split, ldw=s.ldw,
                                          w_tap_stride=s.w_tap_stride, t_in=t_in, t_out=t_out, taps=taps,
                                          shift0=shift0, row_stride=row_stride, row_len=row_len is not None,
                                          ptrs=(a0.data_ptr(), a1.data_ptr(), w.data_ptr())))
    return out


def tap_gemm_route(a0, w, *, t_in: int, t_out: int, taps: int = 1, shift0: int = 0, shift_step: int = 0, a1=None,
                   k_split=None, k_in=None, row_len=None, w_trans: bool = False, n_out=None, ldw=None,
                   w_tap_stride=None, row_stride: int = 1) -> tuple:
    """(path, BN) that the built library's bf16 kernel takes for `tap_gemm`'s
    arguments, tensor maps made as a launch makes them (a CUDA build is
    needed; nothing is launched)."""
    from stabletts_torch.ops import _build

    s = _shape(a0, w, t_in, taps, a1, k_split, k_in, w_trans, n_out, ldw, w_tap_stride)
    a1 = a0 if a1 is None else a1
    lens = None if row_len is None else row_len.to(device=a0.device, dtype=torch.int32).contiguous()
    fn = _build.load("tap_gemm", "tap_gemm_route", 4, 14, stream=False)
    r = fn(a0.data_ptr(), a1.data_ptr(), 0 if lens is None else lens.data_ptr(), w.data_ptr(), s.k_split, s.lda,
           t_in, t_out, s.k_in, taps, shift0, shift_step, s.ldw, s.b * t_out, s.n, int(w_trans), s.w_tap_stride,
           row_stride)
    return TAP_PATHS[r % 10], r // 10


def tap_gemm(a0, w, *, t_in: int, t_out: int, taps: int = 1, shift0: int = 0, shift_step: int = 0, a1=None,
             k_split=None, k_in=None, row_len=None, w_trans: bool = False, n_out=None, ldw=None,
             w_tap_stride=None, row_stride: int = 1) -> torch.Tensor:
    """a0 (and a1) [B * t_in, lda], w as described above -> [B * t_out, N]
    in a0's dtype, on a0's device: the plain version on the CPU, the kernel
    on the GPU."""
    if a0.device.type == "cpu":
        return tap_gemm_plain(a0, w, t_in=t_in, t_out=t_out, taps=taps, shift0=shift0, shift_step=shift_step,
                              a1=a1, k_split=k_split, k_in=k_in, row_len=row_len, w_trans=w_trans, n_out=n_out,
                              ldw=ldw, w_tap_stride=w_tap_stride, row_stride=row_stride)
    if a0.device.type != "cuda":
        raise ValueError(f"tap_gemm runs on cpu or cuda, not {a0.device}")
    return _tap_gemm_cuda(a0, w, t_in, t_out, taps, shift0, shift_step, a1, k_split, k_in, row_len, w_trans, n_out,
                          ldw, w_tap_stride, row_stride)


tap_gemm.launches = 0


def tap_gemm_tile(m: int, n: int, dtype) -> str:
    """The CTA tile ("BMxBN") that the kernel runs for an [m, n] output in
    `dtype`, as the built library chooses it (a CUDA build is needed)."""
    from stabletts_torch.ops import _build

    t = _build.load("tap_gemm", "tap_gemm_tile", 0, 3, stream=False)(m, n, int(dtype == torch.bfloat16))
    return f"128x{t}" if dtype == torch.bfloat16 else f"{t}x{t}"


def _wgrad_shape(a, g, t_len, ka, n_out):
    if a.dim() != 2 or g.dim() != 2 or a.shape[0] != g.shape[0] or a.shape[0] % t_len:
        raise ValueError(f"wgrad: a and g must be [B * t_len, lda] and [B * t_len, ldg] (t_len={t_len}, "
                         f"a {tuple(a.shape)}, g {tuple(g.shape)})")
    ka = a.shape[1] if ka is None else ka
    n_out = g.shape[1] if n_out is None else n_out
    if not (0 < ka <= a.shape[1] and 0 < n_out <= g.shape[1]):
        raise ValueError(f"wgrad: ka={ka}, n_out={n_out} do not fit a {tuple(a.shape)}, g {tuple(g.shape)}")
    return ka, n_out


def wgrad_plain(a, g, *, t_len: int, taps: int = 1, shift0: int = 0, shift_step: int = 0, ka=None,
                n_out=None) -> torch.Tensor:
    """The WGrad contract in plain PyTorch: [taps, ka, n_out] f32, one
    product per tap."""
    ka, n_out = _wgrad_shape(a, g, t_len, ka, n_out)
    rows = a.shape[0]
    af = a[:, :ka].float().view(rows // t_len, t_len, ka)
    gf = g[:, :n_out].float()
    t = torch.arange(t_len, device=a.device)
    out = torch.empty(taps, ka, n_out, device=a.device)
    for tap in range(taps):
        src = t + shift0 + tap * shift_step
        valid = ((src >= 0) & (src < t_len)).float()
        shifted = af[:, src.clamp(0, t_len - 1)] * valid[None, :, None]
        out[tap] = shifted.reshape(rows, ka).t() @ gf
    return out


def _wgrad_cuda(a, g, t_len, taps, shift0, shift_step, ka, n_out) -> torch.Tensor:
    from stabletts_torch.ops import _build

    if a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"wgrad kernel takes float32 or bfloat16, got {a.dtype}")
    ka, n_out = _wgrad_shape(a, g, t_len, ka, n_out)
    if g.device != a.device or g.dtype != a.dtype or not (a.is_contiguous() and g.is_contiguous()):
        raise ValueError("wgrad kernel: a and g must be contiguous tensors of one device and dtype")
    out = torch.empty(taps, ka, n_out, device=a.device, dtype=torch.float32)
    ws = torch.empty(_build.WGRAD_WS_FLOATS, device=a.device, dtype=torch.float32)
    fn = _build.load("wgrad", "wgrad_forward", 4, 11)
    err = fn(a.data_ptr(), g.data_ptr(), out.data_ptr(), ws.data_ptr(), a.shape[1], ka, g.shape[1], n_out,
             a.shape[0], t_len, shift0, shift_step, taps, ws.numel(), int(a.dtype == torch.bfloat16),
             torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "wgrad")
    wgrad.launches += 1
    return out


def wgrad(a, g, *, t_len: int, taps: int = 1, shift0: int = 0, shift_step: int = 0, ka=None,
          n_out=None) -> torch.Tensor:
    """a [B * t_len, lda], g [B * t_len, ldg] -> [taps, ka, n_out] f32 on a's
    device: the plain version on the CPU, the kernel on the GPU."""
    if a.device.type == "cpu":
        return wgrad_plain(a, g, t_len=t_len, taps=taps, shift0=shift0, shift_step=shift_step, ka=ka, n_out=n_out)
    if a.device.type != "cuda":
        raise ValueError(f"wgrad runs on cpu or cuda, not {a.device}")
    return _wgrad_cuda(a, g, t_len, taps, shift0, shift_step, ka, n_out)


wgrad.launches = 0


def wgrad_tile(dtype) -> str:
    """The CTA tile ("BMxBN", over ka x n) of the weight-gradient kernel in
    `dtype`, as the built library has it (a CUDA build is needed)."""
    from stabletts_torch.ops import _build

    t = _build.load("wgrad", "wgrad_tile", 0, 1, stream=False)(int(dtype == torch.bfloat16))
    return f"{t}x{t}"


def _colsum_shape(x, groups):
    if x.dim() != 2 or groups < 1 or x.shape[0] % groups:
        raise ValueError(f"colsum: x must be [groups * rows, N] (groups={groups}, x {tuple(x.shape)})")
    return x.shape[0] // groups, x.shape[1]


def colsum_plain(x, groups: int = 1) -> torch.Tensor:
    """x [groups * rows, N] -> [groups, N] f32: each group's column sums."""
    rows, n = _colsum_shape(x, groups)
    return x.float().view(groups, rows, n).sum(1)


def colsum(x, groups: int = 1) -> torch.Tensor:
    """The column sums on x's device: the plain version on the CPU, the
    kernel on the GPU."""
    if x.device.type == "cpu":
        return colsum_plain(x, groups)
    if x.device.type != "cuda":
        raise ValueError(f"colsum runs on cpu or cuda, not {x.device}")
    from stabletts_torch.ops import _build

    if x.dtype not in (torch.float32, torch.bfloat16) or not x.is_contiguous():
        raise ValueError("colsum kernel takes a contiguous float32 or bfloat16 tensor")
    rows, n = _colsum_shape(x, groups)
    out = torch.empty(groups, n, device=x.device, dtype=torch.float32)
    ws = torch.empty(_build.WGRAD_WS_FLOATS, device=x.device, dtype=torch.float32)
    fn = _build.load("wgrad", "colsum_forward", 3, 5)
    err = fn(x.data_ptr(), out.data_ptr(), ws.data_ptr(), groups, rows, n, ws.numel(),
             int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "colsum")
    colsum.launches += 1
    return out


colsum.launches = 0
