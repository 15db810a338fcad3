"""Monotonic alignment search on the GPU: the CUDA kernel (csrc/mas.cu) and
the dispatch between it and the plain version (`ops/mas.py`).

Replaces the JAX package's TPU kernel `ops/mas_pallas.py::
maximum_path_pallas` with the same semantics (those of `ops/mas.py`). The
TPU kernel keeps its decision bits in VMEM and so only runs while they fit
(13 MiB); this one keeps them in shared memory where they fit there beside
its ring of raw rows (Ty * Tx / 8 bytes and the ring within 227 KB: [1000,
512] takes 157 KB) and otherwise in a device-memory workspace that the
wrapper allocates beside the path's row indices (`mas_plan` says which).
It runs at any B and Ty, and at any Tx up to the limit `mas_max_tx()`
reports (8192). A call is two launches, the DP with its backtrace and then
the path from the indices, which writes every element of the path, so the
path is allocated without zeros. It never falls back to the plain version.

`mas` dispatches on the tensor's device: a CPU tensor takes the plain
version, a CUDA tensor the kernel (or an error). `mas.launches` counts calls
that launch the kernels (one a call).
"""

from __future__ import annotations

import ctypes

import torch

from stabletts_torch.ops.mas import maximum_path


def mas_plan(b: int, t_y: int, t_x: int) -> dict:
    """How the kernel runs [b, t_y, t_x] (a CUDA build is needed): where its
    decision bits go ("shared" memory or a device-memory "workspace" of
    `workspace_bytes`), its chain warps an item and the cells a lane holds."""
    from stabletts_torch.ops import _build

    out = (ctypes.c_longlong * 4)()
    _build.load("mas", "mas_plan", 1, 3, stream=False)(ctypes.addressof(out), b, t_y, t_x)
    return {"bits": "shared" if out[1] else "workspace", "workspace_bytes": out[0], "warps": out[2],
            "cells_per_lane": out[3]}


def maximum_path_cuda(neg_cent: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """neg_cent [B, Ty, Tx] (f32), mask [B, Ty, Tx] on a CUDA device ->
    path [B, Ty, Tx] f32. No gradient."""
    from stabletts_torch.ops import _build

    if neg_cent.dim() != 3 or mask.shape != neg_cent.shape or mask.device != neg_cent.device:
        raise ValueError("mas kernel: neg_cent and mask must be [B, Ty, Tx] on one device")
    b, t_y, t_x = neg_cent.shape
    limit = _build.load("mas", "mas_max_tx", 0, 0, 0, stream=False)()
    if t_x > limit:
        raise ValueError(f"mas kernel: Tx={t_x} is over its limit of {limit}")
    neg = neg_cent.detach().float().contiguous()
    mask = mask.detach().float().contiguous()  # the kernel sums its lengths from mask[:, :, 0] and mask[:, 0, :]
    ws = torch.empty(mas_plan(b, t_y, t_x)["workspace_bytes"], device=neg.device, dtype=torch.uint8)
    path = torch.empty(b, t_y, t_x, device=neg.device, dtype=torch.float32)
    fn = _build.load("mas", "mas_forward", 4, 3)
    err = fn(neg.data_ptr(), mask.data_ptr(), ws.data_ptr(), path.data_ptr(), b, t_y, t_x,
             torch.cuda.current_stream(neg.device).cuda_stream)
    _build.check(err, "mas")
    mas.launches += 1
    return path


@torch.no_grad()
def mas(neg_cent: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """MAS on neg_cent's device: plain PyTorch on the CPU, the CUDA kernel on
    the GPU."""
    if neg_cent.device.type == "cpu":
        return maximum_path(neg_cent, mask)
    if neg_cent.device.type != "cuda":
        raise ValueError(f"mas runs on cpu or cuda, not {neg_cent.device}")
    return maximum_path_cuda(neg_cent, mask)


mas.launches = 0
