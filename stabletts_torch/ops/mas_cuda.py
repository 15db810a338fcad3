"""Monotonic alignment search on the GPU: the CUDA kernel (csrc/mas.cu) and
the dispatch between it and the plain version (`ops/mas.py`).

Replaces the JAX package's TPU kernel `ops/mas_pallas.py::
maximum_path_pallas` with the same semantics (those of `ops/mas.py`). The
TPU kernel keeps its decision bits in VMEM and so only runs while they fit
(13 MiB); this one keeps them in device memory and runs at any B and Ty, and
at any Tx up to the limit `mas_max_tx()` reports (8192). It never falls back
to the plain version.

`mas` dispatches on the tensor's device: a CPU tensor takes the plain
version, a CUDA tensor the kernel (or an error). `mas.launches` counts kernel
launches.
"""

from __future__ import annotations

import torch

from stabletts_torch.ops.mas import maximum_path


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
    t_ys = mask[:, :, 0].sum(dim=1).to(torch.int32)
    t_xs = mask[:, 0, :].sum(dim=1).to(torch.int32)
    bits = torch.empty(b, t_y, t_x, device=neg.device, dtype=torch.uint8)
    path = torch.zeros(b, t_y, t_x, device=neg.device, dtype=torch.float32)
    fn = _build.load("mas", "mas_forward", 5, 3)
    err = fn(neg.data_ptr(), t_ys.data_ptr(), t_xs.data_ptr(), bits.data_ptr(), path.data_ptr(), b, t_y, t_x,
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
