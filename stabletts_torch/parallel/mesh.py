"""Data parallelism across processes (the JAX package's `parallel/mesh.py`).

The JAX package runs one SPMD program over a device mesh: the batch is
sharded over the 'data' axis, parameters are replicated, XLA inserts the
gradient all-reduce, and every random draw and loss reduction is over the
global batch. Here each rank is one process (started by `torchrun`, or by
`init_distributed` with an explicit rendezvous) that holds its rows of the
global batch, and the same program is kept by hand:

  * `replicate` broadcasts parameters, buffers and optimizer state from rank 0;
  * `all_reduce_grads` sums (or averages) the gradients of one optimizer over
    one flat buffer after `backward()`, before any norm, clip or update. There
    is no DistributedDataParallel wrapper: the TTS step calls its model
    through `functional_call` (bf16) and `checkpoint` (remat), and the GAN
    step runs two backward passes, so one explicit reduction keeps every path
    the same;
  * `RowWindow` carries the trainer's generator with this rank's rows of the
    global batch. Every draw is made at the global batch's row count and the
    rank keeps its own rows (`rows_rand`), and the kernels' Philox counters
    take the rank's first row (`row0_of`), so W ranks draw what one process
    draws over the whole batch;
  * `all_reduce_sum` sums the loss normalisers and the logged losses.

Without a process group every collective here is skipped; in a group of one
each is an identity on the values, so both give the same bits.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterable, Optional, Sequence

import torch
import torch.distributed as dist

from stabletts_torch.utils.device import resolve_device


@dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel world."""
    rank: int
    world: int
    device: torch.device   # this rank's device (cuda:LOCAL_RANK in a group on the GPU)
    group: bool            # a process group is initialised: the collectives run


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def _group() -> bool:
    return dist.is_available() and dist.is_initialized()


def make_mesh(device=None) -> Mesh:
    """The world of the initialised process group, or a world of one without
    one. `device` as `resolve_device` reads it (the GPU unless "cpu"); in a
    group, a CUDA device without an index becomes cuda:LOCAL_RANK."""
    dev = resolve_device(device)
    if not _group():
        return Mesh(0, 1, dev, False)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _local_rank())
    return Mesh(dist.get_rank(), dist.get_world_size(), dev, True)


def init_distributed(backend: Optional[str] = None, device=None, init_method: str = "env://",
                     rank: Optional[int] = None, world_size: Optional[int] = None) -> Mesh:
    """Join the process group (the counterpart of `jax.distributed.initialize`)
    and return the mesh. Rank and world size default to torchrun's RANK and
    WORLD_SIZE; the backend to NCCL on the GPU and gloo on the CPU (or
    `backend`, e.g. "gloo" for several ranks on one card, which NCCL refuses).
    A group already initialised is kept."""
    if not _group():
        rank = int(os.environ.get("RANK", "0")) if rank is None else rank
        world_size = int(os.environ.get("WORLD_SIZE", "1")) if world_size is None else world_size
        dev = resolve_device(device)
        if backend is None:
            backend = "nccl" if dev.type == "cuda" else "gloo"
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index if dev.index is not None else _local_rank())
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size)
    return make_mesh(device)


@dataclass(frozen=True)
class BatchShard:
    """A rank's rows of one global batch: rows [row0, row0 + local_rows)."""
    local_rows: int
    global_rows: int
    row0: int


def shard_batch(mesh: Mesh, local_rows: int) -> BatchShard:
    """The bookkeeping of a global batch made of every rank's `local_rows`
    (the rank-strided sampler hands each rank the same count): W x local rows
    in all, this rank's first row rank x local."""
    return BatchShard(local_rows, mesh.world * local_rows, mesh.rank * local_rows)


def _coalesced(mesh: Mesh, tensors: Sequence[torch.Tensor], op) -> None:
    """Apply the collective `op(flat)` to `tensors` in place, one flat buffer
    per dtype on the mesh's device (NCCL takes device tensors only)."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1).to(mesh.device) for t in group])
        op(flat)
        for t, part in zip(group, torch.split(flat, [t.numel() for t in group])):
            t.detach().copy_(part.view_as(t))


def replicate(mesh: Mesh, *parts) -> None:
    """Broadcast each module's parameters and buffers and each optimizer's
    state tensors from rank 0, in place."""
    if not mesh.group:
        return
    tensors = []
    for part in parts:
        if isinstance(part, torch.nn.Module):
            tensors += [*part.parameters(), *part.buffers()]
        else:
            tensors += [v for state in part.state.values() for v in state.values() if torch.is_tensor(v)]
    _coalesced(mesh, tensors, lambda flat: dist.broadcast(flat, 0))


def all_reduce_grads(mesh: Mesh, params: Iterable[torch.nn.Parameter], average: bool = False) -> None:
    """Sum (or average) the gradients of `params` over the ranks, in place.
    Every parameter must have a gradient."""
    if not mesh.group:
        return

    def reduce(flat):
        dist.all_reduce(flat)
        if average:
            flat.div_(mesh.world)

    _coalesced(mesh, [p.grad for p in params], reduce)


def all_reduce_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Sum `t` over the ranks, in place; returns it."""
    if mesh.group:
        dist.all_reduce(t)
    return t


def barrier(mesh: Mesh) -> None:
    if mesh.group:
        dist.barrier()


# ---- row-windowed random draws ---------------------------------------------


@dataclass(frozen=True)
class RowWindow:
    """The trainer's generator and this rank's rows [row0, row0 + B) of a
    global batch of `rows` rows. The model's draw sites take it where they
    take a bare generator (a bare generator is the window of its own batch)."""
    generator: torch.Generator
    row0: int = 0
    rows: int = 0


def window(gen: torch.Generator, shard: BatchShard) -> RowWindow:
    return RowWindow(gen, shard.row0, shard.global_rows)


def generator_of(gen) -> Optional[torch.Generator]:
    return gen.generator if isinstance(gen, RowWindow) else gen


def row0_of(gen) -> int:
    """The first global row of the draws (the kernels' Philox row offset)."""
    return gen.row0 if isinstance(gen, RowWindow) else 0


def rows_rand(gen, shape, device, dtype=None, normal: bool = False) -> torch.Tensor:
    """torch.rand (or randn) of `shape`, whose first dimension is the local
    batch, drawn from the window's generator at the global batch's row count;
    returns this rank's rows. With the window over the whole batch it is the
    plain draw."""
    b = shape[0]
    row0 = row0_of(gen)
    rows = (gen.rows if isinstance(gen, RowWindow) else 0) or b
    if row0 + b > rows:
        raise ValueError(f"rows [{row0}, {row0 + b}) are outside the global batch of {rows}")
    draw = torch.randn if normal else torch.rand
    out = draw((rows, *shape[1:]), generator=generator_of(gen), device=device, dtype=dtype)
    return out if rows == b else out[row0:row0 + b]


def forked(gen, state: torch.Tensor):
    """A new generator on gen's device set to `state`, in gen's window (the
    remat recompute draws from it)."""
    g = torch.Generator(device=generator_of(gen).device)
    g.set_state(state)
    return RowWindow(g, gen.row0, gen.rows) if isinstance(gen, RowWindow) else g
