"""Process groups and the (data, model) mesh on ``torch.distributed``.

Port of ``movie_recommendation_engine_tpu/parallel/mesh.py``. JAX runs one
controller over every device; the port runs one process per rank, as
``torchrun`` starts them, and every collective is an explicit call
(``parallel/collectives.py``). Axes:

- ``data``  — the batch: each rank takes its share of a step's rows, and
  gradients are summed over every rank;
- ``model`` — row sharding of the node tables: model coordinate ``s`` of
  ``m`` holds rows ``[s*C, (s+1)*C)`` of every row-sharded table, with
  ``C = N_pad / m`` (``pad_to_multiple``).

A rank's device is ``cuda:{LOCAL_RANK % device_count}``, or the CPU when the
caller asks for it. NCCL serves CUDA tensors and needs one device a rank;
gloo serves the CPU, and CUDA tensors only where the caller names it (two
ranks sharing one card), staged through the host by the collectives.
"""

from __future__ import annotations

import os
import time
from datetime import timedelta
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "model")
_TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def distributed_init(backend: str | None = None, init_method: str | None = None,
                     world_size: int | None = None, rank: int | None = None,
                     init_timeout_s: int | None = None) -> bool:
    """Join the process group ``torchrun`` describes (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), or the one given by
    ``init_method`` / ``world_size`` / ``rank``. Returns False and does
    nothing without either (the single-process path); True once joined,
    and again on every later call (the CLI calls it on every entry).

    ``backend`` defaults to ``nccl`` where CUDA is available, else ``gloo``.
    NCCL needs one device a rank: more local ranks than devices raise here,
    before NCCL would. ``init_timeout_s`` (env ``MRE_INIT_TIMEOUT_S``,
    default 300, as JAX's rendezvous) bounds the rendezvous and every later
    collective, so a dead peer fails the run instead of hanging it."""
    if dist.is_initialized():
        return True
    if init_method is None:
        if not all(v in os.environ for v in _TORCHRUN_VARS):
            return False
        init_method = "env://"
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    rank = int(os.environ["RANK"]) if rank is None else rank
    if init_timeout_s is None:
        init_timeout_s = int(os.environ.get("MRE_INIT_TIMEOUT_S", "300"))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        count = torch.cuda.device_count()
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        if count == 0 or local > count:
            raise RuntimeError(
                f"NCCL needs one CUDA device a rank: {local} local ranks, {count} "
                "devices; run fewer ranks a host, or backend='gloo' to share a device")
        torch.cuda.set_device(local_rank() % count)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=timedelta(seconds=init_timeout_s))
    return True


def run_local(fn, world: int, *args, timeout: float = 120.0) -> None:
    """``fn(rank, world, *args)`` in ``world`` fresh (spawned) processes of
    this host, which join a group themselves (``distributed_init`` with a
    ``file://`` rendezvous); waits for all, kills any still running after
    ``timeout`` seconds, and raises if one did not exit 0. ``fn`` must be
    importable by name (a module-level function)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=fn, args=(r, world) + args) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if hung:
        raise TimeoutError(f"ranks {hung} still ran after {timeout} s and were killed")
    failed = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
    if failed:
        raise RuntimeError(f"ranks failed (rank: exit code): {failed}")


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_coordinator() -> bool:
    """True on the rank that writes shared files (checkpoints, exports):
    rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier(tag: str = "barrier") -> None:
    """Returns once every rank has reached it; a no-op in a world of one.
    ``tag`` names the sync point in a timeout's error."""
    if world_size() <= 1:
        return
    try:
        dist.barrier()
    except RuntimeError as e:
        raise RuntimeError(f"barrier {tag!r} failed: {e}") from e


def rank_device(device: torch.device) -> torch.device:
    """The rank's device: ``cuda:{LOCAL_RANK % device_count}`` for a CUDA
    request without an index, else ``device`` as given."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", local_rank() % torch.cuda.device_count())
    return device


def make_mesh(shape: tuple[int, int] | None = None):
    """The 2-D ``DeviceMesh`` with dims ``("data", "model")`` over every rank
    (default: all on ``data``). Its process groups use the default group's
    backend."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs a process group: start under torchrun, or call "
            "parallel.mesh.distributed_init first")
    n = dist.get_world_size()
    shape = (n, 1) if shape is None else tuple(int(s) for s in shape)
    if len(shape) != 2 or shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=AXES)


def axis_size(mesh, axis: str) -> int:
    return int(mesh.size(mesh.mesh_dim_names.index(axis)))


def axis_index(mesh, axis: str) -> int:
    return int(mesh.get_local_rank(axis))


def axis_group(mesh, axis: str):
    return mesh.get_group(axis)


def mesh_rank(mesh) -> int:
    """The rank's place in data-major order (``data * m + model``), the order
    the batch is shared in."""
    return axis_index(mesh, "data") * axis_size(mesh, "model") + axis_index(mesh, "model")


class RowShard(NamedTuple):
    """The rank's rows of the tables row-sharded over the model axis: rows
    ``[start, stop)`` of ``total``."""

    group: Any     # the model axis's process group
    index: int     # model coordinate s
    size: int      # m
    rows: int      # C = total / m

    @property
    def start(self) -> int:
        return self.index * self.rows

    @property
    def stop(self) -> int:
        return self.start + self.rows

    @property
    def total(self) -> int:
        return self.rows * self.size


class BatchStats(NamedTuple):
    """Batch norm over rows shared by a group: ``rows`` in all."""

    group: Any
    rows: int


def row_shard(mesh, total_rows: int) -> RowShard:
    """The rank's row range of a ``total_rows`` table (a multiple of the
    model axis) — the counterpart of JAX's ``row_sharding``."""
    m = axis_size(mesh, "model")
    if total_rows % m:
        raise ValueError(f"{total_rows} rows do not divide the model axis ({m})")
    return RowShard(axis_group(mesh, "model"), axis_index(mesh, "model"), m, total_rows // m)


def share_sizes(n: int, parts: int) -> list[int]:
    """Rows of each of ``parts`` contiguous shares of ``n`` (the first
    ``n % parts`` one larger), as ``np.array_split``."""
    return [n // parts + (i < n % parts) for i in range(parts)]


def batch_slice(n: int, rank: int, parts: int) -> slice:
    """Share ``rank`` of ``n`` batch rows split over ``parts`` ranks — the
    counterpart of JAX's ``batch_sharding``, over every rank."""
    sizes = share_sizes(n, parts)
    start = sum(sizes[:rank])
    return slice(start, start + sizes[rank])


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0, value=0):
    """Pad an array so dim ``axis`` divides ``multiple`` (sharding needs
    evenly divisible global shapes)."""
    n = x.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return x, n
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, constant_values=value), n
