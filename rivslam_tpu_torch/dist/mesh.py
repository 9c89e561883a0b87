"""Process-group mesh and the data-axis helpers (port of
``rivslam_tpu/dist/mesh.py``).

The reference expresses scaling as a 2-axis ``jax.sharding.Mesh`` over
chips: ``data`` over independent sequences or frame pairs, ``model`` over
the points of one registration. Here the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group, with the same two axis names; each rank is one process (one
card with NCCL, one host process with gloo).

The programs are SPMD, as the reference's: every rank is given the full
inputs, works on its own part and returns the full, replicated result. A
``NamedSharding`` has no torch object, so the reference's
``data_sharding`` and ``replicated`` become ``local_slice`` (this rank's
contiguous part of a leading axis) and ``gather`` (the parts put back
together on every rank).
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

AXES = ("data", "model")


def init_world(backend: str, rank: int, world: int, init_file: str, timeout_s: float = 60.0) -> None:
    """Join the default process group of ``world`` ranks through a
    ``file://`` store at ``init_file`` (no network), with a bounded timeout
    for the rendezvous and every collective. With NCCL each rank takes the
    card ``rank % device_count``."""
    device_id = None
    if backend == "nccl":
        device_id = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device_id)
    dist.init_process_group(
        backend, init_method=f"file://{init_file}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s), device_id=device_id,
    )


def make_mesh(n_data: int, n_model: int, device_type: str | None = None) -> DeviceMesh:
    """An (n_data, n_model) mesh with axes ("data", "model") over the first
    n_data * n_model ranks of the initialised default group.
    ``device_type`` defaults to "cuda" under NCCL and "cpu" otherwise."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised default process group (dist.mesh.init_world)")
    world = dist.get_world_size()
    if world < n_data * n_model:
        raise ValueError(f"need {n_data * n_model} ranks, have {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.arange(n_data * n_model).reshape(n_data, n_model)
    return DeviceMesh(device_type, ranks, mesh_dim_names=AXES)


def local_slice(x: torch.Tensor, mesh: DeviceMesh, axis: str = "data") -> torch.Tensor:
    """This rank's contiguous part of the leading axis of ``x`` over
    ``axis``: rows [r * B/n, (r+1) * B/n) for axis rank r of n."""
    n = mesh[axis].size()
    B = x.shape[0]
    if B % n:
        raise ValueError(f"leading axis {B} is not divisible by the {axis!r} axis size {n}")
    r = mesh.get_local_rank(axis)
    return x[r * (B // n):(r + 1) * (B // n)]


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` stacked along the leading axis, in rank order."""
    n = dist.get_world_size(group)
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    gather_fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather_fn(out, x.contiguous(), group=group)
    return out


def gather(x: torch.Tensor, mesh: DeviceMesh, axis: str = "data") -> torch.Tensor:
    """The inverse of ``local_slice``: the parts of every rank of ``axis``
    put back together, on every rank."""
    return all_gather_rows(x, mesh.get_group(axis))


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (the reference's psum),
    as a new tensor; every rank receives the same values."""
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out
