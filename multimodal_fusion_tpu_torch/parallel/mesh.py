"""Process mesh and data-parallel helpers on ``torch.distributed``
(counterpart of ``multimodal_fusion_tpu.parallel.mesh``).

The JAX package runs one process over N devices and lets GSPMD partition
the program from the arguments' shardings.  The port runs one process per
rank (``torchrun``, or the gang of ``parallel.multihost``) with explicit
collectives.  A ``Mesh`` is the small object that names them: the process
group, the mesh shape and axis names, this rank and its device.

- ``make_mesh(n)`` is a 1-axis ``("data",)`` mesh over the world of n
  ranks; ``make_mesh_2d(r, d)`` a ``("replica", "data")`` mesh with replica
  the slow (outer) axis: rank = replica_index * d + data_index, so the ranks
  of one replica are contiguous, as a host's cards are.  Batches split over
  both axes (r * d ways) and ``all_reduce_grads`` reduces over ``data``
  first, then over ``replica``: only the partial sums cross the slow axis.
- ``mesh_from_shape`` keeps the JAX rule: ``None`` for no shape, and a
  message plus ``None`` ("running unsharded") when the world has fewer
  ranks than the shape needs.  A process that no launcher started is a
  world of 1.
- ``place_batch`` keeps this rank's contiguous rows of a batch (axis 0, or
  axis 1 of a stacked scan group); a leaf whose batch dim does not divide
  the mesh stays whole on every rank (per leaf, or for the whole tree when
  ``batch_size`` is given).  Every rank builds the same batch from the same
  numpy draws and keeps its rows, as ``multihost.py`` feeds
  ``jax.make_array_from_process_local_data``.
- ``all_gather_rows`` is differentiable.  Its backward sums the copies'
  gradients over the ranks (an all-reduce, then this rank's rows), so a
  loss that every rank computes whole from gathered rows must be divided by
  the mesh size, and then ``all_reduce_grads`` (a sum) gives every rank the
  unsharded window's gradient.

Backends: NCCL when every rank owns a card (the world is no larger than
the card count), gloo otherwise: on the CPU, and for ranks that share one
card, which NCCL refuses.  A collective that hands a CUDA tensor to gloo
stages it through host memory; the route is chosen by the backend's name.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from multimodal_fusion_tpu_torch.device import resolve_device
from multimodal_fusion_tpu_torch.utils.tree import tree_map

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


@dataclass(eq=False)
class Mesh:
    """The ranks of one data-parallel run.  ``groups`` holds this rank's
    group along each axis of a 2-D mesh (absent where the axis has one
    rank); ``group`` None is the default (world) group."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    rank: int
    device: torch.device
    group: Any = None
    groups: Dict[str, Any] = field(default_factory=dict)

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def backend(self) -> str:
        return str(dist.get_backend(self.group))

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def world_size() -> int:
    """Ranks of the initialised world, or of the launcher's environment
    before it is initialised (1 without a launcher)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def default_backend(device: torch.device, world: int) -> str:
    """NCCL when every rank can own a card, else gloo."""
    if device.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device=None) -> torch.device:
    """This rank's device: the launcher's LOCAL_RANK picks the card (ranks
    beyond the card count share them)."""
    device = resolve_device(device)
    if device.type != "cuda":
        return device
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def init_world(device=None, backend: Optional[str] = None) -> None:
    """Initialise the default process group once: from the launcher's
    environment (``torchrun`` sets WORLD_SIZE, RANK, MASTER_ADDR), or as a
    world of 1 in this process when no launcher started it."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    world = world_size()
    backend = backend or default_backend(dev, world)
    if dev.type == "cuda":
        torch.cuda.set_device(rank_device(dev))
    if "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, init_method="env://", world_size=world,
                                rank=int(os.environ.get("RANK", "0")))
    elif world == 1:
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)
    else:
        raise RuntimeError(f"WORLD_SIZE={world} without MASTER_ADDR: start the ranks with "
                           "torchrun or parallel.multihost")


def _check_world(n: int) -> None:
    have = world_size()
    if n > have:
        raise ValueError(f"requested {n} devices, have {have}")
    if n < have:
        raise ValueError(f"a mesh of {n} ranks in a world of {have}: launch {n} ranks")


def make_mesh(n_devices: Optional[int] = None, axis: str = "data", device=None) -> Mesh:
    """A 1-axis mesh over the world of ``n_devices`` ranks (default: the
    whole world)."""
    n = n_devices or world_size()
    _check_world(n)
    init_world(device)
    dev = rank_device(device)
    return Mesh((n,), (axis,), dist.get_rank(), dev)


def make_mesh_2d(replica: int, data: int, axis_names: Tuple[str, str] = ("replica", "data"),
                 device=None) -> Mesh:
    """``(replica, data)`` mesh: replica the slow (outer) axis, data the
    fast one.  Every rank creates every axis group, in one order."""
    _check_world(replica * data)
    init_world(device)
    rank = dist.get_rank()
    groups: Dict[str, Any] = {}
    if data > 1:
        for i in range(replica):
            g = dist.new_group([i * data + j for j in range(data)])
            if rank // data == i:
                groups[axis_names[1]] = g
    if replica > 1:
        for j in range(data):
            g = dist.new_group([i * data + j for i in range(replica)])
            if rank % data == j:
                groups[axis_names[0]] = g
    dev = rank_device(device)
    return Mesh((replica, data), tuple(axis_names), rank, dev, None, groups)


def mesh_from_shape(mesh_shape, device=None) -> Optional[Mesh]:
    """A mesh from a ``{"replica": R, "data": N}`` config dict (the
    trainers' ``mesh_shape``); ``None`` without one, or with a message when
    the world has fewer ranks than the shape needs: persisted configs of
    larger runs stay loadable for evaluation on one process."""
    if not mesh_shape:
        return None
    n = int(mesh_shape.get("data", 0))
    r = int(mesh_shape.get("replica", 0))
    need = max(r, 1) * max(n, 1)
    have = world_size()
    if need > have:
        print(f"mesh_shape {mesh_shape} needs {need} devices, have {have}; running unsharded")
        return None
    if r > 1:
        # replica-only configs still get an (R, 1) grid: the batch splits R ways
        return make_mesh_2d(r, max(n, 1), device=device)
    if n > 1:
        return make_mesh(n, device=device)
    return None


# ---------------------------------------------------------------------------
# batch placement
# ---------------------------------------------------------------------------

def divides(mesh: Optional[Mesh], n: int) -> bool:
    """Whether a batch dim of ``n`` shards over ``mesh``."""
    return mesh is not None and n % mesh.size == 0


def rows_of(mesh: Mesh, n: int) -> slice:
    """This rank's contiguous rows of an axis of ``n`` (a multiple of the
    mesh size)."""
    k = n // mesh.size
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


def shard_rows(mesh: Mesh, x, axis: int = 0):
    """This rank's rows of ``x`` (tensor or numpy array) along ``axis``."""
    return x[(slice(None),) * axis + (rows_of(mesh, x.shape[axis]),)]


def place_batch(mesh: Optional[Mesh], tree, scan: bool = False,
                batch_size: Optional[int] = None):
    """The one batch-placement rule of every trainer: each leaf keeps this
    rank's rows of its batch axis (axis 0, or axis 1 with ``scan``), or
    stays whole where the batch dim does not divide the mesh (per leaf, or
    for the whole tree when ``batch_size`` does not).  ``mesh=None`` is a
    no-op."""
    if mesh is None:
        return tree
    if batch_size is not None and batch_size % mesh.size:
        return tree
    b_axis = 1 if scan else 0

    def place(x):
        if getattr(x, "ndim", 0) <= b_axis or x.shape[b_axis] % mesh.size:
            return x
        return shard_rows(mesh, x, b_axis)

    return tree_map(place, tree)


def replicate(mesh: Optional[Mesh], tree):
    """Parameters and small state are replicated: every rank holds them
    whole (the identity)."""
    return tree


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _wire(group, t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` where the group's backend reads it (gloo:
    host memory; NCCL: the rank's card); collectives write into it."""
    backend = str(dist.get_backend(group))
    where = t.device
    if backend == "gloo":
        where = torch.device("cpu")
    elif backend == "nccl":
        where = torch.device("cuda", torch.cuda.current_device())
    return t.detach().to(where, copy=True).contiguous()


def all_reduce(mesh: Optional[Mesh], t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """``t`` reduced over the mesh (``op``: sum, min, max); a new tensor on
    ``t``'s device."""
    if mesh is None:
        return t
    group = mesh.group if group is None else group
    buf = _wire(group, t)
    dist.all_reduce(buf, op=_OPS[op], group=group)
    return buf.to(t.device)


def _all_gather(mesh: Mesh, x: torch.Tensor, dim: int) -> torch.Tensor:
    buf = _wire(mesh.group, x)
    bits = buf.dtype == torch.bfloat16 and not buf.is_cuda
    if bits:  # move bfloat16 as its 16-bit patterns
        buf = buf.view(torch.int16)
    parts = [torch.empty_like(buf) for _ in range(mesh.size)]
    dist.all_gather(parts, buf, group=mesh.group)
    out = torch.cat(parts, dim=dim)
    if bits:
        out = out.view(torch.bfloat16)
    return out.to(x.device)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _all_gather(mesh, x, dim)

    @staticmethod
    def backward(ctx, grad):
        # every rank's copy of the gathered rows feeds its own loss: their
        # gradients add up over the ranks
        total = all_reduce(ctx.mesh, grad.contiguous(), "sum")
        k = total.shape[ctx.dim] // ctx.mesh.size
        return total.narrow(ctx.dim, ctx.mesh.rank * k, k), None, None


def all_gather_rows(mesh: Optional[Mesh], x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` (same shapes) concatenated along ``dim`` in rank
    order, differentiable (see the module docstring)."""
    if mesh is None:
        return x
    return _GatherRows.apply(x, mesh, dim)


def all_gather_rows_dict(mesh: Optional[Mesh], tensors: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """``all_gather_rows`` of each tensor of ``tensors`` (rows first), as
    one differentiable collective for the floating ones and one for the
    rest: every rank issues the same collectives in the same order, in the
    forward and in the backward."""
    if mesh is None:
        return dict(tensors)
    out = {}
    for floating in (True, False):
        keys = [k for k, v in tensors.items() if v.is_floating_point() == floating]
        if not keys:
            continue
        flat = [tensors[k].reshape(tensors[k].shape[0], -1) for k in keys]
        dtype = torch.float32 if floating else torch.int64
        both = all_gather_rows(mesh, torch.cat([f.to(dtype) for f in flat], dim=1))
        start = 0
        for k, f in zip(keys, flat):
            part = both[:, start:start + f.shape[1]]
            out[k] = part.reshape((-1,) + tuple(tensors[k].shape[1:])).to(tensors[k].dtype)
            start += f.shape[1]
    return out


def all_reduce_grads(mesh: Optional[Mesh], params: Sequence[torch.Tensor]) -> None:
    """Sum the parameters' gradients over the mesh in place, as one flat
    buffer: over ``data``, then over ``replica`` on a 2-D mesh."""
    if mesh is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    if len(mesh.shape) == 2:
        for axis in (mesh.axis_names[1], mesh.axis_names[0]):
            if axis in mesh.groups:
                flat = all_reduce(mesh, flat, "sum", group=mesh.groups[axis])
    else:
        flat = all_reduce(mesh, flat, "sum")
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def broadcast(mesh: Optional[Mesh], t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank."""
    if mesh is None:
        return t
    buf = _wire(mesh.group, t)
    dist.broadcast(buf, src=src, group=mesh.group)
    return buf.to(t.device)


def barrier(mesh: Optional[Mesh]) -> None:
    if mesh is not None:
        dist.barrier(group=mesh.group)
