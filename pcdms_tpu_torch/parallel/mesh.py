"""Data-parallel process groups (counterpart of
``pcdms_tpu/parallel/mesh.py``).

The JAX package drives every device from one process over a ``('data',)``
mesh (or a ``(dcn, data)`` one across slices). The port runs one process
per card, started by ``torchrun --nproc_per_node N``, and a ``Mesh`` is
what such a process knows of the world: its rank, the world size, its
device, the whole group (the gradient all-reduce) and, for ``num_slices``
slices, the group of the ``world / num_slices`` consecutive ranks of its
own slice (ZeRO-1's optimizer shards stay inside it, as the JAX package
pins them to the ``data`` axis). The global batch shards over the whole
world: rank r holds rows ``r * B .. (r + 1) * B``.

A plain ``python -m`` run has no ``torchrun`` environment and makes a
world of 1 with no group and no collective. Where a process group is
already set up (a test's ``gloo`` world, the card smoke's), ``make_mesh``
joins it as it is.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    rank: int = 0
    world: int = 1
    device: torch.device = torch.device("cpu")
    group: Optional[object] = None          # None: a world of 1, no group
    num_slices: int = 1
    slice_group: Optional[object] = None    # this rank's slice (ZeRO-1)

    @property
    def slice_size(self) -> int:
        return self.world // self.num_slices

    @property
    def slice_ranks(self) -> list:
        first = self.rank - self.rank % self.slice_size
        return list(range(first, first + self.slice_size))

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def _join_group(device: torch.device):
    """Initialise the default group from the ``torchrun`` environment
    (``nccl`` on a card, ``gloo`` on the CPU) unless one exists; -> the
    rank's device (``cuda:LOCAL_RANK``) or None without either."""
    if not dist.is_initialized():
        if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
            return None
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo", init_method="env://")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return device


def make_mesh(device=None) -> Mesh:
    """The data-parallel world of this process on ``device`` (None: CUDA;
    the rank's own card under ``torchrun``)."""
    from pcdms_tpu_torch.utils.device import resolve_device
    device = resolve_device(device)
    joined = _join_group(device)
    if joined is None:
        return Mesh(device=device)
    return Mesh(rank=dist.get_rank(), world=dist.get_world_size(),
                device=joined, group=dist.group.WORLD,
                slice_group=dist.group.WORLD)


def make_hybrid_mesh(num_slices: int, device=None) -> Mesh:
    """A mesh over ``num_slices`` slices of consecutive ranks. Raises
    ``ValueError`` when the world does not divide into them, as the JAX
    package does for its devices."""
    mesh = make_mesh(device)
    if num_slices <= 0 or mesh.world % num_slices:
        raise ValueError(
            f"{mesh.world} devices do not divide into {num_slices} slices")
    per = mesh.world // num_slices
    slice_group = mesh.group
    if num_slices > 1 and per > 1:
        # every rank makes every slice's group, in the same order
        for s in range(num_slices):
            g = dist.new_group(list(range(s * per, (s + 1) * per)))
            if mesh.rank // per == s:
                slice_group = g
    elif num_slices > 1:
        slice_group = None
    return dataclasses.replace(mesh, num_slices=num_slices,
                               slice_group=slice_group)


def shard_batch(tree, mesh: Optional[Mesh]):
    """This rank's rows of a global batch (a tensor, an array, or a dict of
    them): rows ``rank * B .. (rank + 1) * B`` with B = rows / world."""
    if mesh is None or mesh.world == 1:
        return tree
    if isinstance(tree, dict):
        return {k: shard_batch(v, mesh) for k, v in tree.items()}
    n = tree.shape[0]
    if n % mesh.world:
        raise ValueError(f"a global batch of {n} rows does not split over "
                         f"{mesh.world} ranks")
    b = n // mesh.world
    return tree[mesh.rank * b:(mesh.rank + 1) * b]


def draw_rows(draw, batch_size: int, mesh: Optional[Mesh]):
    """A loss's random draws at any world size: ``draw(n)`` makes the draws
    of n rows; this returns this rank's ``batch_size`` rows of the draws
    for the global batch, as the JAX package draws once for the global
    array."""
    world = 1 if mesh is None else mesh.world
    return shard_batch(draw(batch_size * world), mesh)


def pad_and_shard(mesh: Optional[Mesh], *arrays):
    """Pad each array's leading dim to a multiple of the world size by
    repeating its last row (padded rows compute valid, discarded results)
    and take this rank's rows; ``None`` passes through. Returns
    ``(*local_arrays, padded_n)``."""
    world = 1 if mesh is None else mesh.world
    n = next(a for a in arrays if a is not None).shape[0]
    n_pad = -(-n // world) * world
    out = []
    for a in arrays:
        if a is None:
            out.append(None)
            continue
        a = np.asarray(a)
        if n_pad != n:
            a = np.concatenate([a, np.repeat(a[-1:], n_pad - n, axis=0)])
        out.append(shard_batch(a, mesh))
    return (*out, n_pad)


# the largest flat buffer one all-reduce of ``all_reduce_mean`` takes
BUCKET_BYTES = 256 << 20


def all_reduce_mean(tensors, mesh: Optional[Mesh]) -> None:
    """Average ``tensors`` over the mesh's world in place, through flat
    buckets of at most ``BUCKET_BYTES`` per dtype (one collective per
    bucket, not per tensor). A mesh without a group does nothing."""
    if mesh is None or mesh.group is None:
        return
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors
    buckets, size = [[]], 0
    for t in sorted(tensors, key=lambda t: str(t.dtype)):
        nbytes = t.numel() * t.element_size()
        if buckets[-1] and (size + nbytes > BUCKET_BYTES
                            or buckets[-1][-1].dtype != t.dtype):
            buckets.append([])
            size = 0
        buckets[-1].append(t)
        size += nbytes
    for bucket in buckets:
        if not bucket:
            continue
        flat = _flatten_dense_tensors(bucket)
        dist.all_reduce(flat, group=mesh.group)
        flat.div_(mesh.world)
        for t, r in zip(bucket, _unflatten_dense_tensors(flat, bucket)):
            t.copy_(r)


def sum_over_world(values, mesh: Optional[Mesh]) -> list:
    """The world's sums of a few host numbers (f64), on every rank."""
    if mesh is None or mesh.group is None:
        return list(values)
    t = torch.tensor(values, dtype=torch.float64, device=mesh.device)
    dist.all_reduce(t, group=mesh.group)
    return t.tolist()


def any_rank(flag: bool, mesh: Optional[Mesh]) -> bool:
    """True on every rank when ``flag`` is true on any of them."""
    if mesh is None or mesh.group is None:
        return flag
    t = torch.tensor([1.0 if flag else 0.0], device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return bool(t.item())


def barrier(mesh: Optional[Mesh]) -> None:
    if mesh is not None and mesh.group is not None:
        if dist.get_backend(mesh.group) == "nccl":
            dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
        else:
            dist.barrier(group=mesh.group)
