"""A ``(data, space)`` mesh of process groups over ``torch.distributed``.

Counterpart of ``deepatlas_tpu/parallel/mesh.py``.  The JAX package lays a
``jax.sharding.Mesh`` over the devices of one program; here each mesh
position is a process (one rank), and an axis is the process group of the
ranks that differ only along it.  Ranks are laid out row-major, the space
index fastest: rank ``r`` sits at ``(r // n_space, r % n_space)``, as a
``(data, space)`` device array reshaped from ``jax.devices()``.

The backend is explicit: NCCL for CUDA and gloo for the CPU by default;
``backend="gloo"`` on CUDA runs several ranks on one card (NCCL refuses two
ranks on one GPU), with the all-reduces on the card and the point-to-point
planes of the halo exchange staged through the host (gloo's send and recv
take CPU tensors only).  The process group comes from torchrun's ``RANK``,
``WORLD_SIZE`` and ``MASTER_ADDR`` / ``MASTER_PORT`` (``init_method``
``env://``) or from an explicit ``init_method`` / ``rank`` / ``world_size``;
a world of one needs no process group at all.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

AXES = ("data", "space")


@dataclass
class Axis:
    """One mesh axis as this rank sees it: its size, this rank's index
    along it, the global ranks of its group in axis order, and the group
    (None at size 1, where every collective is the identity)."""
    name: str
    size: int = 1
    index: int = 0
    ranks: Tuple[int, ...] = (0,)
    group: Optional[object] = None
    backend: str = "gloo"

    @property
    def stage_p2p(self) -> bool:
        """Whether point-to-point CUDA planes go through host buffers."""
        return self.backend == "gloo"


@dataclass
class Mesh:
    """The axes of a ``(data, space)`` mesh, this rank's device and the
    world it spans."""
    axes: Dict[str, Axis] = field(default_factory=dict)
    device: torch.device = torch.device("cpu")
    rank: int = 0
    world_size: int = 1

    @property
    def shape(self) -> Dict[str, int]:
        return {name: ax.size for name, ax in self.axes.items()}

    @property
    def size(self) -> int:
        n = 1
        for ax in self.axes.values():
            n *= ax.size
        return n

    def axis(self, name: Optional[str]) -> Optional[Axis]:
        if name is None:
            return None
        if name not in self.axes:
            raise KeyError(f"mesh has no axis {name!r}: {tuple(self.axes)}")
        return self.axes[name]


def local_device_count() -> int:
    return torch.cuda.device_count()


def env_world() -> Tuple[int, int, int]:
    """``(rank, world_size, local_rank)`` from torchrun's variables, or a
    world of one."""
    return (int(os.environ.get("RANK", 0)),
            int(os.environ.get("WORLD_SIZE", 1)),
            int(os.environ.get("LOCAL_RANK", 0)))


def default_backend(device: torch.device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device, local_rank: int) -> torch.device:
    """This rank's device: ``cuda:<local_rank>`` where there are enough
    cards, else the one card every rank shares (gloo)."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    n = torch.cuda.device_count()
    return torch.device("cuda", local_rank if local_rank < n else 0)


def make_mesh(data: int = 1, space: int = 1, device="cpu",
              backend: Optional[str] = None,
              init_method: Optional[str] = None,
              rank: Optional[int] = None,
              world_size: Optional[int] = None) -> Mesh:
    """A ``(data, space)`` mesh over ``data * space`` ranks.

    Starts the default process group where the world has more than one
    rank and none is running (``init_method`` defaults to ``env://``, rank
    and world size to torchrun's), then makes one group per axis line.
    Every rank must call this with the same arguments.  Raises where the
    world's size is not ``data * space``.
    """
    env_rank, env_size, local_rank = env_world()
    rank = env_rank if rank is None else rank
    world_size = env_size if world_size is None else world_size
    if dist.is_initialized():
        rank, world_size = dist.get_rank(), dist.get_world_size()
    if data < 1 or space < 1:
        raise ValueError(f"mesh axes must be >= 1, got data={data} "
                         f"space={space}")
    if data * space != world_size:
        raise ValueError(
            f"a ({data}, {space}) mesh needs {data * space} ranks, the world "
            f"has {world_size}")
    device = rank_device(device, local_rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or default_backend(device)
    # a world of one starts a group only where it is asked for (an address,
    # or torchrun's launch), so that the backend is exercised there too
    launched = init_method is not None or "TORCHELASTIC_RUN_ID" in os.environ
    if not dist.is_initialized() and (world_size > 1 or launched):
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world_size)
        dist.barrier(device_ids=[device.index]
                     if backend == "nccl" else None)
    if dist.is_initialized():
        backend = dist.get_backend()
    d_idx, s_idx = divmod(rank, space)
    lines = {"data": [[d * space + s for d in range(data)]
                      for s in range(space)],
             "space": [[d * space + s for s in range(space)]
                       for d in range(data)]}
    mine = {"data": lines["data"][s_idx], "space": lines["space"][d_idx]}
    index = {"data": d_idx, "space": s_idx}
    axes = {}
    for name in AXES:
        n = len(mine[name])
        group = None
        if n > 1:
            if n == world_size:
                group = dist.group.WORLD
            else:
                # every rank creates every group, in the same order
                for line in lines[name]:
                    g = dist.new_group(line)
                    if line == mine[name]:
                        group = g
        axes[name] = Axis(name, n, index[name], tuple(mine[name]), group,
                          backend)
    return Mesh(axes, device, rank, world_size)


def shutdown() -> None:
    """End the default process group, where one is running."""
    if dist.is_initialized():
        dist.destroy_process_group()
