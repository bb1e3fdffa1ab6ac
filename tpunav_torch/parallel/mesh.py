"""The 1-D shard axis and the collectives the sharded solvers run over it.

Port of ``tpunav/parallel/mesh.py``. ``tpunav`` builds a
``jax.sharding.Mesh`` over its chips; here the shards are the ranks of a
``torch.distributed`` process group (``runtime.distributed.initialize``),
one device per rank, and :class:`ShardMesh` carries what the sharded code
needs: the group, this rank's index, the number of shards, the device,
and the three collectives that the sharded solvers run (``tpunav``'s
``pmin``, ``psum`` and ``all_gather``).

Why a small frozen dataclass and not
``torch.distributed.device_mesh.init_device_mesh``: a ``DeviceMesh`` on
``"cuda"`` creates an NCCL group of its own, and NCCL refuses two ranks on
one card, which is how a one-card machine runs two ranks (under gloo).
The dataclass takes whatever group the caller brought up.

A one-shard mesh with no process group is the identity: its collectives
return their input. It is how one process runs the sharded code.

A CUDA graph can capture the collectives of an NCCL mesh (and the
identity's), never those of a host-staged one: the graphed sharded
steppers (``mppi_sharded``, ``rbpf_sharded``) raise on it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from ..device import DEFAULT_DEVICE, resolve


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """One rank's view of a 1-D shard axis."""

    group: Optional[dist.ProcessGroup]   # None: the one-shard identity
    index: int                           # this rank's shard
    size: int                            # number of shards
    device: torch.device                 # this rank's device
    axis_name: str = "k"
    # gloo reduces and gathers in host memory: a CUDA tensor goes through
    # the host (see _staged).
    host_staged: bool = False

    def _staged(self, t: torch.Tensor, copy: bool) -> torch.Tensor:
        """``t`` flat, as the collective takes it: under gloo a CUDA tensor
        is staged through the host, explicitly and on every call. gloo's
        own CUDA paths copy to host memory and back in any case, and its
        gather of CUDA tensors is not in every torch release, so every
        collective of a gloo mesh takes this one path. ``copy``: the
        collective works in place and must not write ``t``."""
        flat = t.reshape(-1)
        if self.host_staged:
            return flat.cpu()
        return flat.clone() if copy else flat

    def _all_reduce(self, t, op):
        if self.group is None:
            return t
        buf = self._staged(t, copy=True)
        dist.all_reduce(buf, op=op, group=self.group)
        return buf.to(t.device).reshape(t.shape)

    def min_(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise minimum over the shards (``lax.pmin``)."""
        return self._all_reduce(t, dist.ReduceOp.MIN)

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise sum over the shards (``lax.psum``)."""
        return self._all_reduce(t, dist.ReduceOp.SUM)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every shard's ``t`` concatenated along dim 0 in shard order
        (``lax.all_gather`` then the reshape to the global axis). Under
        NCCL the shards land in one output tensor, one collective a CUDA
        graph can capture; gloo takes the list form."""
        if self.group is None:
            return t
        buf = self._staged(t, copy=False)
        shape = (self.size * t.shape[0],) + tuple(t.shape[1:])
        if dist.get_backend(self.group) == "nccl":
            out = buf.new_empty(self.size * buf.numel())
            dist.all_gather_into_tensor(out, buf, group=self.group)
            return out.reshape(shape)
        parts = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(parts, buf, group=self.group)
        return torch.cat(parts).to(t.device).reshape(shape)


def capturable(mesh: ShardMesh) -> None:
    """Raises unless a CUDA graph can capture ``mesh``'s collectives: a
    host-staged mesh copies every collective's tensor to the host and
    back, which no graph can record."""
    if mesh.host_staged:
        raise ValueError(
            "a host-staged mesh (gloo on CUDA) stages every collective "
            "through host memory, which a CUDA graph cannot capture; run "
            "the eager sharded function, or an NCCL group")


def rollout_mesh(group: Optional[dist.ProcessGroup] = None,
                 axis_name: str = "k", device=DEFAULT_DEVICE) -> ShardMesh:
    """The 1-D shard axis over ``group`` (default: the whole process group
    when one is initialised, else the one-shard identity), with this
    rank's ``device`` (default the card)."""
    device = resolve(device)
    if group is None and not dist.is_initialized():
        return ShardMesh(None, 0, 1, device, axis_name)
    if group is None:
        group = dist.group.WORLD
    return ShardMesh(group, dist.get_rank(group), dist.get_world_size(group),
                     device, axis_name,
                     host_staged=(dist.get_backend(group) == "gloo"
                                  and device.type == "cuda"))
