"""Multi-process initialisation and host-role helpers.

Port of ``tpunav/runtime/distributed.py`` (the reference's multi-machine
deployment, nuturtle_robot/launch/basic_remote.launch:1-40). Every process
runs the same program and :func:`initialize` joins them into one
``torch.distributed`` process group; ``tpunav_torch.parallel`` then shards
the rollout or particle axis over its ranks, one device per rank.

Single-host use is a no-op: :func:`initialize` contacts nothing unless
multi-process settings are given, so one launch script runs unchanged
from one device to many.

The backend is never guessed from a failure. It defaults to ``"nccl"`` for
a CUDA device and ``"gloo"`` for the CPU; a caller whose ranks share one
card passes ``"gloo"`` itself, because NCCL refuses two ranks on one
device.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from ..device import DEFAULT_DEVICE, resolve


def _env_address() -> Optional[str]:
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    if addr is None and port is None:
        return None
    if addr is None or port is None:
        raise ValueError("partial multi-process configuration: set both "
                         "MASTER_ADDR and MASTER_PORT, or neither")
    return f"{addr}:{port}"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               device=DEFAULT_DEVICE) -> bool:
    """Join a ``torch.distributed`` process group when running
    multi-process; return True iff one was brought up.

    Explicit arguments come first, then torch's own variables
    (MASTER_ADDR and MASTER_PORT, WORLD_SIZE, RANK). With neither, this is a
    single-host run and nothing is contacted. ``coordinator_address`` is
    ``host:port`` of rank 0's rendezvous (``init_method="tcp://…"``).
    ``backend`` defaults to ``"nccl"`` for a CUDA ``device`` and
    ``"gloo"`` for the CPU; ``device`` is this rank's device, made current
    for NCCL where it names a card by index.
    """
    if coordinator_address is None:
        coordinator_address = _env_address()
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])

    if coordinator_address is None and num_processes is None:
        return False
    # Reject a partial specification up front: init_process_group would
    # otherwise fail opaquely, or wait on a rendezvous that never forms.
    missing = [name for name, val in (
        ("coordinator_address", coordinator_address),
        ("num_processes", num_processes),
        ("process_id", process_id)) if val is None]
    if missing:
        raise ValueError(
            "partial multi-process configuration: missing "
            f"{missing}; set all of MASTER_ADDR/MASTER_PORT, WORLD_SIZE and "
            "RANK (or pass all three arguments), or none for a single-host "
            "run")
    device = resolve(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and device.index is not None:
        torch.cuda.set_device(device)
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id))
    return True


def shutdown() -> None:
    """Destroy the process group, if there is one, so that a rank exits
    cleanly."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_leader() -> bool:
    """True on the process that owns logging, viz and checkpoint writes
    (the reference's 'laptop' role against the robot's headless one)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def process_info() -> dict:
    """The group's layout for startup logging. Each rank drives one
    device, so the global devices are the ranks; the local devices are
    the CUDA cards this process sees (1 for a CPU-only process)."""
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    if not dist.is_initialized():
        return {"process_index": 0, "process_count": 1,
                "local_devices": local, "global_devices": local}
    return {"process_index": dist.get_rank(),
            "process_count": dist.get_world_size(),
            "local_devices": local,
            "global_devices": dist.get_world_size()}
