"""Demos of the PyTorch + CUDA port (``tpunav_torch``), the counterparts of
``examples/``, and the spawning of a process group that they share.

- ``examples_torch.mppi_two_process``: the K-sharded MPPI solve across
  processes (``examples/mppi_two_process.py``);
- ``examples_torch.rbpf_two_process``: the P-sharded RBPF across
  processes through a forced resample (``examples/rbpf_two_process.py``).

:func:`spawn` starts functions in processes of their own (spawn, never
fork: a child may use CUDA) and waits for them: a child that fails or
outlives the timeout fails the call, and no child is left running.
:func:`launch` spawns one process per rank, joins them into a
``torch.distributed`` group over a free local port, runs
``target(mesh, device, *args)`` on each, and returns each rank's result.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import socket
import time


def free_port() -> int:
    """A TCP port that is free on this host now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_main(target, args, rank: int, world: int, address: str, device,
              backend, results=None):
    """One rank: join the group, run ``target(mesh, device, *args)`` on
    the whole group's mesh, leave the group. Returns the result, and puts
    (rank, result) on ``results`` where given."""
    import torch

    from tpunav_torch.parallel import rollout_mesh
    from tpunav_torch.runtime.distributed import initialize, shutdown

    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    initialize(address, world, rank, backend=backend, device=device)
    try:
        out = target(rollout_mesh(device=device), device, *args)
        if results is not None:
            results.put((rank, out))
        return out
    finally:
        shutdown()


def spawn(targets, timeout: float, results=None, expect: int = 0):
    """Run each ``(function, args)`` of ``targets`` in a spawned process
    and wait for all of them. ``results``: a queue of the spawn context
    the children put ``(key, value)`` pairs on; it is drained while they
    run (a child cannot exit before its pipe is read) until ``expect``
    pairs have come, and the pairs are returned as a dict. Raises if a
    child exits nonzero or the whole is not done within ``timeout``
    seconds; no child is left running."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=fn, args=args, name=f"{fn.__name__}[{i}]")
             for i, (fn, args) in enumerate(targets)]
    for p in procs:
        p.start()
    out = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < expect or any(p.is_alive() for p in procs):
            failed = [p.name for p in procs if p.exitcode not in (None, 0)]
            if failed:
                raise RuntimeError(f"{failed} failed (exit codes "
                                   f"{[p.exitcode for p in procs]})")
            if time.monotonic() > deadline:
                raise TimeoutError(f"{len(out)} of {expect} results and "
                                   f"{[p.exitcode for p in procs]} exit "
                                   f"codes after {timeout} s")
            if len(out) < expect:
                try:
                    key, value = results.get(timeout=1.0)
                    out[key] = value
                except queue.Empty:
                    pass
            else:
                time.sleep(0.2)
        failed = [p.name for p in procs if p.exitcode != 0]
        if failed:
            raise RuntimeError(f"{failed} failed (exit codes "
                               f"{[p.exitcode for p in procs]})")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    return out


def launch(target, args=(), world: int = 2, device="cpu", backend=None,
           timeout: float = 600.0):
    """``target(mesh, device, *args)`` on ``world`` spawned ranks; returns
    their results in rank order. ``backend`` as in
    ``tpunav_torch.runtime.distributed.initialize`` (ranks that share one
    card pass ``"gloo"``). ``target`` and its results must pickle."""
    results = mp.get_context("spawn").Queue()
    address = f"127.0.0.1:{free_port()}"
    out = spawn([(rank_main, (target, args, r, world, address, device,
                              backend, results)) for r in range(world)],
                timeout, results, expect=world)
    return [out[r] for r in range(world)]
