"""Demos of the PyTorch + CUDA port (``tpunav_torch``), the counterparts of
``examples/`` at the same module names, and what they share.

Each demo runs as ``python -m examples_torch.<name>`` from the repository
root, on the CUDA card by default or on the CPU with ``--device cpu``.
Its ``run``-style functions take ``device=`` (default the card; they raise
without CUDA). Figures go to ``examples_torch/out/`` and need matplotlib,
which only ``plot`` functions and ``main`` import: where it is missing,
``main`` says that it drew no figure, after the demo's own assertions.

- ``rbpf_explore_demo``: RBPF mapping at 500 particles under the fused
  MPPI exploration loop, with a checkpoint and resume (BASELINE config 5);
- ``full_stack_demo``: RBPF map → D* Lite replanning → fused MPPI, one loop;
- ``lidar_ekf_slam_demo``, ``dense_world_slam_demo``,
  ``slam_mppi_closed_loop_demo``, ``ekf_slam_demo``: EKF SLAM (BASELINE
  configs 3–4);
- ``mppi_waypoints_demo``, ``obstacle_mppi_demo``: the MPPI courses
  (BASELINE configs 1–2); ``rbpf_slam_demo``: the RBPF course;
- ``planners_demo``, ``rigid2d_frames_demo``, ``live_view_demo``;
- ``full_stack_two_process``: the node graph across two processes over the
  TCP bus;
- ``mppi_two_process``, ``rbpf_two_process``: the K-sharded MPPI solve
  and the P-sharded RBPF across processes;
- ``profile_rbpf_stages``: the RBPF update's and the exploration loop's
  stage times, each stage a CUDA graph;
- ``make_results``: the fidelity tables, ``RESULTS_torch.md``.

:func:`kernel_profile`, :func:`launches_per_call` and
:func:`syncs_per_call` count a call's device kernels, launches and host
syncs on the card (``torch.profiler``, torch's sync debug mode).
:func:`spawn` starts functions in processes of their own (spawn, never
fork: a child may use CUDA) and waits for them: a child that fails or
outlives the timeout fails the call, and no child is left running.
:func:`launch` spawns one process per rank, joins them into a
``torch.distributed`` group over a free local port, runs
``target(mesh, device, *args)`` on each, and returns each rank's result.
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import os
import queue
import socket
import time

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out")


def device_parser(description: str) -> argparse.ArgumentParser:
    """An argument parser with the demos' ``--device {cuda,cpu}``."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap


def out_path(name: str) -> str:
    """``examples_torch/out/<name>``, the directory made if needed."""
    os.makedirs(OUT, exist_ok=True)
    return os.path.join(OUT, name)


def draw(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, a function that draws a figure; where
    matplotlib is missing, says that no figure was drawn and why."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as exc:
        print(f"drew no figure ({fn.__name__}): {exc}", flush=True)
        return None
    return fn(*args, **kwargs)


class Marks:
    """Time marks on one device's clock: CUDA events on the card (read
    after the run's last synchronize, so marking waits for nothing), the
    host's clock on the CPU."""

    def __init__(self, device):
        import torch

        self.cuda = torch.device(device).type == "cuda"
        self.marks = []

    def mark(self) -> int:
        import torch

        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())
        return len(self.marks) - 1

    def ms(self, i: int, j: int) -> float:
        """Milliseconds from mark ``i`` to mark ``j`` (after a synchronize
        on the card)."""
        if self.cuda:
            return self.marks[i].elapsed_time(self.marks[j])
        return 1e3 * (self.marks[j] - self.marks[i])


def synchronize(device) -> None:
    """Wait for ``device``'s queue (nothing to wait for on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def kernel_profile(fn, reps: int) -> dict:
    """{device kernel name: (device µs, launches)} over ``reps`` calls of
    ``fn``, from ``torch.profiler`` (on the card only)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if e.self_device_time_total > 0:
            out[e.key] = (e.self_device_time_total, e.count)
    return out


def launches_per_call(fn, reps: int) -> float:
    """Device kernels launched per call of ``fn`` (on the card only)."""
    return sum(c for _, c in kernel_profile(fn, reps).values()) / reps


def syncs_per_call(fn, reps: int) -> float:
    """Host syncs per call of ``fn`` over ``reps`` calls: the synchronizing
    CUDA calls that torch's sync debug mode reports (on the card only)."""
    import warnings

    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(reps):
                fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message).lower()
               for w in caught) / reps


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


def launch(target, args=(), world: int = 2, device="cuda", backend=None,
           timeout: float = 600.0):
    """``target(mesh, device, *args)`` on ``world`` spawned ranks; returns
    their results in rank order. ``device`` defaults to the card and
    raises without CUDA before any rank is spawned. ``backend`` as in
    ``tpunav_torch.runtime.distributed.initialize`` (ranks that share one
    card pass ``"gloo"``). ``target`` and its results must pickle."""
    from tpunav_torch.device import resolve

    resolve(device)
    results = mp.get_context("spawn").Queue()
    address = f"127.0.0.1:{free_port()}"
    out = spawn([(rank_main, (target, args, r, world, address, device,
                              backend, results)) for r in range(world)],
                timeout, results, expect=world)
    return [out[r] for r in range(world)]
