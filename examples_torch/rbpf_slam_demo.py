"""End-to-end: RBPF FastSLAM grid mapping in a simulated box world.

Counterpart of ``examples/rbpf_slam_demo.py``, the port's equivalent of
``roslaunch bmapping slam.launch`` (ref: bmapping/src/
turtle_mapping_node.cpp): the robot drives an arc inside a walled box;
every particle carries its own occupancy grid (kernels K2–K4 on the card);
ICP scan matching proposes poses; the final pose error against ground
truth and the map are reported (the reference's README experiment,
bmapping/README.md:33-47). Each update replays ``PFStepper``'s CUDA
graph; ``course(..., eager=True)`` dispatches ``pf_slam_step``'s
operations one by one, the bits reference.

    python -m examples_torch.rbpf_slam_demo [--device cpu]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from examples_torch import device_parser, synchronize
from tpunav_torch.device import DEFAULT_DEVICE, resolve
from tpunav_torch.estimation.rbpf import (GridConfig, PFConfig, best_particle,
                                          pf_init, pf_slam_step)
from tpunav_torch.estimation.rbpf.grid import occupancy_grid
from tpunav_torch.estimation.rbpf.icp import ICPConfig
from tpunav_torch.estimation.rbpf.particle_filter import PFStepper
from tpunav_torch.sim.lidar import box_segments, scan_segments

U = (0.03, 0.02)            # per update: 0.03 rad of turn, 0.02 m forward
SCAN_SEED = 99


def course_inputs(grid: GridConfig, updates=120, seed=SCAN_SEED,
                  device=DEFAULT_DEVICE):
    """The demo's course (also ``bench.py``'s): an arc at u = (0.03 rad,
    0.02 m) per update inside walls at ±1.8 m, scans of ``grid``'s beams
    with 2 mm range noise from a generator seeded ``seed``, odometry =
    ground truth. Made up front, as the scans arrive. Returns (u, scans,
    odoms, prevs): the twist and, per update, the scan, the pose and the
    previous pose."""
    device = resolve(device)
    u = torch.tensor(U, dtype=torch.float32).to(device)
    segs = box_segments(-1.8, -1.8, 1.8, 1.8, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    pose = torch.zeros(3, device=device)
    scans, odoms = [], []
    for _ in range(updates):
        th = pose[0] + u[0]
        pose = torch.stack([th, pose[1] + u[1] * torch.cos(th),
                            pose[2] + u[1] * torch.sin(th)])
        odoms.append(pose)
        scans.append(scan_segments(
            pose, segs, num_beams=grid.num_beams, beam_min=grid.beam_min,
            beam_delta=grid.beam_delta, max_range=grid.range_max,
            generator=gen, noise_std=0.002))
    prevs = [torch.zeros(3, device=device)] + odoms[:-1]
    return u, scans, odoms, prevs


def config(num_particles=40):
    grid = GridConfig(resolution=0.05, xmin=-2.0, xmax=2.0, ymin=-2.0,
                      ymax=2.0, num_beams=360)
    return PFConfig(num_particles=num_particles, k_samples=50,
                    sample_range=(1e-6, 1e-5, 1e-5),
                    motion_noise=(1e-6, 1e-5, 1e-5),
                    grid=grid, icp=ICPConfig(max_iter=25))


def course(cfg: PFConfig, inputs, seed=2, device=DEFAULT_DEVICE,
           eager=False, noise=None):
    """The filter from seed ``seed`` over ``course_inputs``' updates; returns
    the final state. Each update is one ``PFStepper`` replay (``tpunav``
    runs the whole course as one program), or with ``eager`` one
    ``pf_slam_step`` of operations one by one. ``noise``: each update's
    ``PFNoise`` in place of the filter's draws."""
    u, scans, odoms, prevs = inputs
    noise = [None] * len(scans) if noise is None else noise
    st = pf_init(cfg, seed=seed, device=device)
    if eager:
        for i in range(len(scans)):
            st = pf_slam_step(cfg, st, scans[i], u, odoms[i], prevs[i],
                              noise=noise[i])
        return st
    stepper = PFStepper(cfg, st, device)
    for i in range(len(scans)):
        st = stepper.step(scans[i], u, odoms[i], prevs[i], noise=noise[i])
    return st


def run(num_particles=40, updates=120, seed=2, device=DEFAULT_DEVICE):
    """The course from filter seed ``seed`` (:func:`course`); returns (err
    [θ, x, y], occupied cells, free cells of the map, wall seconds,
    updates)."""
    device = resolve(device)
    cfg = config(num_particles)
    inputs = course_inputs(cfg.grid, updates, device=device)
    synchronize(device)
    t0 = time.perf_counter()
    st = course(cfg, inputs, seed, device)
    pose, grid_best = best_particle(st)
    synchronize(device)
    wall = time.perf_counter() - t0
    err = (pose - inputs[2][-1]).cpu().numpy()
    err[0] = (err[0] + np.pi) % (2 * np.pi) - np.pi  # wrap heading error
    occ = int((grid_best >= cfg.grid.l_occ).sum())
    free = int((occupancy_grid(cfg.grid, grid_best) == 0).sum())
    return err, occ, free, wall, updates


def main():
    args = device_parser(__doc__.splitlines()[0]).parse_args()
    err, occ, free, wall, n = run(device=args.device)
    print(f"pose error (theta,x,y) = {err[0]:+.4f} {err[1]:+.4f} "
          f"{err[2]:+.4f}  (|xy| = {np.hypot(err[1], err[2]) * 100:.2f} cm)")
    print(f"occupied cells: {occ}  map free cells: {free}")
    print(f"{n} SLAM updates, 40 particles, 360 beams in {wall:.1f}s "
          f"= {n / wall:.1f} updates/s on {args.device}")
    assert np.hypot(err[1], err[2]) < 0.2, "pose diverged"


if __name__ == "__main__":
    main()
