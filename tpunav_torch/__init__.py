"""tpunav_torch — the PyTorch + CUDA port of ``tpunav`` for NVIDIA Hopper.

A second package beside ``tpunav`` (the JAX reference, ``tpunav/__init__.py``),
laid out at the same relative paths so each module's counterpart is easy to
find. It imports ``torch``, ``numpy`` and ``yaml``, never ``jax`` or
``tpunav``. Four paths are ported: the MPPI waypoint course, the
obstacle-aware MPPI course of BASELINE config 2 (planner-fed, with K1's
obstacle mode), EKF SLAM closing the MPPI loop (BASELINE configs 3 and 4,
with the lidar circle detector), and RBPF grid SLAM, and the host runtime
that runs them as the reference's node graph, in one process or across
two over a TCP bus, and MPPI and the RBPF sharded over the ranks of a
``torch.distributed`` process group:

- ``tpunav_torch.core``        angle wrapping, SE(2), diff-drive kinematics,
                               waypoint controllers, random draws
- ``tpunav_torch.models``      the diff-drive cart ODE
- ``tpunav_torch.ops``         RK4, Philox, the bearing polynomial, the EDT,
                               and the kernels, hand-written CUDA for
                               ``sm_90a``: K1 the fused MPPI solve (with its
                               obstacle mode), K2 the likelihood field, K3 the
                               map update, K4 the EDT
- ``tpunav_torch.control``     MPPI, the obstacle cost fields, the
                               waypoint course and the SLAM-in-the-loop
                               course
- ``tpunav_torch.planning``    the planning grid, PRM + Theta*, D* Lite and
                               the potential field
- ``tpunav_torch.estimation``  EKF SLAM (known and unknown data
                               association), the lidar circle detector, and
                               the RBPF: grids, ICP, the particle filter
- ``tpunav_torch.sim``         wheel-motor dynamics, the landmark sensor,
                               the simulated lidar, the diff-drive plant
                               and the tsim course controllers
- ``tpunav_torch.runtime``     channels, the virtual-time scheduler, the
                               reference's nodes and SLAM nodes, the TCP
                               bus, YAML configuration loaders, metrics,
                               checkpoints, profiling, and the process
                               group's set-up (``distributed``)
- ``tpunav_torch.parallel``    the shard axis over a process group, MPPI
                               with K sharded (through K1's partials) and
                               the RBPF with P sharded (K2–K4 on each
                               rank's particles)
- ``tpunav_torch.robot_model`` the robot's link tree (the URDF equivalent)
- ``tpunav_torch.viz``         matplotlib drawing of maps, paths and the
                               robot
- ``tpunav_torch.interop``     configuration, state and roadmaps carried
                               across from ``tpunav`` as numpy
- ``tpunav_torch.device``      the CUDA default of every entry point and
                               the filters' full-precision matmuls
"""

__version__ = "0.1.0"
