"""tpunav_torch — the PyTorch + CUDA port of ``tpunav`` for NVIDIA Hopper.

A second package beside ``tpunav`` (the JAX reference, ``tpunav/__init__.py``),
laid out at the same relative paths so each module's counterpart is easy to
find. It imports ``torch``, ``numpy`` and ``yaml``, never ``jax`` or
``tpunav``. Three paths are ported: the MPPI waypoint course, the
obstacle-aware MPPI course of BASELINE config 2 (planner-fed, with K1's
obstacle mode), and RBPF grid SLAM:

- ``tpunav_torch.core``        angle wrapping and SE(2)
- ``tpunav_torch.models``      the diff-drive cart ODE
- ``tpunav_torch.ops``         RK4, Philox, the bearing polynomial, the EDT,
                               and the kernels, hand-written CUDA for
                               ``sm_90a``: K1 the fused MPPI solve (with its
                               obstacle mode), K2 the likelihood field, K3 the
                               map update, K4 the EDT
- ``tpunav_torch.control``     MPPI, the obstacle cost fields and the
                               waypoint course
- ``tpunav_torch.planning``    the planning grid, PRM + Theta*, D* Lite and
                               the potential field
- ``tpunav_torch.estimation``  the RBPF: grids, ICP, the particle filter
- ``tpunav_torch.sim``         wheel-motor dynamics and the simulated lidar
- ``tpunav_torch.runtime``     YAML configuration loaders
- ``tpunav_torch.interop``     configuration, state and roadmaps carried
                               across from ``tpunav`` as numpy
- ``tpunav_torch.device``      the CUDA default of every entry point
"""

__version__ = "0.1.0"
