"""tpunav_torch — the PyTorch + CUDA port of ``tpunav`` for NVIDIA Hopper.

A second package beside ``tpunav`` (the JAX reference, ``tpunav/__init__.py``),
laid out at the same relative paths so each module's counterpart is easy to
find. It imports ``torch``, ``numpy`` and ``yaml``, never ``jax`` or
``tpunav``. The first slice is the MPPI waypoint course:

- ``tpunav_torch.models``   the diff-drive cart ODE
- ``tpunav_torch.ops``      RK4, the Philox generator and the fused MPPI solve
                            (kernel K1, hand-written CUDA for ``sm_90a``)
- ``tpunav_torch.control``  MPPI and the waypoint course
- ``tpunav_torch.sim``      wheel-motor dynamics
- ``tpunav_torch.runtime``  YAML configuration loaders
- ``tpunav_torch.interop``  configuration and state carried across from
                            ``tpunav`` as numpy
"""

__version__ = "0.1.0"
