"""Multi-device scale-out: the shard axis over a ``torch.distributed``
process group, and MPPI and the RBPF sharded over it (counterpart:
``tpunav/parallel/__init__.py``)."""

from .mesh import ShardMesh, rollout_mesh  # noqa: F401
from .mppi_sharded import (  # noqa: F401
    FusedShardedStepper,
    PlainShardedStepper,
    mppi_solve_fused_sharded,
    mppi_solve_sharded,
    shard_seed,
)
from .rbpf_sharded import (  # noqa: F401
    ShardedPFStepper,
    pf_init_sharded,
    pf_slam_step_sharded,
)
