"""Process-mesh scaling: the env axis is data-parallel over devices.

The port's twin of `tpu_doom.parallel`, over `torch.distributed`, one
process per device: envs shard over the 'dp' mesh axis, the
framebuffer's row axis can shard over 'tp', and the collectives are
metric means and a level bank's exit migration (`gather_envs`, used by
`models.LevelBank.step_with_exits` under a mesh).
"""

from .distributed import global_mesh, initialize, initialize_from_env, launch
from .mesh import (
    frame_sharding,
    gather_envs,
    make_mesh,
    mean_metric,
    replicate_pytree,
    shard_batch_pytree,
    shard_sim,
)

__all__ = [
    "make_mesh",
    "shard_sim",
    "shard_batch_pytree",
    "replicate_pytree",
    "mean_metric",
    "frame_sharding",
    "gather_envs",
    "initialize",
    "initialize_from_env",
    "global_mesh",
    "launch",
]
