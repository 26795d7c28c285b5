"""Env-batch sharding over ranks and the multi-process runtime (port of
``smart_nanogrid_gym_tpu/parallel``), on ``torch.distributed``."""

from .mesh import ENV_AXIS, EnvMesh, make_mesh, replicate, shard_env_batch, sharded_rollout_fn

__all__ = ["ENV_AXIS", "EnvMesh", "make_mesh", "shard_env_batch", "sharded_rollout_fn", "replicate"]
