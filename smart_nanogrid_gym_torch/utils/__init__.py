from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .profiling import device_trace

# the weight loaders import the learners, whose modules import ``profiling``
# from this package: they load on first use
_WEIGHTS = (
    "ddpg_state_from_jax",
    "ddpg_state_to_jax",
    "load_actor_critic_npz",
    "load_ddpg_actor_npz",
    "ppo_state_from_jax",
    "ppo_state_to_jax",
)

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
    "device_trace",
    "load_actor_critic_npz",
    "load_ddpg_actor_npz",
    "ppo_state_from_jax",
    "ppo_state_to_jax",
    "ddpg_state_from_jax",
    "ddpg_state_to_jax",
]


def __getattr__(name):
    if name in _WEIGHTS:
        from . import weights

        return getattr(weights, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
