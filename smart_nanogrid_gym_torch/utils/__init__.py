from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .profiling import PhaseTimer, ThroughputMeter, device_trace
from .weights import (
    ddpg_state_from_jax,
    ddpg_state_to_jax,
    load_actor_critic_npz,
    load_ddpg_actor_npz,
    ppo_state_from_jax,
    ppo_state_to_jax,
)

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
    "device_trace",
    "PhaseTimer",
    "ThroughputMeter",
    "load_actor_critic_npz",
    "load_ddpg_actor_npz",
    "ppo_state_from_jax",
    "ppo_state_to_jax",
    "ddpg_state_from_jax",
    "ddpg_state_to_jax",
]
