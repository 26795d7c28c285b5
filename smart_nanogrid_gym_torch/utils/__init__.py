from .weights import (
    ddpg_state_from_jax,
    ddpg_state_to_jax,
    load_actor_critic_npz,
    load_ddpg_actor_npz,
    ppo_state_from_jax,
    ppo_state_to_jax,
)

__all__ = ["load_actor_critic_npz", "load_ddpg_actor_npz", "ppo_state_from_jax", "ppo_state_to_jax",
           "ddpg_state_from_jax", "ddpg_state_to_jax"]
