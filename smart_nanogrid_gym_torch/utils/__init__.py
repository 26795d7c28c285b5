from .weights import load_actor_critic_npz, ppo_state_from_jax, ppo_state_to_jax

__all__ = ["load_actor_critic_npz", "ppo_state_from_jax", "ppo_state_to_jax"]
