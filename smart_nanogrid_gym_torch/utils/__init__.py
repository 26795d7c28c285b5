from .weights import load_actor_critic_npz

__all__ = ["load_actor_critic_npz"]
