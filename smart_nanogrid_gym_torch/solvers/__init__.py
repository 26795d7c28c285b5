from .evaluator import evaluate_policies_same_days, evaluate_policy_at_scale
from .networks import ActorCritic, actor_critic_from_flax, make_actor_policy_fn
from .ppo import PPOConfig, PPOLearner, PPOMetrics, PPOTrainState
from .rbc import make_rbc_policy_fn, rbc_policy

__all__ = [
    "ActorCritic",
    "actor_critic_from_flax",
    "make_actor_policy_fn",
    "PPOConfig",
    "PPOLearner",
    "PPOMetrics",
    "PPOTrainState",
    "rbc_policy",
    "make_rbc_policy_fn",
    "evaluate_policies_same_days",
    "evaluate_policy_at_scale",
]
