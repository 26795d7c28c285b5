from .ddpg import DDPGConfig, DDPGDraws, DDPGLearner, DDPGMetrics, DDPGTrainState, ReplayBuffer, ou_step
from .evaluator import evaluate_policies_same_days, evaluate_policy_at_scale, predict_single_day
from .networks import (
    ActorCritic,
    DDPGActor,
    DDPGCritic,
    actor_critic_from_flax,
    ddpg_actor_from_flax,
    ddpg_critic_from_flax,
    make_actor_policy_fn,
    make_ddpg_policy_fn,
)
from .ppo import PPOConfig, PPOLearner, PPOMetrics, PPOTrainState
from .rbc import make_rbc_policy_fn, rbc_policy

__all__ = [
    "ActorCritic",
    "actor_critic_from_flax",
    "make_actor_policy_fn",
    "DDPGActor",
    "DDPGCritic",
    "ddpg_actor_from_flax",
    "ddpg_critic_from_flax",
    "make_ddpg_policy_fn",
    "PPOConfig",
    "PPOLearner",
    "PPOMetrics",
    "PPOTrainState",
    "DDPGConfig",
    "DDPGDraws",
    "DDPGLearner",
    "DDPGMetrics",
    "DDPGTrainState",
    "ReplayBuffer",
    "ou_step",
    "rbc_policy",
    "make_rbc_policy_fn",
    "evaluate_policies_same_days",
    "evaluate_policy_at_scale",
    "predict_single_day",
]
