"""Kernels with their plain twins.  Importing this package builds nothing:
a CUDA library is compiled at the first launch that needs it."""

from ._build import launch_counts, reset_launch_counts
from .collect import ppo_collect_day, ppo_collect_day_seeded
from .ddpg_collect import ddpg_collect_day, ddpg_collect_day_seeded
from .ddpg_sweep import DDPGSweepHypers, ddpg_sweep
from .gen_policy_rollout import gen_policy_day, gen_policy_multiday
from .gen_rollout import gen_rbc_day, gen_rbc_multiday
from .param_guard import check_baked_params
from .policy_rollout import policy_day_rollout
from .ppo_sweep import SweepHypers, ppo_sweep, ppo_sweep_streamed
from .rollout import rbc_day_rollout

__all__ = [
    "launch_counts",
    "reset_launch_counts",
    "gen_rbc_day",
    "gen_rbc_multiday",
    "gen_policy_day",
    "gen_policy_multiday",
    "ppo_collect_day",
    "ppo_collect_day_seeded",
    "ppo_sweep",
    "ppo_sweep_streamed",
    "SweepHypers",
    "ddpg_collect_day",
    "ddpg_collect_day_seeded",
    "ddpg_sweep",
    "DDPGSweepHypers",
    "rbc_day_rollout",
    "policy_day_rollout",
    "check_baked_params",
]
