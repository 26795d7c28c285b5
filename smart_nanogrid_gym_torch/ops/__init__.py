"""Kernels with their plain twins.  Importing this package builds nothing:
a CUDA library is compiled at the first launch that needs it."""

from ._build import launch_counts, reset_launch_counts
from .gen_policy_rollout import gen_policy_day, gen_policy_multiday
from .gen_rollout import gen_rbc_day, gen_rbc_multiday
from .param_guard import check_baked_params

__all__ = [
    "launch_counts",
    "reset_launch_counts",
    "gen_rbc_day",
    "gen_rbc_multiday",
    "gen_policy_day",
    "gen_policy_multiday",
    "check_baked_params",
]
