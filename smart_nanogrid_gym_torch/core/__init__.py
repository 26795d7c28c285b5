"""Plain-PyTorch engine: params, state, generation, physics, transition,
fused day rollout and the batched env."""

from .config import NanogridConfig, PenaltyMode

from .env import SmartNanogridTorch
from .generate import (
    draw_uniforms, generate_schedule, schedule_from_reference_seed, schedules_from_reference_seeds)
from .params import NanogridParams, broadcast_params, make_params
from .rollout import build_day_tables, fused_day_rollout
from .state import DaySchedule, EnvState, StepInfo, StepResult
from .transition import observe, reset, step

__all__ = [
    "NanogridConfig",
    "PenaltyMode",
    "SmartNanogridTorch",
    "NanogridParams",
    "make_params",
    "broadcast_params",
    "DaySchedule",
    "EnvState",
    "StepInfo",
    "StepResult",
    "observe",
    "reset",
    "step",
    "draw_uniforms",
    "generate_schedule",
    "schedule_from_reference_seed",
    "schedules_from_reference_seeds",
    "build_day_tables",
    "fused_day_rollout",
]
