"""Batched environment engine: the user-facing API (port of ``env.py:28-125``).

``SmartNanogridTorch`` bundles a static :class:`NanogridConfig` with batched
entry points over the plain-PyTorch engine.  Every call takes its device
from the params and state it is given.
"""

from __future__ import annotations

from typing import Callable

import torch

from .config import NanogridConfig

from .generate import generate_schedule
from .params import NanogridParams, broadcast_params, make_params
from .rollout import fused_day_rollout
from .state import EnvState
from .transition import StepResult, reset, step


class SmartNanogridTorch:
    """Batched smart-nanogrid engine (leading env axis on every state leaf)."""

    def __init__(self, config: NanogridConfig | None = None, **kwargs):
        self.config = config or NanogridConfig(**kwargs)

    def default_params(self, dtype: torch.dtype = torch.float32,
                       device: torch.device | str = "cuda") -> NanogridParams:
        return make_params(self.config, dtype, device)

    def broadcast_params(self, params: NanogridParams, batch: int) -> NanogridParams:
        return broadcast_params(params, batch)

    def reset_batch(self, params: NanogridParams, batch: int, generator: torch.Generator,
                    batt_soc: torch.Tensor | None = None) -> tuple[EnvState, torch.Tensor]:
        """Fresh generated days for ``batch`` envs, drawn from ``generator``."""
        schedule = generate_schedule(self.config, params, generator=generator, batch=batch)
        return reset(self.config, params, schedule, batt_soc=batt_soc, generator=generator)

    def step_batch(self, params: NanogridParams, states: EnvState, actions: torch.Tensor,
                   generator: torch.Generator) -> StepResult:
        return step(self.config, params, states, actions, generator=generator)

    def rollout_day(
        self,
        params: NanogridParams,
        state: EnvState,
        policy_fn: Callable[[torch.Tensor], torch.Tensor],
        obs: torch.Tensor,
        generator: torch.Generator,
    ):
        """Roll exactly one day through the fused time-major loop.

        Returns ``(final_state, final_obs, (obs, reward, done, info))`` with
        trajectory leaves stacked along a leading time axis.
        """
        final_state, (obs_traj, rewards, dones, infos) = fused_day_rollout(
            self.config, params, state, policy_fn,
            collect_info=True, obs0=obs, generator=generator,
        )
        return final_state, obs_traj[-1], (obs_traj, rewards, dones, infos)
