"""Rule-based controller (port of ``solvers/rbc.py:28-70``).

Per charger, with the normalised departure d = departure/24, the radiation
r(t) and its one-step-ahead prediction r(t+1):

- d == 0                → action 0 (no vehicle)
- 0 < d < 0.16667       → action 1 (charge at full power)
- otherwise             → (r(t) + r(t+1)) / 2

The observation offsets are derived from the config.  The battery, when
present, gets action 0.
"""

from __future__ import annotations

import torch

from ..core.config import NanogridConfig
from ..ops.param_guard import DEPARTURE_SOON_THRESHOLD


def rbc_policy(config: NanogridConfig, obs: torch.Tensor) -> torch.Tensor:
    """RBC actions ``(..., num_actions)`` for observations ``(..., obs_dim)``."""
    n = config.num_chargers
    head = (1 + int(config.pv_system)) * (1 + config.lookahead)
    departures = obs[..., head + n: head + 2 * n]
    if config.pv_system:
        fallback = ((obs[..., 0] + obs[..., 2]) / 2.0)[..., None]
    else:
        fallback = torch.zeros(obs.shape[:-1] + (1,), dtype=obs.dtype, device=obs.device)

    one = torch.ones((), dtype=obs.dtype, device=obs.device)
    actions = torch.where(
        departures == 0,
        torch.zeros((), dtype=obs.dtype, device=obs.device),
        torch.where(departures < DEPARTURE_SOON_THRESHOLD, one, fallback),
    )
    if config.battery_system:
        actions = torch.cat([actions, torch.zeros_like(actions[..., :1])], dim=-1)
    return actions


def make_rbc_policy_fn(config: NanogridConfig):
    """Policy callable ``obs -> actions`` for rollout loops."""

    def policy(obs: torch.Tensor) -> torch.Tensor:
        return rbc_policy(config, obs)

    return policy
