"""Batched environment engine: the user-facing API (port of ``env.py:28-125``).

``SmartNanogridTorch`` bundles a static :class:`NanogridConfig` with entry
points over the plain-PyTorch engine: batched ones (a leading env axis on
every state leaf) and single-env ones (``reset``, ``step``, ``observe``,
``rollout_day(batched=False)``), which run a batch of one and squeeze it at
the edge.  Every call takes its device from the params and state it is
given.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..utils.profiling import span, spanned
from .config import NanogridConfig

from .generate import generate_schedule
from .params import NanogridParams, broadcast_params, make_params
from .rollout import fused_day_rollout
from .state import DaySchedule, EnvState, StepResult
from .transition import draw_pv_shift, observe, reset, step


def _map(fn, tree):
    """``fn`` on every tensor of a tree of (named) tuples."""
    if isinstance(tree, tuple):
        items = [_map(fn, x) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return fn(tree)


def _batch(tree):
    """One env's state (or schedule) as a batch of one."""
    return _map(lambda x: x[None], tree)


def _unbatch(tree, axis: int = 0):
    """Drop the batch of one at ``axis`` from every leaf."""
    return _map(lambda x: x.squeeze(axis), tree)


class SmartNanogridTorch:
    """Smart-nanogrid engine over the plain-PyTorch transition."""

    def __init__(self, config: NanogridConfig | None = None, **kwargs):
        self.config = config or NanogridConfig(**kwargs)

    def default_params(self, dtype: torch.dtype = torch.float32,
                       device: torch.device | str = "cuda") -> NanogridParams:
        return make_params(self.config, dtype, device)

    def broadcast_params(self, params: NanogridParams, batch: int) -> NanogridParams:
        return broadcast_params(params, batch)

    # ---- single env ---------------------------------------------------------

    def reset(self, params: NanogridParams, generator: torch.Generator,
              batt_soc: torch.Tensor | float | None = None, schedule: DaySchedule | None = None,
              pv_shift: torch.Tensor | float | None = None) -> tuple[EnvState, torch.Tensor]:
        """Start one env's day: ``(state, obs (F,))``, state leaves without a
        batch axis.

        ``schedule`` (``(N, L)`` tables) replays a recorded day; otherwise one
        is generated.  The PV shift is drawn first (unless pinned), then the
        schedule, so that a replay from the same generator state gets the
        same PV shift as the generated day.
        """
        dtype, device = params.dtype, params.device
        if pv_shift is None:
            pv_shift = draw_pv_shift(1, generator, dtype, device)
        if schedule is None:
            schedule = generate_schedule(self.config, params, generator=generator, batch=1)
        else:
            schedule = _batch(schedule)

        def as_batch(x):
            return None if x is None else torch.as_tensor(x, dtype=dtype, device=device).reshape(1)

        state, obs = reset(self.config, params, schedule, batt_soc=as_batch(batt_soc),
                           pv_shift=as_batch(pv_shift))
        return _unbatch(state), obs[0]

    def step(self, params: NanogridParams, state: EnvState, action: torch.Tensor,
             generator: torch.Generator) -> StepResult:
        """One step of one env; ``generator`` draws the PV shift at day end."""
        res = step(self.config, params, _batch(state), action.reshape(1, -1), generator=generator)
        return _unbatch(res)

    def observe(self, params: NanogridParams, state: EnvState) -> torch.Tensor:
        return observe(self.config, params, _batch(state))[0]

    # ---- batched ------------------------------------------------------------

    def reset_batch(self, params: NanogridParams, batch: int, generator: torch.Generator,
                    batt_soc: torch.Tensor | None = None) -> tuple[EnvState, torch.Tensor]:
        """Fresh generated days for ``batch`` envs, drawn from ``generator``."""
        with span("generate"):
            schedule = generate_schedule(self.config, params, generator=generator, batch=batch)
        return reset(self.config, params, schedule, batt_soc=batt_soc, generator=generator)

    @spanned("engine.step")
    def step_batch(self, params: NanogridParams, states: EnvState, actions: torch.Tensor,
                   generator: torch.Generator) -> StepResult:
        return step(self.config, params, states, actions, generator=generator)

    # ---- rollouts ------------------------------------------------------------

    def rollout_day(
        self,
        params: NanogridParams,
        state: EnvState,
        policy_fn: Callable[[torch.Tensor], torch.Tensor],
        obs: torch.Tensor,
        generator: torch.Generator,
        batched: bool = True,
    ):
        """Roll exactly one day through the fused time-major loop.

        Returns ``(final_state, final_obs, (obs, reward, done, info))`` with
        trajectory leaves stacked along a leading time axis.  With
        ``batched=False`` the state and ``obs`` are one env's, and so are the
        results; ``policy_fn`` sees a batch of one either way.
        """
        if not batched:
            state, obs = _batch(state), obs[None]
        final_state, (obs_traj, rewards, dones, infos) = fused_day_rollout(
            self.config, params, state, policy_fn,
            collect_info=True, obs0=obs, generator=generator,
        )
        if not batched:
            final_state = _unbatch(final_state)
            obs_traj, rewards, dones, infos = _unbatch((obs_traj, rewards, dones, infos), axis=1)
        return final_state, obs_traj[-1], (obs_traj, rewards, dones, infos)

    def rollout_actions(self, params: NanogridParams, state: EnvState, actions: torch.Tensor,
                        generator: torch.Generator, batched: bool = True):
        """Roll a precomputed action sequence ``(T, [B,] A)`` step by step.

        Returns ``(final_state, (obs, reward, done, info))`` stacked along a
        leading time axis.
        """
        step_fn = self.step_batch if batched else self.step
        traj = []
        for a_t in actions:
            res = step_fn(params, state, a_t, generator)
            state = res.state
            traj.append((res.obs, res.reward, res.done, res.info))
        return state, _stack(traj)


def _stack(steps):
    """Per-step ``(obs, reward, done, info)`` stacked along a leading time axis."""
    obs, reward, done, infos = zip(*steps)
    return (torch.stack(obs), torch.stack(reward), torch.stack(done),
            type(infos[0])(*(torch.stack(f) for f in zip(*infos))))
