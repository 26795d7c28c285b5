"""Policy evaluation (port of ``solvers/evaluator.py``).

- :func:`evaluate_policies_same_days` scores several policies on identical
  days (the reference evaluator's paired design) on the plain engine.  The
  days are generated from ``seed`` or given explicitly as initial states.
- :func:`evaluate_policy_at_scale` runs a deterministic actor (the PPO
  actor's clipped mean, or the DDPG actor with ``algorithm="ddpg"``) over
  ``num_days × batch`` fresh days in one launch of kernel K6 (its plain twin
  on CPU params).
- :func:`predict_single_day` rolls one day of one env with a policy and
  returns the per-step rewards and the stacked telemetry (the reference
  predictor's ``prediction_results.json`` series).
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from ..core.config import NanogridConfig
from ..core.generate import generate_schedule
from ..core.params import NanogridParams
from ..core.env import SmartNanogridTorch
from ..core.state import DaySchedule, EnvState, StepInfo
from ..core.transition import reset, step
from ..ops.gen_policy_rollout import gen_policy_multiday
from ..ops.param_guard import check_baked_params
from ..utils.profiling import spanned
from .networks import ActorCritic, DDPGActor


def evaluate_policies_same_days(
    config: NanogridConfig,
    params: NanogridParams,
    policies: dict[str, Callable[[torch.Tensor], torch.Tensor]],
    num_days: int = 100,
    seed: int = 0,
    *,
    states0: EnvState | None = None,
    obs0: torch.Tensor | None = None,
) -> dict[str, np.ndarray]:
    """Per-day returns ``(num_days,)`` of each policy on the same days.

    ``policies`` maps a name to ``policy(obs (B, F)) -> actions (B, A)``.
    Without ``states0``/``obs0`` the days are generated on the params' device
    from a ``torch.Generator`` seeded with ``seed``; with them (one env per
    day, for example days built by the JAX package), those days are used.
    """
    if (states0 is None) != (obs0 is None):
        raise ValueError("pass both states0 and obs0, or neither")
    if states0 is not None and (states0.t.shape[0] != num_days or obs0.shape[0] != num_days):
        raise ValueError(f"states0 and obs0 must hold num_days={num_days} envs, got "
                         f"{states0.t.shape[0]} and {obs0.shape[0]}")
    if states0 is None:
        gen = torch.Generator(device=params.device).manual_seed(seed)
        schedule = generate_schedule(config, params, generator=gen, batch=num_days)
        states0, obs0 = reset(config, params, schedule, generator=gen)

    results = {}
    with torch.no_grad():
        for name, policy in policies.items():
            state, obs = states0, obs0
            total = None
            for _ in range(config.steps_per_day):
                res = step(config, params, state, policy(obs), next_pv_shift=state.pv_shift)
                state, obs = res.state, res.obs
                total = res.reward if total is None else total + res.reward
            results[name] = total.cpu().numpy()
    return results


@spanned("evaluate")
def evaluate_policy_at_scale(
    config: NanogridConfig,
    params: NanogridParams,
    net: ActorCritic | DDPGActor,
    num_days: int = 10_000,
    batch: int = 4096,
    seed: int = 0,
    algorithm: str = "ppo",
) -> dict[str, float]:
    """Deterministic-actor evaluation over ``num_days × batch`` fresh days in
    one launch of kernel K6, on the device of ``params``.  ``algorithm`` is
    the actor's kind: ``"ppo"`` (an :class:`ActorCritic`) or ``"ddpg"`` (a
    :class:`DDPGActor`).

    Returns ``{"mean_day_return", "std_day_return", "total_days"}``.
    """
    check_baked_params(config, params, "evaluate_policy_at_scale",
                       generation=True, battery_init=True)
    stats = gen_policy_multiday(config, params, net, num_days, seed, batch, actor=algorithm).double()
    total = float(num_days * batch)
    mean = float(stats[0].sum()) / total
    var = float(stats[1].sum()) / total - mean * mean
    return {
        "mean_day_return": mean,
        "std_day_return": math.sqrt(max(var, 0.0)),
        "total_days": int(total),
    }


def predict_single_day(
    config: NanogridConfig,
    params: NanogridParams,
    policy: Callable[[torch.Tensor], torch.Tensor],
    generator: torch.Generator | None = None,
    schedule: DaySchedule | None = None,
    pv_shift: float | None = None,
) -> tuple[np.ndarray, StepInfo]:
    """Roll one day of one env with ``policy`` (``obs (F,) -> actions (A,)``)
    on the device of ``params``; returns ``(rewards (T,), StepInfo)`` with
    every telemetry leaf stacked along a leading time axis.

    ``schedule`` (one env's ``(N, L)`` tables, e.g. from
    :func:`..core.generate.load_initial_values_json`) replays a recorded day
    and ``pv_shift`` pins the PV shift; whatever is not given is drawn from
    ``generator`` (a fresh one seeded with 0 when omitted).  The battery
    starts at ``params.batt_init_soc``.  Unlike the JAX function, a pinned PV
    shift already scales the reset observation.
    """
    if generator is None:
        generator = torch.Generator(device=params.device).manual_seed(0)
    env = SmartNanogridTorch(config)
    state, obs = env.reset(params, generator, schedule=schedule, pv_shift=pv_shift)
    rewards, infos = [], []
    with torch.no_grad():
        for _ in range(config.steps_per_day):
            res = env.step(params, state, policy(obs), generator)
            state, obs = res.state, res.obs
            rewards.append(res.reward)
            infos.append(res.info)
    return torch.stack(rewards).cpu().numpy(), StepInfo(*(torch.stack(f) for f in zip(*infos)))
