"""One day of the PPO actor from a given state, tables in: kernel K11b with its twin.

Replaces ``smart_nanogrid_gym_tpu/ops/pallas_policy_rollout.py::pallas_policy_day_rollout``:
the deterministic PPO actor (the ``pi`` torso's mean, clipped to the action
box) rolls the day of a batched :class:`EnvState` with the full charger and
BESS physics, both branches.  The tables are those of K11a
(:func:`.rollout.state_tables`); the kernel (``policy_day_rollout_tables_kernel``
in ``csrc/day_step.cuh``) is K6's block-actor template with the tables in
place of the day's generation, for every torso: 32 envs a block, an env warp
that runs the step body once per env from the step's table rows (which the
product warps stage in shared memory a step ahead), register-tiled products,
the weights in :func:`.gen_policy_rollout.k6_block`'s layout through a TMA
ring.  It counts as ``policy_day_rollout``, or ``policy_day_rollout_block``
for a torso whose K5 takes the block-level design (the bench's 256x256).
Kept as the JAX kernel has them: the observation at t=0 takes its SoC rows from
the state's column 0, the penalty the column L-1; the charger discharge flag
is inverted (``calc >= 0``), the BESS's is not.

On CUDA tensors the wrapper launches the kernel; on CPU tensors it runs the
plain twin :func:`policy_day_rollout_plain`, which sums in the kernel's order:
the kernel is bit-equal to it.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from ..core.config import NanogridConfig
from ..core.params import NanogridParams
from ..core.state import EnvState
from . import _build
from ._build import kernel_device
from .gen_policy_rollout import (
    ActorWeights,
    actor_mean,
    actor_weights,
    battery_physics,
    charger_flows,
    charger_physics,
    policy_day_costs,
    policy_library,
    policy_obs,
)
from .gen_rollout import F32, Traces, insufficiency_penalty, kernel_traces, sum_rows
from .param_guard import EFF, MAX_P, W_VEH, check_baked_params
from .rollout import StateTables, state_tables

if TYPE_CHECKING:
    from ..solvers.networks import ActorCritic


def policy_day_rollout_plain(config: NanogridConfig, traces: Traces, weights: ActorWeights, st: StateTables):
    """Plain twin of K11b on f32 tables: ``(rewards (T, B), actions (T, A, B),
    soc_final (N, B))``."""
    T, N, dt = config.steps_per_day, config.num_chargers, config.time_interval
    pv, batt = config.pv_system, config.battery_system
    occ, cap, req, soc_cols, isarr, dep, pmask_tab = st.tables.unbind(0)
    prev_col, pmask, batt_soc, pv_shift = st.prev_col, st.pmask, st.batt_soc, st.pv_shift
    one = torch.ones((), dtype=F32, device=pv_shift.device)
    rows_list, actions = [], []
    for t in range(T):
        o = max(t - 1, 0)
        obs = policy_obs(traces, o, pv_shift, soc_cols[0] if t == 0 else prev_col, dep[o], batt_soc,
                         pv=pv, batt=batt)
        act = actor_mean(weights, obs)
        occupied = occ[t] > 0
        soc_eff = torch.where(isarr[t] > 0, soc_cols[t], prev_col)
        calc = soc_eff + (act[:N] * (MAX_P * EFF) * dt) / torch.where(cap[t] > 0, cap[t], one)
        power, soc_new = charger_physics(act[:N], soc_eff, cap[t], calc, dt, occupied)
        rows = {"flows": charger_flows(power), "pen": sum_rows(insufficiency_penalty(pmask, prev_col, req[t]))}
        if batt:
            batt_soc, rows["p_used"], rows["dod"] = battery_physics(act[N], batt_soc, dt)
        pmask = pmask_tab[t]  # the trailing observe's mask for the next step
        prev_col = torch.where(occupied, soc_new, soc_cols[t])
        rows_list.append(rows)
        actions.append(act)
    stacked = {k: torch.stack([r[k] for r in rows_list]) for k in rows_list[0]}
    cost = policy_day_costs(stacked, traces.price[:T, None], traces.solar[:T, None], pv_shift,
                            dt=dt, pv=pv, batt=batt)
    return -(cost + W_VEH * stacked["pen"]), torch.stack(actions), prev_col


def launch_policy_day(config: NanogridConfig, traces: Traces, weights: ActorWeights, st: StateTables,
                      hidden: tuple[int, int]):
    """Launch K11b on tables and weights already on the card; ``(rewards (T,
    B), actions (T, A, B), soc_final (N, B))``."""
    T, N, A = config.steps_per_day, config.num_chargers, config.num_actions
    st = st.checked()
    device, B = st.tables.device, st.pv_shift.shape[0]
    rewards = torch.empty((T, B), dtype=F32, device=device)
    actions = torch.empty((T, A, B), dtype=F32, device=device)
    soc_final = torch.empty((N, B), dtype=F32, device=device)
    lib, block, name = policy_library(config, device, weights, hidden, "ppo", traces, "policy_day_rollout")
    _build.launch(
        name, lib.ngk_policy_day_rollout,
        traces.price, traces.price_norm, traces.price_norm.numel(), traces.rad_norm, traces.rad_norm.numel(),
        traces.solar, *st, block, rewards, actions, soc_final, B, T, config.time_interval,
        device=device,
    )
    return rewards, actions, soc_final


def policy_day_rollout(config: NanogridConfig, params: NanogridParams, state: EnvState, net: ActorCritic):
    """Roll one day of ``net``'s deterministic actor over the batched
    ``state`` (K11b).

    ``net`` is an :class:`ActorCritic` (only its ``pi`` torso runs);
    ``state`` is at day start for every env; ``params`` are unbatched or
    batched with equal rows (:func:`.rollout.one_row`).
    Returns ``(rewards (T, B), actions (T, A, B), soc_final (N, B))``; any
    batch size works.
    """
    check_baked_params(config, params, "policy_day_rollout")
    if config.lookahead != 3:
        raise ValueError("policy_day_rollout bakes the reference 3-step observation lookahead; "
                         "use the plain engine for other lookaheads")
    device = state.soc.device
    traces = kernel_traces(params, device)
    weights = actor_weights(config, net, device)
    st = state_tables(config, params, state)
    if not kernel_device(state.soc):
        return policy_day_rollout_plain(config, traces, weights, st.to(F32))
    return launch_policy_day(config, traces, weights, st, net.hidden)
