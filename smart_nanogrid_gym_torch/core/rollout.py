"""Fused full-day rollout on time-major tables (port of ``rollout.py:62-345``).

All envs advance in lockstep through a fixed-length day, so the timestep is
the loop index: the schedule tables are transposed once to ``(T, B, N)`` and
sliced per step, the lookahead windows are precomputed, and the SoC history
needs only the previously written column as a carry.  This is the port's
plain engine path, the oracle the kernels in ``ops/`` are held against.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .config import NanogridConfig

from . import physics
from .params import NanogridParams, broadcast_params
from .state import EnvState, StepInfo
from .transition import _finish_obs, _penalty_mask_table, draw_pv_shift


class DayTables(NamedTuple):
    """Time-major per-step inputs (leaves ``(T, B, ...)``)."""

    occupancy: torch.Tensor
    capacity_eff: torch.Tensor
    requested_prev: torch.Tensor
    soc_cols: torch.Tensor
    is_arrival: torch.Tensor
    dep_obs: torch.Tensor
    penalty_mask: torch.Tensor
    price: torch.Tensor
    price_norm: torch.Tensor
    price_pred: torch.Tensor
    rad_norm: torch.Tensor
    rad_pred: torch.Tensor
    solar_power: torch.Tensor


def build_day_tables(config: NanogridConfig, params: NanogridParams, state: EnvState) -> DayTables:
    """All time-major per-step inputs of one day."""
    T, k = config.steps_per_day, config.lookahead
    B = state.t.shape[0]
    p = broadcast_params(params, B)
    sched = state.schedule

    def tm(table):  # (B, N, L) -> (T, B, N), columns 0..T-1
        return table[..., :T].permute(2, 0, 1)

    def trace(vec):  # (B, P) -> (T, B)
        return vec[:, :T].transpose(0, 1)

    def windows(vec):  # (B, P) -> (T, B, k)
        return torch.stack([vec[:, t + 1: t + 1 + k] for t in range(T)], dim=0)

    # capacity at t on arrival, else at t-1; roll brings column (t-1) mod L to t
    cap_prev = torch.roll(sched.capacity, 1, dims=-1)
    cap_eff = torch.where(sched.is_arrival > 0, sched.capacity, cap_prev)
    req_prev = torch.roll(sched.requested_soc, 1, dims=-1)

    return DayTables(
        occupancy=tm(sched.occupancy),
        capacity_eff=tm(cap_eff),
        requested_prev=tm(req_prev),
        soc_cols=tm(state.soc),
        is_arrival=tm(sched.is_arrival),
        dep_obs=tm(sched.dep_obs),
        penalty_mask=tm(_penalty_mask_table(config, sched)),
        price=trace(p.price),
        price_norm=trace(p.price_norm),
        price_pred=windows(p.price_norm),
        rad_norm=trace(p.rad_norm),
        rad_pred=windows(p.rad_norm),
        solar_power=trace(p.solar_power),
    )


def _assemble_obs(config, tables, t, soc_col, dep_col, batt_soc, pv_shift):
    if config.pv_system:
        parts = [
            (tables.rad_norm[t] * pv_shift)[:, None],
            tables.price_norm[t][:, None],
            tables.rad_pred[t] * pv_shift[:, None],
            tables.price_pred[t],
        ]
    else:
        parts = [tables.price_norm[t][:, None], tables.price_pred[t]]
    parts += [soc_col, dep_col / 24.0]
    if config.battery_system:
        parts += [batt_soc[:, None]]
    return _finish_obs(config, parts)


def fused_day_rollout(
    config: NanogridConfig,
    params: NanogridParams,
    state: EnvState,
    policy_fn: Callable[[torch.Tensor], torch.Tensor],
    *,
    collect_info: bool = False,
    obs0: torch.Tensor | None = None,
    next_pv_shift: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    policy_aux: bool = False,
    policy_xs: torch.Tensor | None = None,
):
    """Roll exactly one day from day start (``state.t == 0``) for every env.

    ``policy_fn(obs (B, F)) -> actions (B, A)``.  Returns ``(next_state,
    (obs, reward, done[, info][, aux]))`` stacked time-major.  The day-end PV
    shift is ``next_pv_shift`` or drawn from ``generator``; the schedule and
    the battery carry over (SURVEY.md Q8).  ``obs0`` is the observation the
    first step acts on (the reset observation when omitted; continuation runs
    pass the previous day's trailing observation).

    ``policy_xs`` (leading axis T) feeds the policy a per-step input, called
    as ``policy_fn(obs, policy_xs[t])``: how the PPO learner injects its action
    noise.  With ``policy_aux`` the policy returns ``(actions, aux)``, a tuple
    of tensors, and the stacked ``aux`` ends the trajectory (rollout.py:141-153).
    """
    T, N, dt = config.steps_per_day, config.num_chargers, config.time_interval
    B = state.t.shape[0]
    p = broadcast_params(params, B)
    dtype, device = params.dtype, params.device
    zero = torch.zeros((), dtype=dtype, device=device)
    tables = build_day_tables(config, params, state)
    mask = p.charger_mask

    def bcol(x):
        return x[:, None]

    prev_col = state.soc[..., config.table_len - 1]
    batt_soc = state.batt_soc
    batt_init = state.batt_soc
    pmask = state.pmask
    pv_shift = state.pv_shift
    obs = obs0 if obs0 is not None else _assemble_obs(
        config, tables, 0, state.soc[..., 0], tables.dep_obs[0], batt_soc, pv_shift)

    obs_traj, rewards, dones, cols, infos, auxs = [], [], [], [], [], []
    for t in range(T):
        out = policy_fn(obs) if policy_xs is None else policy_fn(obs, policy_xs[t])
        if policy_aux:
            out, aux = out
            auxs.append(aux)
        actions = out.to(dtype)
        charger_actions = actions[:, :N]
        battery_action = actions[:, -1] if config.battery_system else torch.zeros(B, dtype=dtype, device=device)

        occupied = tables.occupancy[t] > 0
        soc_eff = torch.where(tables.is_arrival[t] > 0, tables.soc_cols[t], prev_col)
        ch = physics.charger_step(
            charger_actions, occupied, soc_eff, tables.capacity_eff[t], mask,
            bcol(p.charger_max_power), bcol(p.charger_efficiency),
            bcol(p.nonexistent_marker), dt,
        )
        new_col = torch.where(occupied & (mask > 0), ch.soc_new, tables.soc_cols[t])

        total_charging = torch.sum(torch.where(ch.power > 0, ch.power, zero), dim=-1)
        total_discharging = torch.sum(torch.where(ch.power < 0, ch.power, zero), dim=-1)
        vehicle_penalty = physics.vehicle_insufficiency_penalty(
            pmask, prev_col, tables.requested_prev[t],
            bcol(p.soc_margin_ratio), bcol(p.penalty_gain),
        )
        nonexistent_penalty = torch.sum(ch.nonexistent, dim=-1)

        if config.pv_system:
            solar_power = tables.solar_power[t] * pv_shift
        else:
            solar_power = torch.zeros(B, dtype=dtype, device=device)
        remaining = (total_charging + total_discharging) - solar_power

        if config.battery_system:
            b = physics.battery_step(
                battery_action, remaining, batt_soc, p.batt_capacity,
                p.batt_max_power, p.batt_efficiency, dt,
            )
            grid_power = b.remaining_demand
            batt_soc = b.soc_new
            dod_penalty = physics.battery_dod_penalty(batt_soc, p.batt_dod, p.penalty_gain)
            batt_power_used, batt_power_calc = b.power_used, b.power_calculated
        else:
            grid_power = remaining
            dod_penalty = torch.zeros(B, dtype=dtype, device=device)
            batt_power_used = batt_power_calc = dod_penalty

        grid_energy = grid_power * dt
        g_cost = physics.grid_energy_cost(grid_energy, tables.price[t], p.sell_coefficient)
        total_penalty = p.w_battery_penalty * dod_penalty + p.w_vehicle_penalty * vehicle_penalty
        total_cost = p.grid_cost_weight * torch.abs(g_cost) + total_penalty
        reward = -total_cost

        obs = _assemble_obs(config, tables, t, new_col, tables.dep_obs[t], batt_soc, pv_shift)
        obs_traj.append(obs)
        rewards.append(reward)
        dones.append(torch.full((B,), t == T - 1, dtype=torch.bool, device=device))
        cols.append(new_col)
        if collect_info:
            zeros = torch.zeros(B, dtype=dtype, device=device)
            infos.append(StepInfo(
                total_cost=total_cost, grid_energy_cost=g_cost, grid_energy=grid_energy,
                grid_power=grid_power, utilized_solar_energy=solar_power,
                total_penalty=total_penalty, total_battery_penalty=dod_penalty,
                battery_soc_below_dod_penalty=dod_penalty,
                battery_overcharging_penalty=zeros, battery_over_discharging_penalty=zeros,
                low_resource_utilisation_penalty=zeros,
                total_vehicle_penalty=vehicle_penalty,
                insufficiently_charged_vehicles_penalty=vehicle_penalty,
                needlessly_charged_vehicles_penalty=zeros,
                overcharged_vehicles_penalty=zeros, over_discharged_vehicles_penalty=zeros,
                battery_action=battery_action, charger_actions=charger_actions,
                total_charging_power=total_charging, total_discharging_power=total_discharging,
                charger_power_values=ch.power, battery_power_value=batt_power_used,
                battery_calculated_power_value=batt_power_calc,
                battery_state_of_charge=batt_soc,
                initial_battery_state_of_charge=batt_init,
                discharging_nonexistent_vehicles_penalty=nonexistent_penalty,
            ))
        prev_col = new_col
        # the trailing observe recomputes the check set at the (old) t
        pmask = tables.penalty_mask[t]

    # columns 0..T-1 were each written once; the pad columns stay
    soc_hist = torch.cat([torch.stack(cols, dim=-1), state.soc[..., T:]], dim=-1)
    if next_pv_shift is None:
        if generator is None:
            raise ValueError("fused_day_rollout needs next_pv_shift or a generator for the day-end redraw")
        next_pv_shift = draw_pv_shift(B, generator, dtype, device)
    next_state = state._replace(
        soc=soc_hist,
        batt_soc=batt_soc,
        batt_init_soc=batt_init,
        pv_shift=next_pv_shift.to(dtype),
        pmask=pmask,
        day=state.day + 1,
    )
    traj = (torch.stack(obs_traj), torch.stack(rewards), torch.stack(dones))
    if collect_info:
        traj = traj + (StepInfo(*(torch.stack(f) for f in zip(*infos))),)
    if policy_aux:
        traj = traj + (tuple(torch.stack(f) for f in zip(*auxs)),)
    return next_state, traj
