"""The environment transition: ``reset`` / ``observe`` / ``step``
(port of ``transition.py:52-319``), batched over a leading env axis.

The reference's ordering is kept as the JAX package keeps it:

- the observation is taken **before** the timestep increment;
- the vehicle penalty-check mask used at step t is the one the trailing
  observe of step t-1 computed (carried in ``state.pmask``, also across a day
  rollover);
- the penaliser reads SoC and requested SoC at ``(t-1) mod L``;
- a finished day resets t and redraws the PV shift but keeps the schedule and
  the battery SoC.

:func:`step` runs the plain twin :func:`step_plain` for params on the CPU and
one launch of the kernel of ``csrc/engine_step.cu`` for params on the card
(``ops/engine_step.py``), bit for bit the same; the twin sums over the
chargers in index order, as the kernel does.
"""

from __future__ import annotations

import torch

from .config import NanogridConfig, PenaltyMode

from . import physics
from .generate import draw_pv_percent
from .params import NanogridParams, broadcast_params
from .state import DaySchedule, EnvState, StepInfo, StepResult


def _col(table: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Column t[b] of each env's (N, L) table: (B, N, L), (B,) -> (B, N)."""
    idx = t.view(-1, 1, 1).expand(-1, table.shape[1], 1)
    return table.gather(2, idx).squeeze(2)


def _at(vec: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Entry t[b] of each env's trace: (B, P), (B,) -> (B,)."""
    return vec.gather(1, t[:, None]).squeeze(1)


def _window(vec: torch.Tensor, start: torch.Tensor, size: int) -> torch.Tensor:
    """``size`` entries from start[b] (clamped in bounds like dynamic_slice)."""
    start = torch.clamp(start, 0, vec.shape[1] - size)
    idx = start[:, None] + torch.arange(size, device=vec.device)
    return vec.gather(1, idx)


def _penalty_mask_table(config: NanogridConfig, schedule: DaySchedule) -> torch.Tensor:
    """Selection of the penalty-check mask table (charging_station.py:50-60)."""
    if config.penalty_mode == PenaltyMode.NO_PENALTY:
        return torch.zeros_like(schedule.occupancy)
    if config.penalty_mode == PenaltyMode.ON_DEPARTURE:
        return schedule.mask_departing
    if config.penalty_mode == PenaltyMode.SPARSE:
        return schedule.mask_departing3
    return schedule.occupancy  # DENSE


def _finish_obs(config: NanogridConfig, parts: list[torch.Tensor]) -> torch.Tensor:
    obs = torch.cat(parts, dim=-1)
    return obs.to(torch.float32) if config.cast_obs_to_f32 else obs


def observe(config: NanogridConfig, params: NanogridParams, state: EnvState) -> torch.Tensor:
    """Observation ``(B, obs_dim)`` (env.py:190-231): ``[rad(t)·shift, price(t),
    rad_pred·shift, price_pred, soc_1..N, dep_1..N / 24, battery_soc]``, the PV
    terms dropped without PV and the battery term without a BESS."""
    B = state.t.shape[0]
    p = broadcast_params(params, B)
    t = state.t
    k = config.lookahead

    price_now = _at(p.price_norm, t)
    price_pred = _window(p.price_norm, t + 1, k)
    soc_obs = _col(state.soc, t)
    dep_obs = _col(state.schedule.dep_obs, t) / 24.0

    if config.pv_system:
        rad_now = _at(p.rad_norm, t) * state.pv_shift
        rad_pred = _window(p.rad_norm, t + 1, k) * state.pv_shift[:, None]
        parts = [rad_now[:, None], price_now[:, None], rad_pred, price_pred]
    else:
        parts = [price_now[:, None], price_pred]
    parts += [soc_obs, dep_obs]
    if config.battery_system:
        parts += [state.batt_soc[:, None]]
    return _finish_obs(config, parts)


def draw_pv_shift(batch: int, generator: torch.Generator, dtype: torch.dtype,
                  device: torch.device | str) -> torch.Tensor:
    """randint(0, 180)/100 with both ends inclusive (env.py:349)."""
    return draw_pv_percent(batch, generator, device).to(dtype) / 100.0


def reset(
    config: NanogridConfig,
    params: NanogridParams,
    schedule: DaySchedule,
    *,
    batt_soc: torch.Tensor | None = None,
    pv_shift: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    day: int = 0,
) -> tuple[EnvState, torch.Tensor]:
    """Start a new day on ``schedule`` (env.py:311-351).

    ``pv_shift (B,)`` pins the PV shift; otherwise it is drawn from
    ``generator``.  ``batt_soc (B,)`` carries the BESS across days (the
    reference never resets it); it defaults to ``params.batt_init_soc``.
    """
    B = schedule.occupancy.shape[0]
    p = broadcast_params(params, B)
    dtype, device = params.dtype, params.device
    if batt_soc is None:
        batt_soc = p.batt_init_soc.clone()
    batt_soc = batt_soc.to(dtype)
    if pv_shift is None:
        if generator is None:
            raise ValueError("reset needs pv_shift or a generator to draw it")
        pv_shift = draw_pv_shift(B, generator, dtype, device)
    pv_shift = pv_shift.to(dtype)

    state = EnvState(
        t=torch.zeros(B, dtype=torch.int64, device=device),
        soc=schedule.soc_init,
        schedule=schedule,
        batt_soc=batt_soc,
        batt_init_soc=batt_soc,
        pv_shift=pv_shift,
        # reset's observe computes the check set the first step consumes
        pmask=_penalty_mask_table(config, schedule)[..., 0],
        day=torch.full((B,), day, dtype=torch.int64, device=device),
    )
    return state, observe(config, params, state)


def step(
    config: NanogridConfig,
    params: NanogridParams,
    state: EnvState,
    action: torch.Tensor,
    *,
    next_pv_shift: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> StepResult:
    """One environment step for every env (SURVEY.md §3.3 call stack): with
    params on the CPU the plain twin :func:`step_plain`, on a CUDA device one
    launch of the kernel of ``csrc/engine_step.cu`` (``engine_step`` of
    ``ops/engine_step.py``, f32 or f64), bit for bit the same; another
    device raises ``ValueError``.

    Envs that finish their day take ``next_pv_shift (B,)`` as their new PV
    shift, or a value drawn from ``generator``.
    """
    # from core into ops at the call, once: ops imports core
    from ..ops import _build, engine_step as kernel

    if not _build.kernel_device(params.price):
        return step_plain(config, params, state, action, next_pv_shift=next_pv_shift, generator=generator)
    return kernel.engine_step(config, params, state, action, next_pv_shift, generator)


def step_plain(
    config: NanogridConfig,
    params: NanogridParams,
    state: EnvState,
    action: torch.Tensor,
    *,
    next_pv_shift: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> StepResult:
    """:func:`step` as eager element-wise ops on any device: the kernel's twin."""
    N, L, T = config.num_chargers, config.table_len, config.steps_per_day
    dt = config.time_interval
    B = state.t.shape[0]
    p = broadcast_params(params, B)
    dtype, device = params.dtype, params.device
    zero = torch.zeros((), dtype=dtype, device=device)
    t = state.t
    sched = state.schedule

    action = action.to(dtype)
    charger_actions = action[:, :N]
    battery_action = action[:, -1] if config.battery_system else torch.zeros(B, dtype=dtype, device=device)

    if config.battery_system:
        batt_init_soc = torch.where(t == 0, state.batt_soc, state.batt_init_soc)
    else:
        batt_init_soc = state.batt_init_soc

    # --- charging station (charging_station.py:281-300, charger.py:37-144) ---
    tm1 = (t - 1) % L
    occupied = _col(sched.occupancy, t) > 0
    is_arrival = _col(sched.is_arrival, t) > 0
    cap_eff = torch.where(is_arrival, _col(sched.capacity, t), _col(sched.capacity, tm1))
    soc_col_t = _col(state.soc, t)
    soc_eff = torch.where(is_arrival, soc_col_t, _col(state.soc, tm1))

    ch = physics.charger_step(
        charger_actions, occupied, soc_eff, cap_eff, p.charger_mask,
        p.charger_max_power[:, None], p.charger_efficiency[:, None],
        p.nonexistent_marker[:, None], dt,
    )
    new_soc_col = torch.where(occupied & (p.charger_mask > 0), ch.soc_new, soc_col_t)
    soc_hist = state.soc.scatter(2, t.view(-1, 1, 1).expand(-1, N, 1), new_soc_col[:, :, None])

    total_charging = physics.sum_rows(torch.where(ch.power > 0, ch.power, zero), -1)
    total_discharging = physics.sum_rows(torch.where(ch.power < 0, ch.power, zero), -1)

    # --- vehicle penalties (penaliser.py:31-87), lagged check set ---
    vehicle_penalty = physics.sum_rows(physics.vehicle_insufficiency_terms(
        state.pmask, _col(soc_hist, tm1), _col(sched.requested_soc, tm1),
        p.soc_margin_ratio[:, None], p.penalty_gain[:, None],
    ), -1)
    pmask_next = _col(_penalty_mask_table(config, sched), t)
    nonexistent_penalty = physics.sum_rows(ch.nonexistent, -1)

    # --- PV (pv_system_manager.py:87-91) ---
    if config.pv_system:
        solar_power = _at(p.solar_power, t) * state.pv_shift
    else:
        solar_power = torch.zeros(B, dtype=dtype, device=device)

    # --- energy balance & grid (central_management_system.py:105-106,157-185) ---
    remaining = (total_charging + total_discharging) - solar_power
    if config.battery_system:
        b = physics.battery_step(
            battery_action, remaining, state.batt_soc, p.batt_capacity,
            p.batt_max_power, p.batt_efficiency, dt,
        )
        grid_power = b.remaining_demand
        batt_soc = b.soc_new
        dod_penalty = physics.battery_dod_penalty(batt_soc, p.batt_dod, p.penalty_gain)
        batt_power_used, batt_power_calc = b.power_used, b.power_calculated
    else:
        grid_power = remaining
        batt_soc = state.batt_soc
        dod_penalty = torch.zeros(B, dtype=dtype, device=device)
        batt_power_used = torch.zeros(B, dtype=dtype, device=device)
        batt_power_calc = torch.zeros(B, dtype=dtype, device=device)

    grid_energy = grid_power * dt
    g_cost = physics.grid_energy_cost(grid_energy, _at(p.price, t), p.sell_coefficient)

    # --- totals (penaliser.py:177-187, accountant.py:34-36) ---
    total_penalty = p.w_battery_penalty * dod_penalty + p.w_vehicle_penalty * vehicle_penalty
    total_cost = p.grid_cost_weight * torch.abs(g_cost) + total_penalty
    reward = -total_cost

    # --- observation at the *old* t (env.py:173-174), then advance ---
    post_state = state._replace(soc=soc_hist, batt_soc=batt_soc, batt_init_soc=batt_init_soc)
    obs = observe(config, params, post_state)

    t_next = t + 1
    done = t_next == T
    if next_pv_shift is None:
        if generator is None:
            raise ValueError("step needs next_pv_shift or a generator for the day-end PV-shift redraw")
        next_pv_shift = draw_pv_shift(B, generator, dtype, device)
    next_state = post_state._replace(
        t=torch.where(done, torch.zeros_like(t_next), t_next),
        pv_shift=torch.where(done, next_pv_shift.to(dtype), state.pv_shift),
        pmask=pmask_next,
        day=state.day + done.to(torch.int64),
    )

    zeros = torch.zeros(B, dtype=dtype, device=device)
    info = StepInfo(
        total_cost=total_cost,
        grid_energy_cost=g_cost,
        grid_energy=grid_energy,
        grid_power=grid_power,
        utilized_solar_energy=solar_power,
        total_penalty=total_penalty,
        total_battery_penalty=dod_penalty,
        battery_soc_below_dod_penalty=dod_penalty,
        battery_overcharging_penalty=zeros,
        battery_over_discharging_penalty=zeros,
        low_resource_utilisation_penalty=zeros,
        total_vehicle_penalty=vehicle_penalty,
        insufficiently_charged_vehicles_penalty=vehicle_penalty,
        needlessly_charged_vehicles_penalty=zeros,
        overcharged_vehicles_penalty=zeros,
        over_discharged_vehicles_penalty=zeros,
        battery_action=battery_action,
        charger_actions=charger_actions,
        total_charging_power=total_charging,
        total_discharging_power=total_discharging,
        charger_power_values=ch.power,
        battery_power_value=batt_power_used,
        battery_calculated_power_value=batt_power_calc,
        battery_state_of_charge=batt_soc,
        initial_battery_state_of_charge=batt_init_soc,
        discharging_nonexistent_vehicles_penalty=nonexistent_penalty,
    )
    return StepResult(next_state, obs, reward, done, info)
