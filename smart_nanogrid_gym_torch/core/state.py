"""Environment state containers (port of ``smart_nanogrid_gym_tpu/core/state.py``).

Every leaf carries a leading env axis ``B``: the port writes the batch
dimension out where the JAX package vmaps.  ``N`` = num_chargers, ``L`` =
table_len = steps_per_day + 1 (the trailing always-zero column that the
``(t-1) mod L`` reads hit at t=0).  The JAX ``EnvState.key`` has no
counterpart: the day-end PV-shift redraw takes an explicit
``torch.Generator`` (or the drawn values) instead.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class DaySchedule(NamedTuple):
    """Precomputed day tables, each ``(B, N, L)``."""

    occupancy: torch.Tensor
    capacity: torch.Tensor
    requested_soc: torch.Tensor
    soc_init: torch.Tensor
    is_arrival: torch.Tensor
    dep_obs: torch.Tensor
    mask_departing: torch.Tensor
    mask_departing3: torch.Tensor


class EnvState(NamedTuple):
    """Mutable per-step carry."""

    t: torch.Tensor              # (B,) int64 timestep within the day
    soc: torch.Tensor            # (B, N, L) running SoC history
    schedule: DaySchedule
    batt_soc: torch.Tensor       # (B,)
    batt_init_soc: torch.Tensor  # (B,)
    pv_shift: torch.Tensor       # (B,)
    pmask: torch.Tensor          # (B, N) penalty-check mask of the trailing observe
    day: torch.Tensor            # (B,) int64 day counter


class StepInfo(NamedTuple):
    """Per-step telemetry (the reference CMS results dict); ``(B,)`` leaves
    except ``charger_actions`` and ``charger_power_values`` ``(B, N)``."""

    total_cost: torch.Tensor
    grid_energy_cost: torch.Tensor
    grid_energy: torch.Tensor
    grid_power: torch.Tensor
    utilized_solar_energy: torch.Tensor
    total_penalty: torch.Tensor
    total_battery_penalty: torch.Tensor
    battery_soc_below_dod_penalty: torch.Tensor
    battery_overcharging_penalty: torch.Tensor
    battery_over_discharging_penalty: torch.Tensor
    low_resource_utilisation_penalty: torch.Tensor
    total_vehicle_penalty: torch.Tensor
    insufficiently_charged_vehicles_penalty: torch.Tensor
    needlessly_charged_vehicles_penalty: torch.Tensor
    overcharged_vehicles_penalty: torch.Tensor
    over_discharged_vehicles_penalty: torch.Tensor
    battery_action: torch.Tensor
    charger_actions: torch.Tensor
    total_charging_power: torch.Tensor
    total_discharging_power: torch.Tensor
    charger_power_values: torch.Tensor
    battery_power_value: torch.Tensor
    battery_calculated_power_value: torch.Tensor
    battery_state_of_charge: torch.Tensor
    initial_battery_state_of_charge: torch.Tensor
    discharging_nonexistent_vehicles_penalty: torch.Tensor


class StepResult(NamedTuple):
    """What one environment step returns for every env."""

    state: EnvState
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    info: StepInfo
