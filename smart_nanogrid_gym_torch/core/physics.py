"""Branch-free per-step physics (port of ``physics.py:36-161``).

Element-wise torch on broadcastable tensors, with the reference's quirks kept
exactly as the JAX package keeps them:

- charger discharge: the over-discharge flag ``ceil(0.5*(1+sign(calc)))``
  fires on every *normal* discharge and replaces the power by the full drain
  ``-(soc*cap/dt)`` (utils/charger.py:122-132), inverted against the BESS flag;
- BESS charge never clamps power when overcharging
  (battery_energy_storage_system.py:46-72).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def sum_rows(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Sum over ``dim`` in index order, the order the kernels use."""
    acc = x.select(dim, 0)
    for i in range(1, x.shape[dim]):
        acc = acc + x.select(dim, i)
    return acc


class ChargerStepResult(NamedTuple):
    power: torch.Tensor
    soc_new: torch.Tensor
    overcharging: torch.Tensor
    over_discharging: torch.Tensor
    nonexistent: torch.Tensor


def charger_step(
    actions: torch.Tensor,
    occupied: torch.Tensor,
    soc_eff: torch.Tensor,
    cap_eff: torch.Tensor,
    charger_mask: torch.Tensor,
    max_power: torch.Tensor,
    efficiency: torch.Tensor,
    nonexistent_marker: torch.Tensor,
    time_interval: float,
) -> ChargerStepResult:
    """Vectorised Charger.charge_or_discharge_vehicle (utils/charger.py:37-144)."""
    dt = time_interval
    zero = torch.zeros((), dtype=actions.dtype, device=actions.device)
    safe_cap = torch.where(cap_eff > 0, cap_eff, torch.ones_like(cap_eff))

    p_raw = actions * max_power * efficiency
    calc = soc_eff + (p_raw * dt) / safe_cap

    oc_flag = torch.floor(0.5 * (1.0 + torch.sign(calc - 1.0)))
    soc_charged = torch.clamp(calc, max=1.0)

    od_flag = torch.ceil(0.5 * (1.0 + torch.sign(calc)))
    p_discharge = torch.where(od_flag > 0, -(soc_eff * cap_eff) / dt, p_raw)
    soc_discharged = torch.clamp(calc, min=0.0)

    is_pos = actions > 0
    is_neg = actions < 0

    power = torch.where(is_pos, p_raw, torch.where(is_neg, p_discharge, zero))
    soc_new = torch.where(is_pos, soc_charged, torch.where(is_neg, soc_discharged, soc_eff))
    overcharging = torch.where(is_pos, oc_flag * max_power, zero)
    over_discharging = torch.where(is_neg, od_flag * max_power, zero)

    active = occupied & (charger_mask > 0)
    power = torch.where(active, power, zero)
    overcharging = torch.where(active, overcharging, zero)
    over_discharging = torch.where(active, over_discharging, zero)
    nonexistent = torch.where(
        ~occupied & (charger_mask > 0) & (actions != 0), nonexistent_marker, zero
    )
    return ChargerStepResult(power, soc_new, overcharging, over_discharging, nonexistent)


class BatteryStepResult(NamedTuple):
    soc_new: torch.Tensor
    power_used: torch.Tensor
    power_calculated: torch.Tensor
    overcharging: torch.Tensor
    over_discharging: torch.Tensor
    remaining_demand: torch.Tensor


def battery_step(
    action: torch.Tensor,
    demand: torch.Tensor,
    soc: torch.Tensor,
    capacity: torch.Tensor,
    max_power: torch.Tensor,
    efficiency: torch.Tensor,
    time_interval: float,
) -> BatteryStepResult:
    """Vectorised BatteryEnergyStorageSystem.charge_or_discharge
    (utils/battery_energy_storage_system.py:30-106)."""
    dt = time_interval
    zero = torch.zeros((), dtype=action.dtype, device=action.device)
    p_calc = action * max_power * efficiency
    calc = soc + (p_calc * dt) / capacity

    oc_flag = torch.floor(0.5 * (1.0 + torch.sign(calc - 1.0)))
    soc_charged = torch.clamp(calc, max=1.0)

    od_flag = 1.0 - torch.ceil(0.5 * (1.0 + torch.sign(calc)))
    p_discharge = torch.where(od_flag > 0, -(soc * capacity) / dt, p_calc)
    soc_discharged = torch.clamp(calc, min=0.0)

    is_pos = action > 0
    is_neg = action < 0
    is_zero = action == 0

    soc_new = torch.where(is_pos, soc_charged, torch.where(is_neg, soc_discharged, soc))
    power_used = torch.where(is_pos, p_calc, torch.where(is_neg, p_discharge, zero))
    power_calculated = torch.where(is_zero, zero, p_calc)
    overcharging = torch.where(is_pos, oc_flag * max_power, zero)
    over_discharging = torch.where(is_neg, od_flag * max_power, zero)
    remaining = demand + torch.where(is_zero, zero, power_used)
    return BatteryStepResult(soc_new, power_used, power_calculated, overcharging,
                             over_discharging, remaining)


def vehicle_insufficiency_terms(
    mask: torch.Tensor,
    soc: torch.Tensor,
    requested: torch.Tensor,
    margin_ratio: torch.Tensor,
    gain: torch.Tensor,
) -> torch.Tensor:
    """Each vehicle's term of Penaliser.penalise_state_of_charge_outside_margin
    (utils/penaliser.py:71-87): ((req - soc)·10)² outside a 5 % margin,
    where ``mask`` checks it."""
    lower = margin_ratio * requested
    insufficient = soc < requested - lower
    diff = (requested - soc) * gain
    pen = diff * diff
    return mask * torch.where(insufficient, pen, torch.zeros_like(pen))


def vehicle_insufficiency_penalty(
    mask: torch.Tensor,
    soc: torch.Tensor,
    requested: torch.Tensor,
    margin_ratio: torch.Tensor,
    gain: torch.Tensor,
) -> torch.Tensor:
    """:func:`vehicle_insufficiency_terms` summed over the last axis."""
    return torch.sum(vehicle_insufficiency_terms(mask, soc, requested, margin_ratio, gain), dim=-1)


def battery_dod_penalty(soc: torch.Tensor, dod: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    """Penaliser.penalise_battery_state_below_depth_of_discharge (penaliser.py:104-111)."""
    gap = (dod - soc) * gain
    return torch.where(soc < dod, gap * gap, torch.zeros_like(gap))


def grid_energy_cost(
    energy: torch.Tensor, price: torch.Tensor, sell_coefficient: torch.Tensor
) -> torch.Tensor:
    """Accountant.calculate_grid_energy_cost (utils/accountant.py:26-32): selling
    to the grid is priced at 0.8x."""
    return torch.where(energy < 0, energy * sell_coefficient * price, energy * price)
