"""One day of a nanogrid for many lanes at once, in plain torch.

A lane is one env on one day.  Each step generates the chargers' column of
the day's schedule from the step's draws (arrivals, SoC on arrival,
capacity, departure), forms the observation the controller sees (the
step-(t-1) observation: radiation and price now and three steps ahead, the
SoC and the departures of the chargers, the BESS SoC), applies the
controller's actions to the chargers and the BESS, and charges the grid
cost and the penalties (upstream ``utils/charging_station.py``,
``charger.py``, ``battery_system_manager.py``, ``penaliser.py``,
``accountant.py``, read at 1 h steps in the ``bounded`` charging mode).

Charger tensors are ``(L, N)``, scalars per lane ``(L,)``; everything runs
in the dtype of the draws handed in.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .tables import Tables

# charger.py:20-23; battery_system_manager.py; penaliser.py:7,79,177-181;
# accountant.py:6,35; charging_station.py:214,257-269; rbc.py:14
MAX_P, EFF = 22.0, 0.95
B_CAP, B_MAXP, B_EFF = 80.0, 44.0, 0.95
BATT_DOD, MARGIN, GAIN = 0.15, 0.05, 10.0
W_BATT, W_VEH, GRID_W, SELL = 0.8, 1.0, 0.75, 0.8
ARRIVAL, SOC_LOW, SOC_SPAN = 0.6, 0.1, 0.8
CAP_LOW, CAP_SPAN, DEFAULT_CAP = 15.0, 105.0, 40.0
BATT_INIT = 0.5
SOON = 0.16667
PENALTY_MODES = ("no_penalty", "on_departure", "sparse", "dense")


class StepView(NamedTuple):
    """What a controller may read at a step: the observation ``(L, F)``, the
    departure rows before their scaling ``(L, N)``, the trace offset of the
    observation and the PV shift ``(L,)``."""

    obs: torch.Tensor
    dep: torch.Tensor
    offset: int
    pv_shift: torch.Tensor


class Day(NamedTuple):
    day_return: torch.Tensor   # (L,)
    batt: torch.Tensor         # (L,) BESS SoC at the day's end
    rewards: torch.Tensor      # (T, L)


def pv_shift(u: torch.Tensor) -> torch.Tensor:
    """The day's PV shift, randint(0, 180) / 100, from a uniform."""
    return torch.floor(u * 181.0) / 100.0


def run_day(grid: dict, tab: Tables, u: torch.Tensor, shift: torch.Tensor, batt: torch.Tensor,
            controller: Callable[[StepView], torch.Tensor]) -> Day:
    """Run one day on every lane: ``u (T, 5, L, N)`` the step draws,
    ``shift (L,)`` the PV shift, ``batt (L,)`` the BESS SoC at the start;
    ``controller(view) -> actions (L, A)`` (chargers, then the BESS)."""
    dt = float(grid["time_interval_h"])
    T, _, L, N = u.shape
    pv, has_batt = bool(grid["pv"]), bool(grid["battery"])
    diff_caps = bool(grid["different_capacities"])
    if grid["requested_soc"]:
        raise ValueError("the reference covers grids without a requested SoC")
    mode = PENALTY_MODES.index(grid["penalty_mode"])
    k4, k10, k1 = int(4 / dt), int(10 / dt), int(1 / dt)
    dtype, device = u.dtype, u.device
    zero = torch.zeros((L, N), dtype=dtype, device=device)
    present, dep, cap, prev_col, prev_dep, pmask, prev_cap = (zero,) * 7
    tab = Tables(*(x.to(dtype) for x in tab))
    rewards = []
    for t in range(T):
        u_arr, u_soc, u_cap, _, u_dep = u[t]
        arrives = (present == 0) & (u_arr > ARRIVAL)
        soc_t = SOC_LOW + SOC_SPAN * u_soc
        low, high = t + k4, min(t + k10, T + k1)
        dep_new = (torch.full_like(u_dep, float(low)) if low >= high
                   else low + torch.floor(u_dep * float(high - low)))
        present_now = torch.maximum(present, arrives.to(dtype))
        dep = torch.where(arrives, dep_new, dep)
        occupied = (present_now > 0) & (float(t) < dep)
        occ = occupied.to(dtype)
        if diff_caps:
            cap = torch.where(arrives, CAP_LOW + torch.floor(u_cap * CAP_SPAN), cap)
            cap_col = torch.where(occupied, cap, zero)
        else:
            cap_col = occ * DEFAULT_CAP
        dep_col = torch.where(occupied, dep - float(t), zero)
        if mode == 0:
            mask_col = zero
        elif mode == 1:
            mask_col = (occupied & (dep == float(t + 1))).to(dtype)
        elif mode == 2:
            mask_col = (occupied & (dep <= float(t + 3))).to(dtype)
        else:
            mask_col = occ

        if t == 0:  # the reset's observation
            check, dep_obs, soc_obs = mask_col, dep_col, torch.where(arrives, soc_t, zero)
        else:
            check, dep_obs, soc_obs = pmask, prev_dep, prev_col
        o = max(t - 1, 0)
        rows = []
        if pv:
            rows += [tab.rad_norm[o] * shift, tab.price_norm[o].expand(L)]
            rows += [tab.rad_norm[o + i] * shift for i in range(1, 4)]
            rows += [tab.price_norm[o + i].expand(L) for i in range(1, 4)]
        else:
            rows += [tab.price_norm[o + i].expand(L) for i in range(4)]
        parts = [torch.stack(rows, dim=1), soc_obs, dep_obs / 24.0]
        if has_batt:
            parts.append(batt[:, None])
        actions = controller(StepView(torch.cat(parts, dim=1), dep_obs, o, shift))

        # chargers: both branches, with the upstream inverted discharge check
        ch = actions[:, :N]
        soc_eff = torch.where(arrives, soc_t, prev_col)
        p_raw = ch * (MAX_P * EFF)
        if diff_caps:
            cap_eff = torch.where(arrives, cap_col, prev_cap)
            calc = soc_eff + (p_raw * dt) / torch.where(cap_eff > 0, cap_eff, torch.ones_like(cap_eff))
        else:
            cap_eff = occ * DEFAULT_CAP
            calc = soc_eff + (p_raw * dt) / DEFAULT_CAP
        p_dis = torch.where(calc >= 0, -(soc_eff * cap_eff) / dt, p_raw)
        power = torch.where(ch > 0, p_raw, torch.where(ch < 0, p_dis, zero))
        power = torch.where(occupied, power, zero)
        soc_new = torch.where(ch > 0, torch.clamp(calc, max=1.0),
                              torch.where(ch < 0, torch.clamp(calc, min=0.0), soc_eff))
        new_col = torch.where(occupied, soc_new, zero)
        flows = torch.where(power > 0, power, zero).sum(1) + torch.where(power < 0, power, zero).sum(1)

        # vehicles checked at the previous step's trailing observe
        insufficient = prev_col < present - MARGIN * present
        gap = (present - prev_col) * GAIN
        pen = torch.where((check > 0) & insufficient, gap * gap, zero).sum(1)

        grid_power = flows - tab.solar[t] * shift if pv else flows
        dod = torch.zeros_like(flows)
        if has_batt:
            ba = actions[:, N]
            p_calc = ba * (B_MAXP * B_EFF)
            b_calc = batt + (p_calc * dt) / B_CAP
            p_b_dis = torch.where(b_calc < 0, -(batt * B_CAP) / dt, p_calc)
            batt = torch.where(ba > 0, torch.clamp(b_calc, max=1.0),
                               torch.where(ba < 0, torch.clamp(b_calc, min=0.0), batt))
            p_used = torch.where(ba > 0, p_calc, torch.where(ba < 0, p_b_dis, torch.zeros_like(ba)))
            grid_power = grid_power + p_used
            low_gap = (BATT_DOD - batt) * GAIN
            dod = torch.where(batt < BATT_DOD, low_gap * low_gap, torch.zeros_like(batt))
        energy = grid_power * dt
        cost = torch.where(energy < 0, energy * (SELL * tab.price[t]), energy * tab.price[t])
        rewards.append(-(GRID_W * torch.abs(cost) + W_BATT * dod + W_VEH * pen))

        present, prev_col, prev_dep, pmask, prev_cap = occ, new_col, dep_col, mask_col, cap_col
    rewards = torch.stack(rewards)
    return Day(rewards.to(torch.float64).sum(0), batt, rewards)


def rbc(grid: dict, tab: Tables, dtype) -> Callable[[StepView], torch.Tensor]:
    """The upstream rule-based controller (``solvers/RBC/rbc.py:6-29``): a
    charger whose car leaves within a sixth of a day charges fully, an empty
    one idles, any other charges at the mean of the PV now and next; the
    BESS idles."""
    rad = tab.rad_norm.to(dtype)
    pv = bool(grid["pv"])

    def controller(view: StepView) -> torch.Tensor:
        dep, o = view.dep, view.offset
        zero, one = torch.zeros_like(dep), torch.ones_like(dep)
        if pv:
            fallback = ((rad[o] * view.pv_shift + rad[o + 1] * view.pv_shift) * 0.5)[:, None].expand_as(dep)
        else:
            fallback = zero
        act = torch.where(dep == 0, zero, torch.where(dep < 24.0 * SOON, one, fallback))
        if grid["battery"]:
            act = torch.cat([act, torch.zeros_like(act[:, :1])], dim=1)
        return act

    return controller


def mlp(leaves, x: torch.Tensor) -> torch.Tensor:
    """A tanh torso ``(W1, b1, W2, b2, W3, b3)`` on ``x (L, F)``."""
    w1, b1, w2, b2, w3, b3 = leaves
    lin = torch.nn.functional.linear
    return lin(torch.tanh(lin(torch.tanh(lin(x, w1, b1)), w2, b2)), w3, b3)


def actor_mean(pi, low: torch.Tensor, high: torch.Tensor) -> Callable[[StepView], torch.Tensor]:
    """The deterministic PPO actor: the ``pi`` torso's mean clipped to the box."""

    def controller(view: StepView) -> torch.Tensor:
        return torch.clamp(mlp(pi, view.obs.to(pi[0].dtype)).to(view.obs.dtype), low, high)

    return controller
