"""Fused day generation + RBC closed loop: kernels K7 and K8 with their twins.

Replaces ``smart_nanogrid_gym_tpu/ops/pallas_gen_rollout.py``:

- :func:`gen_rbc_day` (K7, ``pallas_gen_rbc_day``): generates one day per env
  from an explicit uniform block ``u (T, 5, N, B)`` (the
  ``generate_schedule(uniforms=...)`` contract), rolls the RBC over it with
  the non-v2x physics and returns ``rewards (T, B)`` and ``soc_final (N, B)``;
- :func:`gen_rbc_multiday` (K8, ``pallas_gen_rbc_multiday``): ``num_days``
  fresh days per env in one launch with in-kernel Philox draws
  (:mod:`.philox`), returning ``stats (2, B)``: Σ day return and Σ (day return)².

On CUDA tensors the wrappers launch the hand-written kernels of
``csrc/day_step.cuh`` (K7: 32 envs a block on one warp a charger, each
thread copying its chargers' uniforms a few steps ahead into a ring in
shared memory, K11a's block, its size checked by :func:`check_rbc_ring`;
K8: below 32,768 envs an env on 4-32 lanes of a warp, a lane a charger,
the Philox draws of each group of 4 chargers split over its 4 lanes, and
one thread an env from there); on CPU tensors they run the plain twins
below.  The twins mirror the Pallas step
body's f32 arithmetic op for op, in the same order (sums over chargers and
over the day run sequentially), and the kernels mirror the twins.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.config import NanogridConfig, PenaltyMode
from ..core.params import NanogridParams
from ..core.physics import sum_rows
from ..utils.profiling import spanned
from . import _build
from ._build import MAX_SHARED_BYTES, kernel_device
from .param_guard import (ARRIVAL_THRESHOLD, BATT_DOD, BATT_INIT_SOC, CAP_LOW, CAP_SPAN, DEFAULT_CAP,
                          DEPARTURE_SOON_THRESHOLD, EFF, GAIN, GRID_W, MARGIN, MAX_P, SELL, SOC_LOW, SOC_SPAN, W_BATT,
                          W_VEH, check_baked_params)
from .philox import day_uniforms

F32 = torch.float32


class Traces(NamedTuple):
    """Per-timestep tables the kernels read, f32 on the kernel's device."""

    price: torch.Tensor       # (P,)
    price_norm: torch.Tensor  # (P,)
    rad_norm: torch.Tensor    # (S,)
    solar: torch.Tensor       # (S,)


def kernel_traces(params: NanogridParams, device: torch.device) -> Traces:
    """The traces of ``params`` (env 0's when batched) as f32 on ``device``."""

    def trace(x):
        return (x[0] if x.dim() == 2 else x).to(device=device, dtype=F32).contiguous()

    return Traces(trace(params.price), trace(params.price_norm),
                  trace(params.rad_norm), trace(params.solar_power))


def step_kwargs(config: NanogridConfig) -> dict:
    return dict(
        dt=config.time_interval,
        pv=config.pv_system,
        penalty_mode=int(config.penalty_mode),
        diff_caps=config.different_battery_capacities,
        req_soc=config.requested_state_of_charge,
        k4=int(4 / config.time_interval),
        k10=int(10 / config.time_interval),
        k1=int(1 / config.time_interval),
    )


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as a true division: on CUDA, torch turns a division by a
    Python scalar into a multiplication by its reciprocal, which the kernels
    (and the Pallas bodies) do not do."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def fresh_carry(N: int, B: int, device, diff_caps: bool, req_soc: bool) -> dict:
    """Day-start recurrence state: all-zero generation and rollout carries,
    each ``(N, B)`` (pallas_gen_rollout.py:65-103)."""
    zero = torch.zeros((N, B), dtype=F32, device=device)
    carry = dict(present=zero, dep=zero, prev_col=zero, prev_depcol=zero, pmask=zero)
    if diff_caps:
        carry.update(cap=zero, prev_capcol=zero)
    if req_soc:
        carry.update(req=zero, prev_reqcol=zero)
    return carry


def generate_column(t, u5, c, *, T, penalty_mode, diff_caps, req_soc, k4, k10, k1):
    """Schedule columns at step t and the generation-carry updates
    (``_generate_column``, pallas_gen_rollout.py:106-197).  ``u5``: the five
    ``(N, B)`` draws of step t."""
    u_arr, u_soc, u_cap, u_req, u_dep = u5
    zero = torch.zeros((), dtype=F32, device=u_arr.device)

    arrives = (c["present"] == 0.0) & (u_arr > ARRIVAL_THRESHOLD)
    soc_t = SOC_LOW + SOC_SPAN * u_soc

    low_t = t + k4
    high_t = min(t + k10, T + k1)
    if low_t >= high_t:  # no-draw branch (charging_station.py:271-279)
        dep_new = torch.full_like(u_dep, float(low_t))
    else:
        dep_new = low_t + torch.floor(u_dep * float(high_t - low_t))

    present = torch.maximum(c["present"], arrives.to(F32))
    dep = torch.where(arrives, dep_new, c["dep"])
    occupied = (present > 0.0) & (float(t) < dep)
    occ_f = occupied.to(F32)

    gen = {"present": occ_f, "dep": dep}
    if diff_caps:
        cap_new = CAP_LOW + torch.floor(u_cap * CAP_SPAN)
        cap = torch.where(arrives, cap_new, c["cap"])
        cap_col = torch.where(occupied, cap, zero)
        gen["cap"] = cap
    else:
        cap_col = occ_f * DEFAULT_CAP
    if req_soc:
        soc_prime = torch.clamp(soc_t + 0.1, max=1.0)
        req_new = soc_prime + (1.0 - soc_prime) * u_req
        req = torch.where(arrives, req_new, c["req"])
        req_col = torch.where(occupied, req, zero)
        gen["req"] = req
    else:
        req_col = occ_f

    dep_col = torch.where(occupied, dep - float(t), zero)
    if penalty_mode == PenaltyMode.NO_PENALTY:
        mask_col = torch.zeros_like(occ_f)
    elif penalty_mode == PenaltyMode.ON_DEPARTURE:
        mask_col = (occupied & (dep == float(t + 1))).to(F32)
    elif penalty_mode == PenaltyMode.SPARSE:
        mask_col = (occupied & (dep <= float(t + 3))).to(F32)
    else:  # DENSE
        mask_col = occ_f

    cols = dict(arrives=arrives, occupied=occupied, occ_f=occ_f, cap_col=cap_col,
                req_col=req_col, soc_t=soc_t, dep_col=dep_col, mask_col=mask_col)
    return cols, gen


def insufficiency_penalty(pmask, prev_col, req_p):
    """Per-charger insufficiency penalty ``(N, B)``: the previous SoC column
    against the requested SoC at (t-1) mod L, where the trailing-observe mask
    is set."""
    insufficient = prev_col < req_p - MARGIN * req_p
    gap = (req_p - prev_col) * GAIN
    return torch.where((pmask > 0) & insufficient, gap * gap, torch.zeros_like(gap))


def vehicle_penalty(c, pmask, req_soc):
    """Per-charger insufficiency penalty ``(N, B)`` from the previous step's
    carry (trailing-observe mask, (t-1) mod L reads)."""
    return insufficiency_penalty(pmask, c["prev_col"], c["prev_reqcol"] if req_soc else c["present"])


def next_carry(gen, cols, new_col, diff_caps, req_soc):
    carry = {**gen, "prev_col": new_col, "prev_depcol": cols["dep_col"],
             "pmask": cols["mask_col"]}
    if diff_caps:
        carry["prev_capcol"] = cols["cap_col"]
    if req_soc:
        carry["prev_reqcol"] = cols["req_col"]
    return carry


def rbc_actions(dep_o, rad_norm, o, pv_shift, pv):
    """The RBC's charger actions ``(N, B)`` for the departure rows ``dep_o``
    of the observation at trace offset ``o``."""
    zero = torch.zeros((), dtype=F32, device=pv_shift.device)
    one = torch.ones((), dtype=F32, device=pv_shift.device)
    if pv:
        fallback = (rad_norm[o] * pv_shift + rad_norm[o + 1] * pv_shift) * 0.5
    else:
        fallback = torch.zeros_like(pv_shift)
    soon = dep_o < (24.0 * DEPARTURE_SOON_THRESHOLD)
    return torch.where(dep_o == 0.0, zero, torch.where(soon, one, fallback))


def gen_rbc_step(t, u5, c, rad_norm, pv_shift, *, T, dt, pv, penalty_mode,
                 diff_caps, req_soc, k4, k10, k1):
    """One step: generate column t, run the RBC on the step-(t-1) observation,
    apply the charge-only charger physics (``_gen_rbc_step``,
    pallas_gen_rollout.py:200-301).  Returns ``(charging (B,), pen (N, B),
    carry)``."""
    cols, gen = generate_column(t, u5, c, T=T, penalty_mode=penalty_mode, diff_caps=diff_caps,
                                req_soc=req_soc, k4=k4, k10=k10, k1=k1)
    arrives, occupied = cols["arrives"], cols["occupied"]
    zero = torch.zeros((), dtype=F32, device=pv_shift.device)

    if t == 0:  # reset's trailing observe computes the step-0 check set
        pmask, dep_o = cols["mask_col"], cols["dep_col"]
    else:
        pmask, dep_o = c["pmask"], c["prev_depcol"]

    actions = rbc_actions(dep_o, rad_norm, max(t - 1, 0), pv_shift, pv)
    one = torch.ones((), dtype=F32, device=pv_shift.device)

    soc_eff = torch.where(arrives, cols["soc_t"], c["prev_col"])
    p_raw = actions * (MAX_P * EFF)
    if diff_caps:
        cap_eff = torch.where(arrives, cols["cap_col"], c["prev_capcol"])
        safe_cap = torch.where(cap_eff > 0, cap_eff, one)
        calc = soc_eff + (p_raw * dt) / safe_cap
    else:
        calc = soc_eff + div(p_raw * dt, DEFAULT_CAP)
    power = torch.where(occupied & (actions > 0), p_raw, zero)
    soc_new = torch.where(actions > 0, torch.clamp(calc, max=1.0), soc_eff)
    new_col = torch.where(occupied, soc_new, zero)

    pen = vehicle_penalty(c, pmask, req_soc)
    return sum_rows(power), pen, next_carry(gen, cols, new_col, diff_caps, req_soc)


def idle_battery_dod_penalty(batt: bool, batt_soc: torch.Tensor) -> torch.Tensor:
    """The BESS idles under the RBC, so its DoD penalty is constant all day."""
    if not batt:
        return torch.zeros_like(batt_soc)
    gap = (BATT_DOD - batt_soc) * GAIN
    return torch.where(batt_soc < BATT_DOD, gap * gap, torch.zeros_like(gap))


def rbc_day_rewards(charging, veh_pen, price_col, solar_col, pv_shift, dod_pen, *, dt, pv):
    """Grid energy, cost and reward of every step (``_day_rewards``,
    pallas_gen_rollout.py:304-327).  ``charging``/``veh_pen``: ``(T, B)``;
    ``price_col``/``solar_col``: ``(T, 1)``.  ``veh_pen=None`` leaves the
    penalty out (the multiday kernel subtracts its day total instead)."""
    grid_power = charging - solar_col * pv_shift if pv else charging
    grid_energy = grid_power * dt
    g_cost = torch.where(grid_energy < 0, grid_energy * (SELL * price_col), grid_energy * price_col)
    total_cost = GRID_W * torch.abs(g_cost) + W_BATT * dod_pen
    if veh_pen is not None:
        total_cost = total_cost + W_VEH * veh_pen
    return -total_cost


def pv_shift_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """randint(0, 180)/100 from a uniform: floor(u·181)/100."""
    return div(torch.floor(u * 181.0), 100.0)


def _require_rbc_config(config: NanogridConfig) -> None:
    if config.vehicle_to_everything:
        raise ValueError("the RBC kernels cover non-v2x configs")


def check_rbc_ring(config: NanogridConfig, traces: Traces, floats: int, kernel: str) -> None:
    """Raise before the launch when the shared memory of ``kernel``'s RBC
    ring block, ``floats`` before the traces (the library's number: K11a's
    ``ngk_rbc_ring_floats``, its ring of one-step stages of the table rows,
    or K7's ``ngk_gen_rbc_ring_floats``, of the uniform rows; and the
    per-charger sums), and its traces exceed a block's."""
    need = 4 * (floats + traces.rad_norm.numel() + 2 * config.steps_per_day)
    if need > MAX_SHARED_BYTES:
        raise ValueError(f"{config.num_chargers} chargers at {config.steps_per_day} steps a day need {need} bytes "
                         f"of shared memory per block in {kernel}, more than {MAX_SHARED_BYTES}; "
                         f"roll the day with the plain engine")


# --------------------------------------------------------------------- K7 ---

def gen_rbc_day_plain(config, traces: Traces, uniforms, pv_shift, batt_soc):
    """Plain twin of K7 on f32 tensors: ``(rewards (T, B), soc_final (N, B))``."""
    T, N = config.steps_per_day, config.num_chargers
    kw = step_kwargs(config)
    B = pv_shift.shape[0]
    dod_pen = idle_battery_dod_penalty(config.battery_system, batt_soc)
    carry = fresh_carry(N, B, pv_shift.device, kw["diff_caps"], kw["req_soc"])
    charging, pens = [], []
    for t in range(T):
        ch, pen, carry = gen_rbc_step(t, uniforms[t].unbind(0), carry, traces.rad_norm,
                                      pv_shift, T=T, **kw)
        charging.append(ch)
        pens.append(sum_rows(pen))
    rewards = rbc_day_rewards(
        torch.stack(charging), torch.stack(pens), traces.price[:T, None],
        traces.solar[:T, None], pv_shift, dod_pen, dt=kw["dt"], pv=kw["pv"])
    return rewards, carry["prev_col"]


def gen_rbc_day(config: NanogridConfig, params: NanogridParams, uniforms: torch.Tensor,
                pv_shift: torch.Tensor, batt_soc: torch.Tensor | None = None):
    """Generate a fresh day per env and roll the RBC over it (K7).

    ``uniforms (T, 5, N, B)``, ``pv_shift (B,)``, ``batt_soc (B,)`` (the
    reference's 0.5 when omitted).  Returns ``(rewards (T, B), soc_final (N, B))``.
    Any batch size works.
    """
    _require_rbc_config(config)
    check_baked_params(config, params, "gen_rbc_day", generation=True)
    T, N = config.steps_per_day, config.num_chargers
    B = pv_shift.shape[0]
    if tuple(uniforms.shape) != (T, 5, N, B):
        raise ValueError(f"uniforms must be ({T}, 5, {N}, {B}), got {tuple(uniforms.shape)}")
    if batt_soc is None:
        init = params.batt_init_soc.reshape(-1)[0]
        batt_soc = init.to(device=pv_shift.device, dtype=F32).expand(B)
    traces = kernel_traces(params, uniforms.device)
    if not kernel_device(uniforms):
        return gen_rbc_day_plain(config, traces, uniforms.to(F32), pv_shift.to(F32),
                                 batt_soc.to(F32))

    u = _build.check_f32(uniforms, "uniforms")
    pv = _build.check_f32(pv_shift, "pv_shift")
    batt = _build.check_f32(batt_soc.contiguous(), "batt_soc")
    rewards = torch.empty((T, B), dtype=F32, device=u.device)
    soc_final = torch.empty((N, B), dtype=F32, device=u.device)
    lib = _build.load(_build.config_spec(config), u.device)
    check_rbc_ring(config, traces, lib.ngk_gen_rbc_ring_floats(), "gen_rbc_day")
    _build.launch(
        "gen_rbc_day", lib.ngk_gen_rbc_day,
        traces.price, traces.rad_norm, traces.rad_norm.numel(), traces.solar,
        u, batt, pv, rewards, soc_final, B, *_build.day_dims(config), device=u.device,
    )
    return rewards, soc_final


# --------------------------------------------------------------------- K8 ---

def gen_rbc_multiday_plain(config, traces: Traces, num_days: int, seed: int, batch: int):
    """Plain twin of K8: ``stats (2, batch)``, same Philox draws as the kernel."""
    T, N = config.steps_per_day, config.num_chargers
    kw = step_kwargs(config)
    device = traces.price.device
    batt_soc = torch.full((batch,), BATT_INIT_SOC, dtype=F32, device=device)
    dod_pen = idle_battery_dod_penalty(config.battery_system, batt_soc)
    rew_total = torch.zeros(batch, dtype=F32, device=device)
    sq_total = torch.zeros(batch, dtype=F32, device=device)
    for day in range(num_days):
        u, u_pv = day_uniforms(seed, day, batch, T, N, device)
        pv_shift = pv_shift_from_uniform(u_pv)
        carry = fresh_carry(N, batch, device, kw["diff_caps"], kw["req_soc"])
        pen_acc = torch.zeros((N, batch), dtype=F32, device=device)
        charging = []
        for t in range(T):
            ch, pen, carry = gen_rbc_step(t, u[t].unbind(0), carry, traces.rad_norm,
                                          pv_shift, T=T, **kw)
            charging.append(ch)
            pen_acc = pen_acc + pen
        rewards = rbc_day_rewards(
            torch.stack(charging), None, traces.price[:T, None], traces.solar[:T, None],
            pv_shift, dod_pen, dt=kw["dt"], pv=kw["pv"])
        day_return = sum_rows(rewards) - W_VEH * sum_rows(pen_acc)
        rew_total = rew_total + day_return
        sq_total = sq_total + day_return * day_return
    return torch.stack([rew_total, sq_total])


@spanned("rbc_days")
def gen_rbc_multiday(config: NanogridConfig, params: NanogridParams, num_days: int,
                     seed: int, batch: int):
    """``num_days`` fresh RBC days × ``batch`` envs in one launch (K8).

    Runs on the device of ``params``.  Returns ``stats (2, batch)``: row 0 the
    sum of day returns per env, row 1 the sum of squared day returns.
    """
    _require_rbc_config(config)
    check_baked_params(config, params, "gen_rbc_multiday", generation=True, battery_init=True)
    device = params.device
    traces = kernel_traces(params, device)
    if not kernel_device(params.price):
        return gen_rbc_multiday_plain(config, traces, num_days, seed, batch)

    stats = torch.empty((2, batch), dtype=F32, device=device)
    lib = _build.load(_build.config_spec(config), device)
    _build.launch(
        "gen_rbc_multiday", lib.ngk_gen_rbc_multiday,
        traces.price, traces.rad_norm, traces.rad_norm.numel(), traces.solar,
        seed & 0xFFFFFFFF, num_days, stats, batch, *_build.day_dims(config), device=device,
    )
    return stats
