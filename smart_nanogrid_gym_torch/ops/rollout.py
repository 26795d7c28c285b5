"""One RBC day of a given state, tables in: kernel K11a with its twin.

Replaces ``smart_nanogrid_gym_tpu/ops/pallas_rollout.py::pallas_rbc_day_rollout``.
Where K7 generates a fresh day inside the kernel, :func:`rbc_day_rollout`
rolls the day a caller holds in an :class:`EnvState` (from a reset, from a
JSON replay, or a day continued after a rollover): the wrapper builds the
state's seven day tables with :func:`state_tables` (``build_day_tables`` plus
one time-major copy, torch operations before the launch), and the kernel of
``csrc/day_step.cuh`` (``rbc_day_rollout_kernel``) reads them: a block takes
32 envs on one warp a charger, and each thread streams its charger's rows
of the seven tables a few steps ahead into a ring in shared memory, K7's
block and ring with table rows in place of the uniforms
(:func:`check_rbc_ring` checks its size before the launch).  The RBC acts
on the previous step's observation, only the charge branch exists (non-v2x
configs) and the battery idles, so its DoD penalty is a per-env constant.

On CUDA tensors the wrapper launches the kernel; on CPU tensors it runs the
plain twin :func:`rbc_day_rollout_plain`, which sums in the kernel's order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.config import NanogridConfig
from ..core.params import NanogridParams
from ..core.rollout import build_day_tables
from ..core.state import EnvState
from . import _build
from ._build import kernel_device
from .gen_rollout import (
    F32,
    Traces,
    _require_rbc_config,
    check_rbc_ring,
    idle_battery_dod_penalty,
    insufficiency_penalty,
    kernel_traces,
    rbc_actions,
    rbc_day_rewards,
    sum_rows,
)
from .param_guard import EFF, MAX_P, check_baked_params

# the packed tables, in the order csrc/day_step.cuh's TableKind reads them
TABLE_FIELDS = ("occupancy", "capacity_eff", "requested_prev", "soc_cols", "is_arrival", "dep_obs",
                "penalty_mask")


class StateTables(NamedTuple):
    """What the tables-in kernels read of a state, env axis last."""

    tables: torch.Tensor    # (7, T, N, B), TABLE_FIELDS
    prev_col: torch.Tensor  # (N, B) the SoC column L-1 (read at t=0 as (t-1) mod L)
    pmask: torch.Tensor     # (N, B) the trailing-observe penalty mask
    batt_soc: torch.Tensor  # (B,)
    pv_shift: torch.Tensor  # (B,)

    def to(self, dtype: torch.dtype) -> StateTables:
        return StateTables(*(x.to(dtype) for x in self))

    def checked(self) -> StateTables:
        """The operands as the kernels take them: contiguous f32 on the card."""
        return StateTables(*(_build.check_f32(x, name) for x, name in zip(self, self._fields)))


def one_row(params: NanogridParams) -> NanogridParams:
    """Unbatched ``params``, or row 0 of batched ones whose rows all equal it.

    The tables-in kernels take one set of traces and constants.  JAX's
    callers pass params broadcast over the batch (bench.py:380-381), and
    JAX's kernels read env 0's row whatever the others hold
    (pallas_rollout.py:167-170); here rows that differ raise ``ValueError``.
    """
    if not params.batched:
        return params
    row = NanogridParams(*(x[0] for x in params))
    same = torch.stack([(x == r).all() for x, r in zip(params, row)]).cpu()  # one device sync
    if not bool(same.all()):
        names = [n for n, ok in zip(params._fields, same.tolist()) if not ok]
        raise ValueError(f"the tables-in kernels take one set of params; {', '.join(names)} differ across envs")
    return row


def state_tables(config: NanogridConfig, params: NanogridParams, state: EnvState) -> StateTables:
    """The day tables of ``state`` in the kernels' ``(T, N, B)`` layout.

    Raises unless every env is at day start (``state.t == 0``): the tables
    cover columns 0..T-1 of the day.  ``params`` are unbatched, or batched
    with every row equal (:func:`one_row`).
    """
    params = one_row(params)
    if not bool((state.t == 0).all()):
        raise ValueError("the tables-in kernels roll a day from its start: every env needs state.t == 0")
    day = build_day_tables(config, params, state)
    tables = torch.stack([getattr(day, name).permute(0, 2, 1) for name in TABLE_FIELDS])
    return StateTables(tables, state.soc[..., config.table_len - 1].T.contiguous(),
                       state.pmask.T.contiguous(), state.batt_soc.contiguous(), state.pv_shift.contiguous())


def rbc_day_rollout_plain(config: NanogridConfig, traces: Traces, st: StateTables):
    """Plain twin of K11a on f32 tables: ``(rewards (T, B), soc_final (N, B))``."""
    T, dt, pv = config.steps_per_day, config.time_interval, config.pv_system
    occ, cap, req, soc_cols, isarr, dep, pmask_tab = st.tables.unbind(0)
    prev_col, pmask, pv_shift = st.prev_col, st.pmask, st.pv_shift
    zero = torch.zeros((), dtype=F32, device=pv_shift.device)
    one = torch.ones((), dtype=F32, device=pv_shift.device)
    dod_pen = idle_battery_dod_penalty(config.battery_system, st.batt_soc)
    charging, pens = [], []
    for t in range(T):
        actions = rbc_actions(dep[max(t - 1, 0)], traces.rad_norm, max(t - 1, 0), pv_shift, pv)
        occupied = occ[t] > 0
        soc_eff = torch.where(isarr[t] > 0, soc_cols[t], prev_col)
        p_raw = actions * (MAX_P * EFF)
        calc = soc_eff + (p_raw * dt) / torch.where(cap[t] > 0, cap[t], one)
        power = torch.where(occupied & (actions > 0), p_raw, zero)
        soc_new = torch.where(actions > 0, torch.clamp(calc, max=1.0), soc_eff)
        pens.append(sum_rows(insufficiency_penalty(pmask, prev_col, req[t])))
        charging.append(sum_rows(power))
        pmask = pmask_tab[t]  # the trailing observe's mask for the next step
        prev_col = torch.where(occupied, soc_new, soc_cols[t])
    rewards = rbc_day_rewards(torch.stack(charging), torch.stack(pens), traces.price[:T, None],
                              traces.solar[:T, None], pv_shift, dod_pen, dt=dt, pv=pv)
    return rewards, prev_col


def launch_rbc_day(config: NanogridConfig, traces: Traces, st: StateTables):
    """Launch K11a on tables already on the card; ``(rewards (T, B), soc_final (N, B))``."""
    T, N = config.steps_per_day, config.num_chargers
    st = st.checked()
    device, B = st.tables.device, st.pv_shift.shape[0]
    lib = _build.load(_build.config_spec(config), device)
    check_rbc_ring(config, traces, lib.ngk_rbc_ring_floats(), "rbc_day_rollout")
    rewards = torch.empty((T, B), dtype=F32, device=device)
    soc_final = torch.empty((N, B), dtype=F32, device=device)
    _build.launch(
        "rbc_day_rollout", lib.ngk_rbc_day_rollout,
        traces.price, traces.rad_norm, traces.rad_norm.numel(), traces.solar, *st,
        rewards, soc_final, B, T, config.time_interval, device=device,
    )
    return rewards, soc_final


def rbc_day_rollout(config: NanogridConfig, params: NanogridParams, state: EnvState):
    """Roll one RBC day of the batched ``state`` (K11a).

    ``state`` is at day start for every env (a reset state, or one rolled
    over from the previous day); ``params`` are unbatched, or batched with
    equal rows as JAX's callers pass them (:func:`one_row`).  Returns
    ``(rewards (T, B), soc_final (N, B))``; any batch size works.
    """
    _require_rbc_config(config)
    check_baked_params(config, params, "rbc_day_rollout")
    traces = kernel_traces(params, state.soc.device)
    st = state_tables(config, params, state)
    if not kernel_device(state.soc):
        return rbc_day_rollout_plain(config, traces, st.to(F32))
    return launch_rbc_day(config, traces, st)
