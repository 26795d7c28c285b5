"""The plain engine's step in one launch: the kernel of ``csrc/engine_step.cu``.

:func:`engine_step` computes ``core/transition.py::step`` for every env of a
batch, bit-equal to the plain twin ``core/transition.py::step_plain`` in f32
and f64.  It replaces no Pallas kernel: XLA fuses the JAX package's step,
which the eager twin runs as about 175 launches a step at 8 chargers.
``transition.step`` calls it for params on a CUDA device and the twin for
params on the CPU.

A thread carries one env through the step, its chargers in registers.  Every
operand is read through its strides (an unbatched param with stride 0, the
reset's penalty mask a strided view of its table), so nothing is copied or
viewed before the launch.  Where the step draws the day-end PV shift, the
draw is the twin's one ``torch.randint`` a step, so the generator's stream
is the twin's; the kernel converts and scales it.  The results are views of
five buffers (the new SoC history; one float buffer of the ``(B,)`` rows,
the charger powers and the next penalty mask; the observation; the next t
and day; the dones), and the leaves that alias in the twin alias here.
"""

from __future__ import annotations

import array
import ctypes

import torch

from ..core.config import NanogridConfig
from ..core.params import NanogridParams
from ..core.generate import draw_pv_percent
from ..core.state import EnvState, StepInfo, StepResult
from . import _build

LAUNCH_NAME = "engine_step"
DTYPES = (torch.float32, torch.float64)
# the kernel's operands in order (csrc/engine_step.cu StepInput): the params
# the step reads, with the column each has beyond the env axis ("trace": any
# length, "charger": one value a charger, None: none), then the state
PARAMS = {"price": "trace", "price_norm": "trace", "rad_norm": "trace", "solar_power": "trace",
          "charger_max_power": None, "charger_efficiency": None, "charger_mask": "charger", "batt_capacity": None,
          "batt_max_power": None, "batt_efficiency": None, "batt_dod": None, "soc_margin_ratio": None,
          "penalty_gain": None, "w_battery_penalty": None, "w_vehicle_penalty": None, "grid_cost_weight": None,
          "sell_coefficient": None, "nonexistent_marker": None}
TABLES = ("occupancy", "capacity", "requested_soc", "is_arrival", "dep_obs", "mask_departing", "mask_departing3")
# the (B,) rows of the float buffer (csrc/engine_step.cu StepRow)
ROWS = ("reward", "total_cost", "grid_energy_cost", "grid_energy", "grid_power", "solar", "total_penalty", "dod",
        "zeros", "vehicle", "charging", "discharging", "batt_used", "batt_calculated", "batt_soc", "batt_init_soc",
        "pv_shift", "nonexistent", "battery_action")


def _strides(x: torch.Tensor, name: str, shape: tuple, dtypes: tuple, device: torch.device) -> tuple:
    """The element strides of an operand of ``shape``; raises where the
    kernel does not take ``x`` (a shape, dtype or device other than its, or
    a tensor that requires grad)."""
    if x.shape != shape:
        raise ValueError(f"engine_step: {name} must be {tuple(shape)}, got {tuple(x.shape)}")
    if x.dtype not in dtypes:
        raise ValueError(f"engine_step: {name} is {x.dtype}, needs {' or '.join(map(str, dtypes))}")
    if x.requires_grad:
        raise ValueError(f"engine_step takes no operand that requires grad: {name} does")
    if x.device != device:
        raise ValueError(f"engine_step: {name} is on {x.device}, the params on {device}")
    return x.stride()


def _param_strides(x: torch.Tensor, name: str, column: str | None, B: int, N: int, T: int, dtype,
                   device: torch.device) -> tuple[int, int, int]:
    """A param's strides along the env axis (0 where it has none) and along
    its column: a scalar or ``(B,)``; a trace ``(P,)`` or ``(B, P)`` with
    ``P >= T``; the charger mask ``(N,)`` or ``(B, N)``."""
    ndim = 0 if column is None else 1
    batched = x.dim() == ndim + 1
    if (x.dim() not in (ndim, ndim + 1) or (batched and x.shape[0] != B)
            or (column == "charger" and x.shape[-1] != N) or (column == "trace" and x.shape[-1] < T)):
        want = {None: "()", "trace": f"(P,) with P >= {T}", "charger": f"({N},)"}[column]
        raise ValueError(f"engine_step: params.{name} must be {want} or that with a leading {B}, got {tuple(x.shape)}")
    _strides(x, f"params.{name}", x.shape, (dtype,), device)
    return x.stride(0) if batched else 0, x.stride(-1) if column else 0, 0


def engine_step(config: NanogridConfig, params: NanogridParams, state: EnvState, action: torch.Tensor,
                next_pv_shift: torch.Tensor | None = None, generator: torch.Generator | None = None) -> StepResult:
    """One environment step for every env in one launch, on the params'
    CUDA device in their dtype (f32 or f64): :func:`..core.transition.step`'s
    :class:`StepResult`, bit for bit that of ``step_plain``.  Envs that
    finish their day take ``next_pv_shift (B,)``, or a shift drawn from
    ``generator``.  Raises, before it draws or launches, on any other dtype,
    on operands of a wrong shape or device and on operands that require
    grad (nothing differentiates through the step)."""
    N, T, L, A = config.num_chargers, config.steps_per_day, config.table_len, config.num_actions
    dtype, device = params.dtype, params.device
    if dtype not in DTYPES:
        raise ValueError(f"engine_step takes float32 or float64 params, got {dtype}")
    if state.t.dim() != 1:
        raise ValueError(f"engine_step: state.t must be (B,), got {tuple(state.t.shape)}")
    if next_pv_shift is None and generator is None:
        raise ValueError("step needs next_pv_shift or a generator for the day-end PV-shift redraw")
    B = state.t.shape[0]
    operands = [getattr(params, name) for name in PARAMS]
    strides = [s for x, (name, column) in zip(operands, PARAMS.items())
               for s in _param_strides(x, name, column, B, N, T, dtype, device)]
    same, table, row, mask = (dtype,), (B, N, L), (B,), (B, N)
    carried = [*((getattr(state.schedule, name), f"state.schedule.{name}", table, same) for name in TABLES),
               (state.soc, "state.soc", table, same), (state.t, "state.t", row, (torch.int64,)),
               (state.day, "state.day", row, (torch.int64,)), (state.batt_soc, "state.batt_soc", row, same),
               (state.batt_init_soc, "state.batt_init_soc", row, same), (state.pv_shift, "state.pv_shift", row, same),
               (state.pmask, "state.pmask", mask, same)]
    for x, name, shape, dtypes in carried:
        strides += _strides(x, name, shape, dtypes, device) + (0,) * (3 - len(shape))
        operands.append(x)
    _strides(action, "action", (B, A), DTYPES, device)
    if next_pv_shift is not None:
        _strides(next_pv_shift, "next_pv_shift", row, DTYPES, device)
    if device.type != "cuda":
        raise ValueError(f"engine_step needs params on a CUDA device, got {device}")

    if action.dtype != dtype:
        action = action.to(dtype)
    drawn = next_pv_shift is None
    if drawn:  # the twin's draw (transition.draw_pv_shift), scaled in the kernel
        next_pv_shift = draw_pv_percent(B, generator, device)
    elif next_pv_shift.dtype != dtype:
        next_pv_shift = next_pv_shift.to(dtype)
    operands += (action, next_pv_shift)
    strides += (*action.stride(), 0, next_pv_shift.stride(0), 0, 0)
    pointers, packed = array.array("Q", [x.data_ptr() for x in operands]), array.array("q", strides)

    R = len(ROWS)
    rows = torch.empty(R * B + 2 * B * N, dtype=dtype, device=device)
    soc = torch.empty((B, N, L), dtype=dtype, device=device)
    obs = torch.empty((B, config.obs_dim), dtype=torch.float32 if config.cast_obs_to_f32 else dtype, device=device)
    steps = torch.empty((2, B), dtype=torch.int64, device=device)
    done = torch.empty(B, dtype=torch.bool, device=device)
    lib = _build.load(_build.engine_spec(config), device)
    _build.launch(LAUNCH_NAME, lib.ngk_engine_step, ctypes.c_void_p(pointers.buffer_info()[0]),
                  ctypes.c_void_p(packed.buffer_info()[0]), rows, soc, obs, steps, done, B, T, L,
                  params.price_norm.shape[-1], params.rad_norm.shape[-1], float(config.time_interval),
                  int(dtype == torch.float64), int(drawn), device=device)

    r = dict(zip(ROWS, rows[:R * B].view(R, B).unbind(0)))
    power, pmask = rows[R * B:].view(2, B, N).unbind(0)
    t_next, day_next = steps.unbind(0)
    if config.battery_system:
        batt_soc, batt_init_soc, battery_action = r["batt_soc"], r["batt_init_soc"], action[:, -1]
    else:
        batt_soc, batt_init_soc, battery_action = state.batt_soc, state.batt_init_soc, r["battery_action"]
    zeros, dod, vehicle = r["zeros"], r["dod"], r["vehicle"]
    next_state = state._replace(t=t_next, soc=soc, batt_soc=batt_soc, batt_init_soc=batt_init_soc,
                                pv_shift=r["pv_shift"], pmask=pmask, day=day_next)
    info = StepInfo(
        total_cost=r["total_cost"],
        grid_energy_cost=r["grid_energy_cost"],
        grid_energy=r["grid_energy"],
        grid_power=r["grid_power"],
        utilized_solar_energy=r["solar"],
        total_penalty=r["total_penalty"],
        total_battery_penalty=dod,
        battery_soc_below_dod_penalty=dod,
        battery_overcharging_penalty=zeros,
        battery_over_discharging_penalty=zeros,
        low_resource_utilisation_penalty=zeros,
        total_vehicle_penalty=vehicle,
        insufficiently_charged_vehicles_penalty=vehicle,
        needlessly_charged_vehicles_penalty=zeros,
        overcharged_vehicles_penalty=zeros,
        over_discharged_vehicles_penalty=zeros,
        battery_action=battery_action,
        charger_actions=action[:, :N],
        total_charging_power=r["charging"],
        total_discharging_power=r["discharging"],
        charger_power_values=power,
        battery_power_value=r["batt_used"],
        battery_calculated_power_value=r["batt_calculated"],
        battery_state_of_charge=batt_soc,
        initial_battery_state_of_charge=batt_init_soc,
        discharging_nonexistent_vehicles_penalty=r["nonexistent"],
    )
    return StepResult(next_state, obs, r["reward"], done, info)
