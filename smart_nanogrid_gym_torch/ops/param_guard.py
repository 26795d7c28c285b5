"""Guard for the constants the kernels bake in (K0; port of ``param_guard.py:25-98``).

The plain engine reads every physics constant from :class:`NanogridParams`,
but the kernels in this package (and their twins, which mirror them) bake the
reference defaults as compile-time constants.  Every kernel entry point calls
:func:`check_baked_params` first, so params that differ fail loudly instead of
giving silently wrong results.
"""

from __future__ import annotations

import torch

from ..core.config import NanogridConfig
from ..core.params import NanogridParams
from ..utils.profiling import spanned

# reference constants (charger.py:20-23, central_management_system.py:35,
# penaliser.py:7,79,177-181, accountant.py:6,35, charging_station.py:214,257-269):
# the values the kernels bake (csrc/day_step.cuh) and their twins compute with
MAX_P, EFF = 22.0, 0.95
MARGIN, GAIN = 0.05, 10.0
W_BATT, W_VEH, GRID_W, SELL = 0.8, 1.0, 0.75, 0.8
B_CAP, B_MAXP, B_EFF, BATT_DOD = 80.0, 44.0, 0.95, 0.15
BATT_INIT_SOC = 0.5
ARRIVAL_THRESHOLD = 0.6
SOC_LOW, SOC_SPAN = 0.1, 0.8
CAP_LOW, CAP_SPAN, DEFAULT_CAP = 15.0, 105.0, 40.0
# RBC threshold (solvers/RBC/rbc.py:14): normalised departure < 0.16667 (4h/24)
DEPARTURE_SOON_THRESHOLD = 0.16667

PHYSICS_CONSTANTS = {
    "charger_max_power": MAX_P,
    "charger_efficiency": EFF,
    "charger_mask": 1.0,  # kernels assume every charger is active
    "soc_margin_ratio": MARGIN,
    "penalty_gain": GAIN,
    "w_battery_penalty": W_BATT,
    "w_vehicle_penalty": W_VEH,
    "grid_cost_weight": GRID_W,
    "sell_coefficient": SELL,
}

BATTERY_CONSTANTS = {
    "batt_dod": BATT_DOD,
    "batt_capacity": B_CAP,
    "batt_max_power": B_MAXP,
    "batt_efficiency": B_EFF,
}

GENERATION_CONSTANTS = {
    "arrival_threshold": ARRIVAL_THRESHOLD,
    "soc_low": SOC_LOW,
    "soc_span": SOC_SPAN,
    "cap_low": CAP_LOW,
    "cap_span": CAP_SPAN,
    "default_capacity": DEFAULT_CAP,
}


@spanned("guard")
def check_baked_params(
    config: NanogridConfig,
    params: NanogridParams,
    kernel: str,
    *,
    generation: bool = False,
    battery_init: bool = False,
) -> None:
    """Raise ``ValueError`` unless every param ``kernel`` bakes has its baked value.

    ``generation``: the kernel also bakes the schedule-generation constants.
    ``battery_init``: the kernel starts the BESS at ``BATT_INIT_SOC``, so
    ``batt_init_soc`` must match too.  Values are compared in the params'
    dtype, so an f32 param matches the f32 rounding of its constant.
    """
    expected = dict(PHYSICS_CONSTANTS)
    if config.battery_system:
        expected.update(BATTERY_CONSTANTS)
        if battery_init:
            expected["batt_init_soc"] = BATT_INIT_SOC
    if generation:
        expected.update(GENERATION_CONSTANTS)

    # one device-to-host copy for all leaves (each read alone would synchronise)
    names = list(expected)
    flat = [getattr(params, name).detach().reshape(-1) for name in names]
    host = torch.cat(flat).cpu().split([x.numel() for x in flat])
    for name, leaf in zip(names, host):
        want = expected[name]
        if not bool(torch.all(leaf == torch.tensor(want, dtype=leaf.dtype))):
            got = torch.unique(leaf)
            raise ValueError(
                f"{kernel} bakes params.{name}={want} as a compile-time constant but "
                f"these params carry {got[:8].tolist()}; the kernels support only the "
                f"reference defaults, use the plain engine (core.rollout / "
                f"core.transition) for other or heterogeneous params"
            )
