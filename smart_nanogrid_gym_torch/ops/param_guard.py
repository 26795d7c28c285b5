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

PHYSICS_CONSTANTS = {
    "charger_max_power": 22.0,
    "charger_efficiency": 0.95,
    "charger_mask": 1.0,  # kernels assume every charger is active
    "soc_margin_ratio": 0.05,
    "penalty_gain": 10.0,
    "w_battery_penalty": 0.8,
    "w_vehicle_penalty": 1.0,
    "grid_cost_weight": 0.75,
    "sell_coefficient": 0.8,
}

BATTERY_CONSTANTS = {
    "batt_dod": 0.15,
    "batt_capacity": 80.0,
    "batt_max_power": 44.0,
    "batt_efficiency": 0.95,
}

GENERATION_CONSTANTS = {
    "arrival_threshold": 0.6,
    "soc_low": 0.1,
    "soc_span": 0.8,
    "cap_low": 15.0,
    "cap_span": 105.0,
    "default_capacity": 40.0,
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
    ``battery_init``: the kernel starts the BESS at the baked 0.5, so
    ``batt_init_soc`` must match too.  Values are compared in the params'
    dtype, so an f32 param matches the f32 rounding of its constant.
    """
    expected = dict(PHYSICS_CONSTANTS)
    if config.battery_system:
        expected.update(BATTERY_CONSTANTS)
        if battery_init:
            expected["batt_init_soc"] = 0.5
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
