"""The price and solar tables of a grid, worked out from the published
tariffs and the raw minute irradiance file (upstream ``utils/accountant.py``
and ``utils/pv_system_manager.py``)."""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

# accountant.py:17-24 (tariffs), pv_system.py:5-11 and pv_system_manager.py:69 (panels)
HIGH_TARIFF = 0.028 + 0.148933333 + 0.014
LOW_TARIFF = 0.013333333 + 0.087613333 + 0.014
PV_AREA = 2.279 * 1.134 * 20
PV_EFFICIENCY = 0.21
SOLAR_SCALING = 1.5


class Tables(NamedTuple):
    price: torch.Tensor       # (2T,) price per kWh at each step of two days
    price_norm: torch.Tensor  # (2T,) the price over its maximum
    rad_norm: torch.Tensor    # (2T,) irradiance over its maximum
    solar: torch.Tensor       # (2T,) PV power, kW


def grid_tables(grid: dict, root: Path, device, dtype=torch.float32) -> Tables:
    """The tables of ``grid`` (a configuration file's ``grid``) at 1 h or 2 h
    steps with price model 0, in ``dtype`` on ``device``; the irradiance
    file is ``grid["irradiance_file"]`` under ``root``."""
    dt = float(grid["time_interval_h"])
    if dt not in (1.0, 2.0) or int(grid["price_model"]) != 0:
        raise ValueError("the reference covers price model 0 at 1 h or 2 h steps")
    T = int(round(24.0 / dt))
    day = np.array([LOW_TARIFF] * 7 + [HIGH_TARIFF] * 13 + [LOW_TARIFF] * 4, dtype=np.float64)
    price = np.concatenate([day, day])
    minutes = np.asarray(np.load(root / grid["irradiance_file"]), dtype=np.float64).reshape(-1)
    step = int(60 * dt)
    irr = np.array([minutes[i * step:(i + 1) * step].mean() for i in range(2 * T)])
    solar = irr * (PV_AREA * PV_EFFICIENCY / 1000.0) * SOLAR_SCALING / dt
    rad_max = float(irr.max(where=(irr >= 0), initial=0))

    def put(x):
        return torch.as_tensor(np.asarray(x, np.float64), device=device).to(torch.float32).to(dtype)

    return Tables(put(price), put(price / price.max()), put(irr / rad_max), put(solar))
