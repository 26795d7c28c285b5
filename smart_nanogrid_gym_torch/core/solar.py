"""PV / solar-irradiance tables.

Re-expresses the reference ``PVSystemManager`` (utils/pv_system_manager.py) as
precomputed device arrays:

- minute-resolution irradiance (W/m², shape (4321, 1) in the reference asset
  ``files/solar_irradiance.mat`` key ``irradiance``) is averaged per timestep
  over 2 padded days (pv_system_manager.py:34-44),
- available solar energy = irradiance · (panel_area · efficiency / 1000) · 1.5
  (pv_system_manager.py:67-73),
- available solar power = energy / Δt (pv_system_manager.py:87-88),
- normalisation max over the padded trace with ``where >= 0`` semantics
  (pv_system_manager.py:20).

The PV panel geometry constants come from the frozen ``PVSystem`` dataclass the
reference hardcodes (utils/pv_system_manager.py:17, utils/pv_system.py:5-11).

The PyTorch port keeps this copy of ``smart_nanogrid_gym_tpu/core/solar.py``,
unchanged apart from this note, so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import os

import numpy as np

PV_LENGTH = 2.279
PV_WIDTH = 1.134
PV_DEPTH = 20
PV_TOTAL_DIMENSIONS = PV_LENGTH * PV_WIDTH * PV_DEPTH  # 51.68772 m²
PV_EFFICIENCY = 0.21
SOLAR_SCALING = 1.5  # scaling_sol, pv_system_manager.py:69

_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
DEFAULT_IRRADIANCE_PATH = os.path.join(_DATA_DIR, "solar_irradiance_minutes.npy")


def load_minute_irradiance(path: str | None = None) -> np.ndarray:
    """Minute-resolution irradiance trace as a flat float64 array."""
    irr = np.load(path or DEFAULT_IRRADIANCE_PATH)
    return np.asarray(irr, dtype=np.float64).reshape(-1)


def irradiance_per_timestep(minutes: np.ndarray, num_timesteps: int, time_interval: float) -> np.ndarray:
    """Per-timestep mean irradiance (pv_system_manager.py:34-44)."""
    step_minutes = int(60 * time_interval)
    out = np.zeros(num_timesteps, dtype=np.float64)
    for i in range(num_timesteps):
        out[i] = minutes[i * step_minutes : (i + 1) * step_minutes].mean()
    return out


def build_solar_tables(
    time_interval: float,
    steps_per_day: int,
    path: str | None = None,
) -> tuple[np.ndarray, np.ndarray, float]:
    """Return ``(irradiance, solar_power, max_radiation)`` over 2 padded days.

    ``irradiance``   — per-timestep mean W/m², shape (2*steps_per_day,)
    ``solar_power``  — available produced power per timestep (kW), same shape
    ``max_radiation``— normalisation constant (pv_system_manager.py:20)
    """
    minutes = load_minute_irradiance(path)
    padded_len = 2 * steps_per_day
    irr = irradiance_per_timestep(minutes, padded_len, time_interval)
    scaling_pv = PV_TOTAL_DIMENSIONS * PV_EFFICIENCY / 1000.0
    energy = irr * scaling_pv * SOLAR_SCALING
    power = energy / time_interval
    max_radiation = float(irr.max(where=(irr >= 0), initial=0))
    return irr, power, max_radiation
