"""Energy-price tables.

Re-expresses the reference ``Accountant`` pricing (utils/accountant.py) as
precomputed device arrays: one ``(2*24,)`` price-per-timestep table (the day is
duplicated so the 3-step lookahead never overflows, accountant.py:100) plus its
max for normalisation (accountant.py:51).

Grid tariffs (accountant.py:17-24):
  high = 0.028 + 0.148933333 + 0.014
  low  = 0.013333333 + 0.087613333 + 0.014

Price model 0 uses the hardcoded hourly tariff schedule (accountant.py:69-73);
the interval-aware ``day_tariffs`` the reference computes and then discards
(accountant.py:62-68) is faithfully *not* used (SURVEY.md Q3).  Models 1-4 are
the hardcoded 24-value day arrays (accountant.py:74-98).  Model 5 is broken at
the reference HEAD and rejected in :class:`..core.config.NanogridConfig`.

The PyTorch port keeps this copy of ``smart_nanogrid_gym_tpu/core/prices.py``,
unchanged apart from this note, so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

GRID_TARIFF_HIGH = 0.028
GRID_TARIFF_LOW = 0.013333333
ENERGY_TARIFF_HIGH = 0.148933333
ENERGY_TARIFF_LOW = 0.087613333
RES_INCENTIVE = 0.014

HIGH_TARIFF = GRID_TARIFF_HIGH + ENERGY_TARIFF_HIGH + RES_INCENTIVE
LOW_TARIFF = GRID_TARIFF_LOW + ENERGY_TARIFF_LOW + RES_INCENTIVE

SELLING_PRICE_COEFFICIENT = 0.8  # accountant.py:6
GRID_COST_WEIGHT = 0.75  # accountant.py:35

_PRICE_DAYS = {
    1: [0.05, 0.05, 0.05, 0.05, 0.05, 0.05, 0.05, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1,
        0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.05, 0.05, 0.05, 0.05],
    2: [0.05, 0.05, 0.05, 0.05, 0.05, 0.06, 0.07, 0.08, 0.09, 0.1, 0.1, 0.1, 0.08, 0.06,
        0.05, 0.05, 0.05, 0.06, 0.06, 0.06, 0.06, 0.05, 0.05, 0.05],
    3: [0.071, 0.060, 0.056, 0.056, 0.056, 0.060, 0.060, 0.060, 0.066, 0.066, 0.076, 0.080,
        0.080, 0.1, 0.1, 0.076, 0.076, 0.1, 0.082, 0.080, 0.085, 0.079, 0.086, 0.070],
    4: [0.1, 0.1, 0.05, 0.05, 0.05, 0.05, 0.05, 0.08, 0.08, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1,
        0.1, 0.1, 0.06, 0.06, 0.06, 0.1, 0.1, 0.1, 0.1],
}


def price_day(price_model: int) -> np.ndarray:
    """One 24-entry price day for the given model (accountant.py:58-98)."""
    if price_model == 0:
        return np.array([LOW_TARIFF] * 7 + [HIGH_TARIFF] * 13 + [LOW_TARIFF] * 4, dtype=np.float64)
    if price_model in _PRICE_DAYS:
        return np.array(_PRICE_DAYS[price_model], dtype=np.float64)
    raise ValueError(f"Unsupported price model {price_model}")


def build_price_table(price_model: int, table_len: int = 48) -> tuple[np.ndarray, float]:
    """Duplicated-day price table and its max (accountant.py:48-56,100).

    The reference allocates ``zeros((days, 2*24))`` and assigns the 48-entry
    duplicated day into every row; we return one row.  For sub-hourly intervals
    (which the reference cannot run, SURVEY.md Q3) the hourly day is repeated per
    timestep so indexing by timestep remains meaningful.
    """
    day = price_day(price_model)
    if table_len == 48:
        # 1h and 2h reference configs: the hourly day duplicated, indexed by
        # *timestep* exactly as the reference does — bug-for-bug at 2h
        # (accountant.py:49,100; SURVEY.md Q3)
        table = np.concatenate([day, day])
    else:
        # general intervals (impossible in the reference): timestep t maps to
        # wall-clock hour floor(t·Δt), correct for any Δt incl. non-divisors
        steps_per_day = table_len // 2
        interval = 24.0 / steps_per_day
        hour_idx = np.floor(np.arange(steps_per_day) * interval).astype(int) % 24
        per_step = day[hour_idx]
        table = np.concatenate([per_step, per_step])
    price_max = float(table.max(where=(table >= 0), initial=0))
    return table, price_max
