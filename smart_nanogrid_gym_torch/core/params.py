"""Array-valued environment parameters as a tensor container.

Port of ``smart_nanogrid_gym_tpu/core/params.py``: the same fields, built from
the port's copy of the numpy price and solar tables, as torch tensors of one dtype on
one device.  Leaves are unbatched (scalars, ``(P,)`` tables, ``(N,)`` charger
mask) as :func:`make_params` builds them, or carry a leading env axis after
:func:`broadcast_params`; the engine accepts both.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import prices, solar
from .config import NanogridConfig


class NanogridParams(NamedTuple):
    """Per-env parameters; field meanings as in the JAX package."""

    price: torch.Tensor
    price_norm: torch.Tensor
    rad_norm: torch.Tensor
    solar_power: torch.Tensor
    charger_max_power: torch.Tensor
    charger_efficiency: torch.Tensor
    charger_mask: torch.Tensor
    batt_capacity: torch.Tensor
    batt_init_soc: torch.Tensor
    batt_max_power: torch.Tensor
    batt_efficiency: torch.Tensor
    batt_dod: torch.Tensor
    arrival_threshold: torch.Tensor
    soc_low: torch.Tensor
    soc_span: torch.Tensor
    cap_low: torch.Tensor
    cap_span: torch.Tensor
    default_capacity: torch.Tensor
    soc_margin_ratio: torch.Tensor
    penalty_gain: torch.Tensor
    w_battery_penalty: torch.Tensor
    w_vehicle_penalty: torch.Tensor
    grid_cost_weight: torch.Tensor
    sell_coefficient: torch.Tensor
    nonexistent_marker: torch.Tensor

    @property
    def dtype(self) -> torch.dtype:
        return self.price.dtype

    @property
    def device(self) -> torch.device:
        return self.price.device

    @property
    def batched(self) -> bool:
        return self.price.dim() == 2


def make_params(
    config: NanogridConfig,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
    irradiance_path: str | None = None,
) -> NanogridParams:
    """Default parameters with the reference constants (params.py:67-109), on
    the card unless ``device`` says otherwise."""
    price_table, price_max = prices.build_price_table(config.price_model, config.price_table_len)
    if config.pv_system:
        irr, solar_power, max_rad = solar.build_solar_tables(
            config.time_interval, config.steps_per_day, irradiance_path
        )
        rad_norm = irr / max_rad
    else:
        solar_power = np.zeros(config.solar_table_len, dtype=np.float64)
        rad_norm = np.zeros(config.solar_table_len, dtype=np.float64)

    def arr(x):
        # via float64 numpy so every value rounds once, as jnp.asarray does
        return torch.as_tensor(np.asarray(x, np.float64), device=device).to(dtype)

    return NanogridParams(
        price=arr(price_table),
        price_norm=arr(price_table / price_max),
        rad_norm=arr(rad_norm),
        solar_power=arr(solar_power),
        charger_max_power=arr(22.0),
        charger_efficiency=arr(0.95),
        charger_mask=arr(np.ones(config.num_chargers)),
        batt_capacity=arr(80.0),
        batt_init_soc=arr(0.5),
        batt_max_power=arr(44.0),
        batt_efficiency=arr(0.95),
        batt_dod=arr(0.15),
        arrival_threshold=arr(0.6),
        soc_low=arr(0.1),
        soc_span=arr(0.8),
        cap_low=arr(15.0),
        cap_span=arr(105.0),
        default_capacity=arr(40.0),
        soc_margin_ratio=arr(0.05),
        penalty_gain=arr(10.0),
        w_battery_penalty=arr(0.8),
        w_vehicle_penalty=arr(1.0),
        grid_cost_weight=arr(prices.GRID_COST_WEIGHT),
        sell_coefficient=arr(prices.SELLING_PRICE_COEFFICIENT),
        nonexistent_marker=arr(100.0),
    )


def broadcast_params(params: NanogridParams, batch: int) -> NanogridParams:
    """Identical params along a new leading env axis (expanded views)."""
    if params.batched:
        return params
    return NanogridParams(*(x.expand((batch,) + tuple(x.shape)) for x in params))
