"""Static environment configuration.

The reference exposes its configuration entirely through ``SmartNanogridEnv.__init__``
kwargs (reference: envs/smart_nanogrid_environment.py:32-34).  In the TPU build the
same switches become a frozen, hashable dataclass that is passed as a *static*
argument to ``jax.jit`` — every flag combination compiles its own branch-free XLA
program (SURVEY.md §7.3: penalty modes / pv / battery / v2x must be static).

Anything that is an *array-valued* parameter (prices, solar traces, battery
capacity, charger mask, …) lives in :mod:`.params` instead so that heterogeneous
env batches can vary it under ``vmap`` without recompiling.

The PyTorch port keeps this copy of ``smart_nanogrid_gym_tpu/core/config.py``,
unchanged apart from this note, so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import enum


class PenaltyMode(enum.IntEnum):
    """Vehicle-uncharged penalty modes (reference: utils/charging_station.py:50-60)."""

    NO_PENALTY = 0
    ON_DEPARTURE = 1
    SPARSE = 2
    DENSE = 3


_PENALTY_MODE_NAMES = {
    "no_penalty": PenaltyMode.NO_PENALTY,
    "on_departure": PenaltyMode.ON_DEPARTURE,
    "sparse": PenaltyMode.SPARSE,
    "dense": PenaltyMode.DENSE,
}


def parse_time_interval(requested: str | float | None) -> float:
    """Parse ``'?h'`` / ``'?min'`` interval strings (reference:
    envs/smart_nanogrid_environment.py:125-138)."""
    if requested is None or requested == "":
        return 1.0
    if isinstance(requested, (int, float)):
        return float(requested)
    if "h" in requested:
        return float(requested.replace("h", ""))
    if "min" in requested:
        return float(requested.replace("min", "")) / 60.0
    raise ValueError("Wrong time interval was provided")


@dataclasses.dataclass(frozen=True)
class NanogridConfig:
    """Static (compile-time) configuration of the nanogrid environment.

    Defaults mirror the reference's working configs (reference:
    solvers/RL/ppo_train.py:22-75): ``charging_mode='bounded'`` and an explicit
    penalty mode, since the reference's own ctor defaults raise at the first
    nonzero action (SURVEY.md §5.6).
    """

    num_chargers: int = 8
    time_interval: float = 1.0
    price_model: int = 0
    pv_system: bool = True
    battery_system: bool = True
    vehicle_to_everything: bool = False
    different_battery_capacities: bool = True
    requested_state_of_charge: bool = False
    charging_mode: str = "bounded"
    penalty_mode: PenaltyMode = PenaltyMode.SPARSE
    lookahead: int = 3  # NUMBER_OF_HOURS_AHEAD — counts *timesteps* (SURVEY.md Q11)
    num_days: int = 1  # NUMBER_OF_DAYS_TO_PREDICT
    track_soc_history: bool = True
    # When True the whole step runs in the params dtype and the observation is cast
    # to float32 at the end, matching the reference's float64-compute/float32-obs
    # split (reference: envs/smart_nanogrid_environment.py:224-229).
    cast_obs_to_f32: bool = True

    def __post_init__(self):
        if self.charging_mode != "bounded":
            # Only 'bounded' exists in the reference (utils/charger.py:59,88).
            raise ValueError("Error: Wrong charging mode provided!")
        if isinstance(self.penalty_mode, str):
            object.__setattr__(self, "penalty_mode", _PENALTY_MODE_NAMES[self.penalty_mode])
        if self.price_model not in (0, 1, 2, 3, 4):
            # Model 5 is broken at the reference's HEAD (utils/accountant.py:90-98
            # indexes into an empty list) and is documented as unsupported.
            raise ValueError(f"Unsupported price model {self.price_model}")

    # ---- derived static sizes -------------------------------------------------

    @property
    def steps_per_day(self) -> int:
        """Timesteps per simulated day (reference: 24/TIME_INTERVAL,
        envs/smart_nanogrid_environment.py:233-237)."""
        return int(round(24.0 / self.time_interval))

    @property
    def table_len(self) -> int:
        """Length of per-charger day arrays.  The reference uses fixed
        ``zeros(25)`` (utils/charger.py:16-19) which is ``steps_per_day + 1`` at
        the only interval that fully works (1h); we generalise so sub-hourly
        intervals are *correct* here while matching the reference exactly at 1h
        (SURVEY.md Q3 stance)."""
        return self.steps_per_day + 1

    @property
    def price_table_len(self) -> int:
        """At the reference's two runnable intervals (1h/2h) the table is the
        2*24 hourly layout indexed by timestep, replicated bug-for-bug
        (utils/accountant.py:14,49; SURVEY.md Q3).  Every other interval —
        impossible in the reference — gets two full days of *per-timestep*
        prices with the correct timestep->hour mapping."""
        if self.time_interval in (1.0, 2.0):
            return 48
        return 2 * self.steps_per_day

    @property
    def solar_table_len(self) -> int:
        """Solar tables are padded to 2 days of timesteps (reference:
        utils/pv_system_manager.py:12-15)."""
        return 2 * self.steps_per_day

    @property
    def num_actions(self) -> int:
        """Charger actions plus one battery action when a BESS is present
        (reference: envs/smart_nanogrid_environment.py:101-118)."""
        return self.num_chargers + int(self.battery_system)

    @property
    def obs_dim(self) -> int:
        """Observation length: (1+PV)·(1+lookahead) + 2·N + battery
        (reference: envs/smart_nanogrid_environment.py:90-96)."""
        amount_observed = 1 + int(self.pv_system)
        states = amount_observed * (1 + self.lookahead)
        return states + 2 * self.num_chargers + int(self.battery_system)

    @property
    def variant_name(self) -> str:
        """Model-variant naming used in reference file names
        (envs/smart_nanogrid_environment.py:280-287)."""
        if self.battery_system and self.pv_system and self.vehicle_to_everything:
            return "v2x-b-pv"
        if self.vehicle_to_everything:
            return "v2x"
        if self.battery_system and self.pv_system:
            return "b-pv"
        return "basic"

    def action_bounds(self):
        """Action-space bounds per the reference
        (envs/smart_nanogrid_environment.py:101-118): chargers in [0,1]
        (or [-1,1] with v2x), battery appended with low -1."""
        import numpy as np

        n = self.num_chargers
        low = np.full(n, -1.0 if self.vehicle_to_everything else 0.0, dtype=np.float32)
        high = np.ones(n, dtype=np.float32)
        if self.battery_system:
            low = np.append(low, -1.0).astype(np.float32)
            high = np.append(high, 1.0).astype(np.float32)
        return low, high

    # ---- construction helpers -------------------------------------------------

    @classmethod
    def from_reference_kwargs(
        cls,
        price_model: int = 0,
        number_of_chargers: int = 8,
        pv_system_available_in_model: bool = True,
        battery_system_available_in_model: bool = True,
        vehicle_to_everything: bool = False,
        enable_different_vehicle_battery_capacities: bool = True,
        enable_requested_state_of_charge: bool = False,
        time_interval: str = "",
        charging_mode: str = "bounded",
        vehicle_uncharged_penalty_mode: str = "sparse",
        **_ignored,
    ) -> "NanogridConfig":
        """Build a config from the reference's ctor kwarg names
        (envs/smart_nanogrid_environment.py:32-34)."""
        return cls(
            num_chargers=number_of_chargers,
            time_interval=parse_time_interval(time_interval),
            price_model=price_model,
            pv_system=pv_system_available_in_model,
            battery_system=battery_system_available_in_model,
            vehicle_to_everything=vehicle_to_everything,
            different_battery_capacities=enable_different_vehicle_battery_capacities,
            requested_state_of_charge=enable_requested_state_of_charge,
            charging_mode=charging_mode or "bounded",
            penalty_mode=vehicle_uncharged_penalty_mode or "sparse",
        )
