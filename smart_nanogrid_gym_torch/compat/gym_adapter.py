"""Single-env Gymnasium-style adapter reproducing the reference API surface
(port of ``smart_nanogrid_gym_tpu/compat/gym_adapter.py``).

A drop-in for the reference ``SmartNanogridEnv``
(envs/smart_nanogrid_environment.py): the same constructor kwargs, the same
5-tuple ``step``, the same ``reset(generate_new_initial_values=...,
algorithm_used=..., environment_mode=...)`` kwargs, the same observation and
action spaces, the same telemetry series accumulated per step and the same
day-end JSON dumps, with reference-compatible keys and file names (POSIX path
separators: the reference's Windows-only concatenation, SURVEY.md Q7, is
fixed).  The BESS state of charge persists across ``reset`` calls, as the
reference's CMS builds its battery once per env (SURVEY.md §3.1).

The engine runs on ``device`` (the card unless the caller asks for the CPU);
the adapter's contract is numpy in and out, one host round trip per step.
Seeds go through a ``torch.Generator`` on that device.  Without
``gymnasium`` the adapter is a plain duck-typed env whose spaces are None.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

try:  # gymnasium is optional; the adapter degrades to a plain duck-typed env
    import gymnasium
    from gymnasium import spaces as gym_spaces

    _GYM_BASE = gymnasium.Env
except ImportError:
    gymnasium = None
    gym_spaces = None
    _GYM_BASE = object

from ..core.config import NanogridConfig
from ..core.env import SmartNanogridTorch
from ..core.generate import load_initial_values_json, schedule_to_json_dict
from ..core.params import make_params

# The telemetry series accumulated per step (reference env.py:143-171) and
# their keys in prediction_results.json (reference env.py:246-275).
_SERIES_TO_JSON = {
    "grid_power": "Grid_power",
    "grid_energy": "Grid_energy",
    "utilized_solar_energy": "Utilized_solar_energy",
    "total_vehicle_penalty": "Total_vehicle_penalties",
    "total_battery_penalty": "Total_battery_penalties",
    "total_penalty": "Total_penalties",
    "total_cost": "Total_cost",
    "battery_state_of_charge": "Battery_state_of_charge",
    "grid_energy_cost": "Grid_energy_cost",
    "battery_action": "Battery_action",
    "charger_actions": "Charger_actions",
    "total_charging_power": "Total_charging_power",
    "total_discharging_power": "Total_discharging_power",
    "charger_power_values": "Charger_power_values",
    "battery_power_value": "Battery_power_value",
    "battery_soc_below_dod_penalty": "Battery_SOC_below_DoD_penalties",
    "low_resource_utilisation_penalty": "Low_resource_utilisation_penalties",
    "battery_overcharging_penalty": "Battery_overcharging_penalties",
    "battery_over_discharging_penalty": "Battery_over_discharging_penalties",
    "insufficiently_charged_vehicles_penalty": "Insufficiently_charged_vehicle_penalties",
    "needlessly_charged_vehicles_penalty": "Needlessly_charged_vehicle_penalties",
    "overcharged_vehicles_penalty": "Overcharged_vehicle_penalties",
    "over_discharged_vehicles_penalty": "Over_discharged_vehicle_penalties",
    "battery_calculated_power_value": "Battery_calculated_power_value",
    "discharging_nonexistent_vehicles_penalty": "DisCharging_nonexistent_vehicles_penalties",
}


def build_spaces(cfg: NanogridConfig):
    """Observation and action spaces (reference envs/smart_nanogrid_environment.py:98-120),
    or ``(None, None)`` without gymnasium."""
    if gym_spaces is None:
        return None, None
    obs_low = np.zeros(cfg.obs_dim, dtype=np.float32)
    obs_high = np.ones(cfg.obs_dim, dtype=np.float32)
    observation_space = gym_spaces.Box(low=obs_low, high=obs_high, dtype=np.float32)
    a_low, a_high = cfg.action_bounds()
    action_space = gym_spaces.Box(low=a_low, high=a_high, shape=a_low.shape, dtype=np.float32)
    return observation_space, action_space


class SmartNanogridEnv(_GYM_BASE):
    """Reference-compatible single-env wrapper around the PyTorch engine."""

    metadata = {"render_modes": []}

    def __init__(
        self,
        price_model=0,
        number_of_chargers=8,
        pv_system_available_in_model=True,
        battery_system_available_in_model=True,
        vehicle_to_everything=False,
        enable_different_vehicle_battery_capacities=True,
        enable_requested_state_of_charge=False,
        algorithm_used="",
        environment_mode="",
        time_interval="",
        charging_mode="bounded",
        vehicle_uncharged_penalty_mode="sparse",
        output_directory=None,
        seed=0,
        dtype=torch.float32,
        device="cuda",
    ):
        self.config = NanogridConfig.from_reference_kwargs(
            price_model=price_model,
            number_of_chargers=number_of_chargers,
            pv_system_available_in_model=pv_system_available_in_model,
            battery_system_available_in_model=battery_system_available_in_model,
            vehicle_to_everything=vehicle_to_everything,
            enable_different_vehicle_battery_capacities=enable_different_vehicle_battery_capacities,
            enable_requested_state_of_charge=enable_requested_state_of_charge,
            time_interval=time_interval,
            charging_mode=charging_mode,
            vehicle_uncharged_penalty_mode=vehicle_uncharged_penalty_mode,
        )
        self.device = torch.device(device)
        self.params = make_params(self.config, dtype, self.device)
        self.engine = SmartNanogridTorch(self.config)
        self.algorithm_used = algorithm_used
        self.environment_mode = environment_mode
        self.requested_time_interval = time_interval
        self.charging_mode = charging_mode
        self.penalty_mode_name = vehicle_uncharged_penalty_mode
        self.output_directory = output_directory

        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._state = None
        self._batt_soc_carry = None  # persists across resets (reference quirk)
        self._telemetry = {name: [] for name in _SERIES_TO_JSON}
        self._initial_battery = 0.0
        self.observation_space, self.action_space = build_spaces(self.config)

    # ------------------------------------------------------------------ API --

    def reset(
        self,
        seed=None,
        options=None,
        generate_new_initial_values=True,
        algorithm_used="",
        environment_mode="",
        initial_values_path=None,
        **_kwargs,
    ):
        if seed is not None:
            self._generator.manual_seed(seed)
            if gymnasium is not None:
                super().reset(seed=seed)  # seeds gymnasium's np_random bookkeeping
        self.algorithm_used = algorithm_used or self.algorithm_used
        self.environment_mode = environment_mode or self.environment_mode

        for series in self._telemetry.values():
            series.clear()

        schedule = None
        if not generate_new_initial_values:
            path = initial_values_path or self._initial_values_path()
            schedule = load_initial_values_json(path, self.config, self.params.dtype, self.device)

        state, obs = self.engine.reset(self.params, self._generator, batt_soc=self._batt_soc_carry,
                                       schedule=schedule)
        self._state = state
        self._initial_battery = float(state.batt_soc) if self.config.battery_system else 0.0

        if generate_new_initial_values:
            self._save_initial_values()
        return obs.cpu().numpy(), {}

    def step(self, actions):
        actions = np.asarray(actions, dtype=np.float64)
        if actions.shape != (self.config.num_actions,):
            # The reference silently slices oversized vectors
            # (central_management_system.py:85-89); be explicit at the API edge.
            raise ValueError(
                f"expected {self.config.num_actions} actions, got shape {actions.shape}"
            )
        action = torch.as_tensor(actions, device=self.device).to(self.params.dtype)
        res = self.engine.step(self.params, self._state, action, self._generator)
        self._state = res.state
        self._batt_soc_carry = res.state.batt_soc

        # one device-to-host copy for the observation, reward, done and telemetry
        info = res.info._asdict()
        leaves = [res.obs, res.reward, res.done] + [info[name] for name in _SERIES_TO_JSON] \
            + [res.info.initial_battery_state_of_charge]
        host = torch.cat([x.reshape(-1).to(torch.float64) for x in leaves]).cpu().numpy()
        parts = np.split(host, np.cumsum([x.numel() for x in leaves])[:-1])
        obs = parts[0].astype(np.float32 if res.obs.dtype == torch.float32 else np.float64)
        reward, done = float(parts[1][0]), bool(parts[2][0])
        for series, val, leaf in zip(self._telemetry.values(), parts[3:], leaves[3:]):
            series.append(val.tolist() if leaf.dim() else float(val[0]))
        self._initial_battery = float(parts[-1][0])

        if done:
            self._save_prediction_results()
        return obs, reward, done, False, {}

    def render(self, mode="human"):
        pass

    def seed(self, seed=None):
        if seed is not None:
            self._generator.manual_seed(seed)

    def close(self):
        pass

    # ----------------------------------------------------------- file IO -----

    def _out_dir(self):
        base = self.output_directory or os.path.join(os.getcwd(), "nanogrid_outputs")
        # Mirrors reference environment_mode -> directory routing (env.py:289-296).
        mode_dir = {
            "training": "training_files",
            "evaluation": "evaluation_files",
            "prediction": "single_prediction_files",
        }.get(self.environment_mode, "")
        path = os.path.join(base, "RL", mode_dir) if mode_dir else base
        os.makedirs(path, exist_ok=True)
        return path

    def _file_name_root(self):
        """Reference file naming: {ALGO}-{variant}-{mode}-{penalty}-{N}ch-{Δt}
        (env.py:300-303)."""
        cfg = self.config
        return (
            f"{self.algorithm_used}-{cfg.variant_name}-{self.charging_mode}-"
            f"{self.penalty_mode_name}-{cfg.num_chargers}ch-{self.requested_time_interval}"
        )

    def _initial_values_path(self):
        base = self.output_directory or os.path.join(os.getcwd(), "nanogrid_outputs")
        os.makedirs(base, exist_ok=True)
        return os.path.join(base, "initial_values.json")

    def _save_initial_values(self):
        payload = schedule_to_json_dict(self._state.schedule, self.config)
        with open(self._initial_values_path(), "w") as fp:
            json.dump(payload, fp, indent=4)

    def _save_prediction_results(self):
        """Day-end telemetry dump with reference-compatible keys (env.py:239-309)."""
        cfg = self.config
        if cfg.pv_system:
            # Available_solar_energy is the *unshifted* padded trace
            # (pv_system_manager.py:75-76): power · Δt over 2 padded days.
            solar_energy = (self.params.solar_power.cpu().numpy() * cfg.time_interval).reshape(1, -1).tolist()
        else:
            solar_energy = []
        results = {"SOC": self._state.soc.cpu().numpy().tolist()}
        for name, json_key in _SERIES_TO_JSON.items():
            results[json_key] = self._telemetry[name]
        results["Available_solar_energy"] = solar_energy
        results["Initial_battery_state_of_charge"] = self._initial_battery

        out_dir = self._out_dir()
        with open(os.path.join(out_dir, "prediction_results.json"), "w") as fp:
            json.dump(results, fp, indent=4)
        name = self._file_name_root()
        with open(os.path.join(out_dir, f"{name}-prediction_results.json"), "w") as fp:
            json.dump(results, fp, indent=4)
        with open(os.path.join(out_dir, f"{name}-initial_values.json"), "w") as fp:
            json.dump(schedule_to_json_dict(self._state.schedule, self.config), fp, indent=4)
