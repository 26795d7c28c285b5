"""What the drivers share: seeds, the program's grid configuration from a
configuration file, and actor-critic weights made on the device from a seed."""

from __future__ import annotations

import math

import numpy as np
import torch


def seeds(seed: int, n: int, salt: int = 0) -> list[int]:
    """``n`` 32-bit seeds drawn from the run's ``--seed`` (any size) and a salt."""
    return [int(x) for x in np.random.SeedSequence([int(seed) % 2 ** 64, salt]).generate_state(n)]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def program_config(grid: dict):
    """The program's ``NanogridConfig`` for a configuration file's ``grid``."""
    from smart_nanogrid_gym_torch.core.config import NanogridConfig

    return NanogridConfig(
        num_chargers=int(grid["chargers"]), time_interval=float(grid["time_interval_h"]),
        price_model=int(grid["price_model"]), pv_system=bool(grid["pv"]), battery_system=bool(grid["battery"]),
        vehicle_to_everything=bool(grid["v2x"]), different_battery_capacities=bool(grid["different_capacities"]),
        requested_state_of_charge=bool(grid["requested_soc"]), charging_mode=grid["charging_mode"],
        penalty_mode=grid["penalty_mode"], lookahead=int(grid["lookahead"]))


def actor_critic(F: int, A: int, hidden, seed: int, device: torch.device, pi_out: float) -> list[torch.Tensor]:
    """The 13 leaves of a tanh actor-critic (``pi`` torso, ``vf`` torso,
    ``log_std``), drawn in one call on ``device`` from ``seed``: weights
    normal with the gain √2 / √fan_in on the hidden layers, ``pi_out`` /
    √fan_in on the action mean and 1 / √fan_in on the value; biases and
    ``log_std`` zero."""
    H1, H2 = hidden
    shapes = [(H1, F), (H2, H1), (A, H2), (H1, F), (H2, H1), (1, H2)]
    gains = [math.sqrt(2), math.sqrt(2), pi_out, math.sqrt(2), math.sqrt(2), 1.0]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(a * b for a, b in shapes), generator=gen, device=device)
    leaves, at = [], 0
    for (rows, cols), gain in zip(shapes, gains):
        leaves.append(flat[at:at + rows * cols].view(rows, cols) * (gain / math.sqrt(cols)))
        leaves.append(torch.zeros(rows, device=device))
        at += rows * cols
    return leaves + [torch.zeros(A, device=device)]



def sample_calls(seed: int, calls: list, batch: int, traffic: dict) -> tuple[list, int]:
    """The calls the check compares: ``check_calls`` of the window's
    ``(call seed, (k, batch) stats)`` and ``check_envs`` envs of each, drawn
    from the run's seed, as ``(call seed, envs, their stats in f64 on the
    host)``; and how many stats of all the calls were not finite."""
    rng = np.random.default_rng([int(seed) % 2 ** 64, 2])
    picks = sorted(rng.choice(len(calls), size=min(int(traffic["check_calls"]), len(calls)), replace=False))
    out = []
    for i in picks:
        call_seed, stats = calls[int(i)]
        envs = np.sort(rng.choice(batch, size=min(int(traffic["check_envs"]), batch), replace=False))
        out.append((call_seed, envs, stats[:, torch.as_tensor(envs, device=stats.device)].double().cpu()))
    return out, sum(int((~torch.isfinite(st)).sum()) for _, st in calls)
