"""Closed-loop stepping of the vector env, as stable-baselines3's collect
loop drives a ``gymnasium.vector`` env: each unit hands the 64x64 actor's
deterministic mean, computed on the card from the last numpy observation,
to ``compat/vector_env.py::VectorSmartNanogridEnv.step`` and holds the numpy
observation, rewards and dones it returns; at each day end the env resets
every env with fresh days (its autoreset).  A step's latency is the time of
``step`` alone.

The env's draws come from its own generator, seeded by the run's seed.  The
check samples ``check_envs`` envs from the run's seed, keeps their actions
and what the env returned from the first reset on, and the plain reference
replays the same generator's draws (the engine's documented order: a day's
uniforms, its PV shift, one PV-shift draw a step) and every day of those
envs with those actions, BESS carried, and compares each reward and
observation and each done.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from nanobench import common
from nanobench import work as counts
from nanobench.reference import day as ref_day
from nanobench.reference.tables import grid_tables

END_TO_END = "step_ms_p99"


def reference_kwargs(grid: dict) -> dict:
    """The upstream constructor's arguments for ``grid``."""
    return dict(price_model=int(grid["price_model"]), number_of_chargers=int(grid["chargers"]),
                pv_system_available_in_model=bool(grid["pv"]),
                battery_system_available_in_model=bool(grid["battery"]),
                vehicle_to_everything=bool(grid["v2x"]),
                enable_different_vehicle_battery_capacities=bool(grid["different_capacities"]),
                enable_requested_state_of_charge=bool(grid["requested_soc"]),
                time_interval=f"{float(grid['time_interval_h']):g}h", charging_mode=grid["charging_mode"],
                vehicle_uncharged_penalty_mode=grid["penalty_mode"])


def setup(ctx):
    from smart_nanogrid_gym_torch.compat.vector_env import VectorSmartNanogridEnv
    from smart_nanogrid_gym_torch.solvers.networks import actor_critic_from_leaves, make_actor_policy_fn

    grid, t = ctx.config["grid"], ctx.traffic
    _, _, F, A = counts.day_dims(grid)
    hidden = tuple(ctx.config["network"]["hidden"])
    wseed, env_seed = common.seeds(ctx.seed, 2, salt=5)
    leaves = common.actor_critic(F, A, hidden, wseed, ctx.device, float(ctx.config["network"]["eval_pi_out_gain"]))
    B = int(t["num_envs"])
    env = VectorSmartNanogridEnv(num_envs=B, seed=env_seed, device=ctx.device, **reference_kwargs(grid))
    rng = np.random.default_rng([ctx.seed % 2 ** 64, 6])
    s = SimpleNamespace(ctx=ctx, env=env, policy=make_actor_policy_fn(env.config, actor_critic_from_leaves(leaves)),
                        pi=[x.detach().clone() for x in leaves[:6]], hidden=hidden, batch=B, env_seed=env_seed,
                        envs=np.sort(rng.choice(B, size=min(int(t["check_envs"]), B), replace=False)),
                        latency=[], resets=[], actions=[], obs=[], rewards=[], dones=[], T=env.config.steps_per_day)
    reset = env.reset

    def timed_reset(*args, **kwargs):
        t0 = time.perf_counter()
        out = reset(*args, **kwargs)
        s.resets.append((t0, time.perf_counter() - t0))
        return out

    env.reset = timed_reset
    s.last_obs, _ = env.reset()
    s.obs.append(s.last_obs[s.envs].copy())
    for _ in range(s.T):   # one whole day with its autoreset: every shape of the loop warmed
        unit(s)
    s.latency.clear()
    s.resets.clear()
    return s


def unit(s) -> int:
    with torch.no_grad():
        act = s.policy(torch.as_tensor(s.last_obs, device=s.ctx.device)).cpu().numpy()
    t0 = time.perf_counter()
    obs, rewards, dones, _, _ = s.env.step(act)
    s.latency.append(time.perf_counter() - t0)
    s.last_obs = obs
    k = s.envs
    s.actions.append(act[k].copy())
    s.obs.append(obs[k].copy())
    s.rewards.append(rewards[k].copy())
    s.dones.append(dones[k].copy())
    return s.batch


def work(s) -> dict:
    _, _, F, A = counts.day_dims(s.ctx.config["grid"])
    return {"actor_flops_per_step": counts.mlp_flops(F, A, *s.hidden) * s.batch, "resets": list(s.resets)}


def end_to_end(units, s) -> dict:
    """The 99th percentile of the window's step latencies (the day-end
    steps with their autoreset among them), in ms."""
    return {END_TO_END: float(np.percentile(np.array(s.latency) * 1e3, 99))}


def finish(s):
    low, high = s.env.config.action_bounds()
    days = len(s.actions) // s.T + 1   # the last day whose first observation the env returned
    return {"env_seed": s.env_seed, "batch": s.batch, "envs": s.envs, "days": days, "pi": s.pi,
            "low": torch.as_tensor(low), "high": torch.as_tensor(high),
            "actions": np.stack(s.actions), "obs": np.stack(s.obs), "rewards": np.stack(s.rewards),
            "dones": np.stack(s.dones)}


def reference_days(config: dict, outputs: dict, root, device, dtype=torch.float32):
    """The sampled envs' rewards ``(steps, S)``, the observations the env
    returns ``(steps + 1, S, F)`` (the first reset's first) and the dones,
    replayed from the env's seed with the recorded actions."""
    grid = config["grid"]
    T, N, _, _ = counts.day_dims(grid)
    tab = grid_tables(grid, root, device, dtype)
    B, envs = outputs["batch"], torch.as_tensor(outputs["envs"], device=device)
    gen = torch.Generator(device=device).manual_seed(outputs["env_seed"])
    actions = torch.as_tensor(outputs["actions"], device=device)
    steps = actions.shape[0]
    batt = torch.full((envs.numel(),), ref_day.BATT_INIT, dtype=dtype, device=device)
    obs, rewards = [], []
    for d in range(outputs["days"]):
        u = torch.rand((B, T, 5, N), generator=gen, dtype=torch.float32, device=device)
        shift = torch.randint(0, 181, (B,), generator=gen, device=device).to(torch.float32) / 100.0
        for _ in range(T):
            torch.randint(0, 181, (B,), generator=gen, device=device)
        u = u[envs].permute(1, 2, 0, 3).to(dtype)

        def controller(view, d=d):
            t = len(obs) - d * T
            obs.append(view.obs)
            at = min(d * T + t, steps - 1)
            return actions[at].to(dtype)

        day = ref_day.run_day(grid, tab, u, shift[envs].to(dtype), batt, controller)
        batt = day.batt
        rewards.append(day.rewards)
    rewards = torch.cat(rewards)[:steps]
    obs = torch.stack(obs)[:steps + 1]
    dones = (torch.arange(1, steps + 1, device=device) % T == 0)[:, None].expand(steps, envs.numel())
    return rewards, obs, dones


def mismatches(got, want, tol: float) -> float:
    """The share of entries of ``got`` off ``want`` by more than ``tol``
    times the larger of 1 and ``|want|``."""
    off = (got - want).abs() > tol * want.abs().clamp_min(1.0)
    return float(torch.nan_to_num(off.double(), nan=1.0).mean())


def compare(outputs: dict, want, traffic: dict) -> dict:
    rewards, obs, dones = want
    dev = rewards.device
    steps = outputs["rewards"].shape[0]
    # the observation the env returns at a day's end is the next day's first;
    # obs[k] is the one returned after step k-1 (obs[0]: the first reset's)
    got_obs = torch.as_tensor(outputs["obs"], device=dev).to(obs.dtype)
    tol = float(traffic["check_tolerance"])
    return {"reward_mismatch": mismatches(torch.as_tensor(outputs["rewards"], device=dev).to(rewards.dtype),
                                          rewards, tol),
            "obs_mismatch": mismatches(got_obs[:steps + 1], obs.to(got_obs.dtype), tol),
            "done_mismatch": float((torch.as_tensor(outputs["dones"], device=dev) != dones).sum())}


def check(config: dict, traffic: dict, seed: int, outputs: dict, root, device, dtype=torch.float32) -> dict:
    with torch.no_grad():
        numbers = compare(outputs, reference_days(config, outputs, root, device, dtype), traffic)
    lim = traffic["limits"]
    return {k: (v, lim[k]) for k, v in numbers.items()}


def control(config: dict, traffic: dict, seed: int, outputs: dict, root, device, dtype) -> dict:
    """The reference in ``dtype`` in the program's place."""
    with torch.no_grad():
        lowered = reference_days(config, outputs, root, device, dtype)
    fake = {**outputs, "rewards": lowered[0].float().cpu().numpy(), "obs": lowered[1].float().cpu().numpy(),
            "dones": lowered[2].cpu().numpy()}
    return check(config, traffic, seed, fake, root, device)
