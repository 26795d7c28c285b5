"""Closed-loop RBC evaluation: each unit is one call of
``ops/gen_rollout.py::gen_rbc_multiday`` (K8) scoring ``days`` fresh days
of ``batch`` envs on a new seed, synchronised, as a caller reading the
stats would wait for them.

The check draws ``check_calls`` of the window's calls and ``check_envs``
envs of each from the run's seed and works their sums of day returns and
of squared day returns out again with the plain reference, every day of
each (the days are independent: the BESS idles under the RBC).
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from nanobench import common
from nanobench import work as counts
from nanobench.reference import day as ref_day
from nanobench.reference import philox
from nanobench.reference.tables import grid_tables

END_TO_END = "eval_env_steps_per_s"


def setup(ctx):
    from smart_nanogrid_gym_torch.core.params import make_params
    from smart_nanogrid_gym_torch.ops import gen_rollout

    cfg = common.program_config(ctx.config["grid"])
    params = make_params(cfg, torch.float32, ctx.device)
    s = SimpleNamespace(ctx=ctx, cfg=cfg, params=params, fn=gen_rollout.gen_rbc_multiday,
                        batch=int(ctx.traffic["batch"]), days=int(ctx.traffic["days"]),
                        call_seeds=iter(common.seeds(ctx.seed, 1 << 20, salt=1)), calls=[])
    s.fn(cfg, params, 1, 0, s.batch)   # loads the library; the shapes are the launch's arguments
    common.sync(ctx.device)
    return s


def unit(s) -> int:
    seed = next(s.call_seeds)
    stats = s.fn(s.cfg, s.params, s.days, seed, s.batch)
    common.sync(s.ctx.device)
    s.calls.append((seed, stats))
    return s.batch * s.days * s.cfg.steps_per_day


def work(s) -> dict:
    return {"rbc_days": counts.rbc_days(s.ctx.config["grid"], s.batch, s.days)}


def finish(s):
    """The program's answers to check: the sampled calls' stats for the
    sampled envs, and how many stats of the window were not finite."""
    calls, nonfinite = common.sample_calls(s.ctx.seed, s.calls, s.batch, s.ctx.traffic)
    return {"calls": calls, "nonfinite": nonfinite, "days": s.days}


def reference_sums(config: dict, traffic: dict, seed: int, envs, days: int, root, device, dtype=torch.float32):
    """Σ day return and Σ day return² of ``envs`` over ``days`` days of the
    call seeded ``seed``, by the plain reference in ``dtype``."""
    grid = config["grid"]
    T, N, _, _ = counts.day_dims(grid)
    tab = grid_tables(grid, root, device, dtype)
    ctrl = ref_day.rbc(grid, tab, dtype)
    env_all = torch.as_tensor(envs, dtype=torch.int64, device=device)
    total = torch.zeros((2, len(envs)), dtype=torch.float64, device=device)
    chunk = max(1, int(traffic.get("check_lanes", 1 << 16)) // len(envs))
    for d0 in range(0, days, chunk):
        d = torch.arange(d0, min(days, d0 + chunk), dtype=torch.int64, device=device)
        day = d.repeat_interleave(len(envs))
        env = env_all.repeat(d.numel())
        u, u_pv = philox.day_draws(seed, day, env, T, N)
        batt = torch.full((day.numel(),), ref_day.BATT_INIT, dtype=dtype, device=device)
        ret = ref_day.run_day(grid, tab, u.to(dtype), ref_day.pv_shift(u_pv.to(dtype)), batt, ctrl).day_return
        ret = ret.view(d.numel(), len(envs))
        total[0] += ret.sum(0)
        total[1] += (ret * ret).sum(0)
    return total.cpu()


def compare(got, want) -> float:
    """The widest relative gap of a sum."""
    gap = (got - want).abs() / want.abs().clamp_min(1e-30)
    return float(torch.nan_to_num(gap, nan=float("inf")).max())


def check(config: dict, traffic: dict, seed: int, outputs: dict, root, device) -> dict:
    gap = 0.0
    for call_seed, envs, got in outputs["calls"]:
        want = reference_sums(config, traffic, call_seed, envs, outputs["days"], root, device)
        gap = max(gap, compare(got, want))
    lim = traffic["limits"]
    return {"stats_gap": (gap, lim["stats_gap"]), "nonfinite": (float(outputs["nonfinite"]), lim["nonfinite"])}


def control(config: dict, traffic: dict, seed: int, outputs: dict, root, device, dtype) -> dict:
    """The check with the reference in ``dtype`` put in the program's place."""
    lowered = {**outputs, "calls": [(cs, envs, reference_sums(config, traffic, cs, envs, outputs["days"], root,
                                                               device, dtype)) for cs, envs, _ in outputs["calls"]]}
    return check(config, traffic, seed, lowered, root, device)
